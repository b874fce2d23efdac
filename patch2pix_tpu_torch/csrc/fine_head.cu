// B5: the fused fine-stage regressor head, superblock rows -> pooled
// (M, F) features.
//
// Replaces patch2pix_tpu/ops/fine_stage_pallas.py fused_fine_head_pallas
// (_head_kernel). Per proposal m (psize 16, conv0 output 8 x 8):
//
//   for each conv0 segment s (a C = 64 level with both sides' channels
//   paired, or one side of a wider level), patch pixel (py, px):
//     X0_s[py, px, ch] = round(f32(e_side[py, px, ch]) * inv_od_side[py, px])
//   where e is the window expansion of the level's superblock rows (as in
//   B3/B7) and inv_od the prolog's inverse norm rounded to the output type;
//   acc0 = partial0[m] + sum_s conv3x3/2(X0_s, w0_s)              (f32)
//   X1   = round(acc0 * bn0s + bn0t)
//   y    = round(conv3x3/1(X1, wc1) * bn1s + bn1t)                (f32 sums)
//   out[m, :] = max over the 64 positions of max(y, 0)
//
// rounding to T, the rows' and the output's type (float32 or bfloat16).
// The Pallas kernel's one-hot selection matmuls and channel-pairing
// masks are TPU formulations and are gone: the expansion is indexed reads.
//
// Bound on the H100: operations. Both convs are implicit GEMMs of
// (64 M rows) x (9 C' or 9 F) @ (9 C' or 9 F) x F: at F = 512 and
// C' = 512, 2 x 64 x 512 x 4608 x 2 = 0.60 GFLOP per proposal, 1.45
// TFLOP for M = 2400, 1.47 ms at the bf16 tensor peak.
//
// bf16: two launches of one warp-specialised wgmma kernel, conv0 (+BN0)
// writing X1 to device memory, then conv1 (+BN1, ReLU, max). Keeping X1
// on the chip would need all F = 512 columns of two proposals' products
// in one block (256 KB of f32 accumulators); its round trip through
// device memory is 2 x 157 MB at M = 2400, about 0.1 ms at the HBM
// rate, while sharing each weight tile between proposals saves tens of
// GB of L2 traffic (22.6 GB at one proposal a block). A block
// is 128 GEMM rows — two proposals, one per consumer warpgroup — by 256
// output channels; its weight tiles (64 K x 256 N, 32 KB) come by TMA
// through a 3-stage mbarrier ring that one producer thread keeps full, and
// each weight byte that leaves L2 feeds both proposals. K runs over
// (64-channel chunk, tap) blocks. Each consumer warpgroup stages its
// proposal's whole conv input in shared memory once, by 16-byte
// cp.async: for conv0 the window cells of every chunk (one side of one
// level, 64 channels), neither expanded nor scaled, with both sides'
// inverse norms; for conv1 X1's 8 x 8 pixels. ldmatrix builds the A
// fragments straight from those rows, one row address per lane — the
// expansion and the im2col gather cost no copy, and taps in the zero
// padding read a 128-byte zero row — and conv0 scales the fragments in
// registers. Products run as wgmma m64n256k16 with A from registers and
// B from the swizzled ring, f32 accumulators in registers; conv0 adds
// partial0 into them under its first chunk's products, whose loads it
// would otherwise wait for.
//
// f32: SIMT fmaf, never TF32, one block per proposal, F threads (one
// output channel each); the conv input of the current segment (16 x 16
// x C') or X1 (8 x 8 x F) sits in shared memory and the K loop walks
// (tap, channel chunk) through two buffers: while the threads multiply
// one chunk, the block gathers the next chunk's 64 x KC im2col rows
// k-major and copies its KC x F weight rows with cp.async.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int PS = 16;  // patch side
constexpr int OH = 8;   // conv output side
constexpr int NPIX = PS * PS;
constexpr int NPOS = OH * OH;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// 16 bytes through L1: neighbouring pixels of a coarse level share a cell
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Offset of pixel (p, q)'s channel 0 inside proposal m's level rows (B3's
// window indexing); y0, x0 >= 0.
__device__ __forceinline__ int64_t pixel_offset(int m, int p, int q, int y0, int x0, int t,
                                                int c) {
  const int ds = PS / t;
  const int iy = (y0 + p) / ds - (y0 / PS) * t;
  const int ix = (x0 + q) / ds - (x0 / PS) * t;
  const int tile = (iy / t) * 2 + ix / t;
  return ((((int64_t)m * 4 + tile) * t + iy % t) * t + ix % t) * c;
}

// ------------------------------------------------------------------ bf16

constexpr int KB = 64;          // K block: one tap of one 64-channel chunk
constexpr int BN = 256;         // output channels per block (the wgmma N)
constexpr int STAGES = 3;       // weight ring depth
constexpr int THREADS = 384;    // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int MAX_CHUNKS = 16;  // conv0 input channels up to 1024
constexpr uint32_t B_STAGE_BYTES = BN * KB * 2;  // 32 KB
constexpr uint32_t A_WG_BYTES = 64 * 1024;       // per consumer warpgroup
constexpr uint32_t ROW_BYTES = KB * 2;           // one cell or pixel of a chunk
constexpr uint32_t X1_BYTES = NPOS * ROW_BYTES;  // one conv1 chunk, 8 KB
constexpr uint32_t INV_BYTES = 2 * NPIX * 4;     // both sides' inverse norms
// 1 KB of slack aligns the ring to the swizzle's 1024 bytes; the zero
// row follows the A tiles
constexpr size_t SMEM_BYTES = 1024 + STAGES * B_STAGE_BYTES + 2 * A_WG_BYTES + ROW_BYTES;

struct Chunk {
  const bf16* rows;  // the level's (M, 4, t, t*c) rows of this chunk's side
  int log_t, c;      // log2 of the level's tile side; its channels
  int coff;          // the chunk's first channel within the level
  int side;          // 0 or 1
  int smem;          // offset of its window in the warpgroup's A tile
};

struct HeadArgs {
  Chunk chunk[MAX_CHUNKS];  // conv0's K chunks in weight order
  int n_chunks;
  const int* y[2];
  const int* x[2];
  const float* inv[2];    // (M, 16, 16) f32
  const float* partial0;  // (M, 8, 8, F) f32
  const float* bn_s;      // this conv's BatchNorm affine, (F,) f32
  const float* bn_t;
  bf16* x1;   // (M, 64, fp): conv0's output, conv1's input
  bf16* out;  // (M, F)
  int m, f, fp;
};

__device__ __forceinline__ void bar_sync_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t v, __nv_bfloat162 s) {
  __nv_bfloat162 h = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&v), s);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += A (64 x 16, registers) * B (256 x 16, K-major, swizzled smem)^T
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Where a proposal's patch sits in a level's superblock: the window of
// cells its 16 x 16 pixels cover (B3's indexing, corner >= 0) starts at
// cell (y0 % 16) / ds; pixel p of the patch lies in window cell
// (y0 % 16 + p) / ds - that, for ds = 16 / t.
struct Window {
  int by, bx;    // the corner within its 16-pixel tile
  int wy, wx;    // the window's first cell in the superblock
  int log_ds;
};

__device__ __forceinline__ Window window_of(int y0, int x0, int log_t) {
  Window w;
  w.log_ds = 4 - log_t;
  w.by = y0 % PS;
  w.bx = x0 % PS;
  w.wy = w.by >> w.log_ds;
  w.wx = w.bx >> w.log_ds;
  return w;
}

// conv0 (CONV1 false): X1[m] = round(BN0(partial0[m] + conv3x3/2 of the
// scaled expansion)); conv1: out[m] = max_pos relu(round(BN1(conv3x3/1
// X1))). Block b covers proposals 2 (b / n_tiles) + {0, 1} (one per
// consumer warpgroup) and output channels 256 (b % n_tiles) + [0, 256).
// wmap: the weights (F, 9 C'), K ordered (chunk, tap, channel).
//
// A tiles: conv0 keeps, per chunk, the (t+1) x (t+1) window cells of its
// level and side unexpanded and unscaled (31.7 KB for the fine stage's
// levels), both sides' inverse norms beside them; an ldmatrix lane
// points at the cell under its pixel, and each thread scales its A
// fragments' two rows in registers (bf16 products rounded once, as
// round(e * inv) is). conv1 keeps X1[m], 8 x 8 pixels x F. Cells and
// pixels are 128-byte rows whose 16-byte units are XOR-swizzled by the
// column, so the eight rows of one ldmatrix phase (eight neighbouring
// cells or pixels of one row, or repeats of one) fall in eight banks.
template <bool CONV1>
__global__ void __launch_bounds__(THREADS, 1)
fine_head_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ HeadArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_tiles = ring + STAGES * B_STAGE_BYTES;
  uint8_t* zero = a_tiles + 2 * A_WG_BYTES;

  const int n_tiles = (a.f + BN - 1) / BN;
  const int pair = blockIdx.x / n_tiles, nt = blockIdx.x % n_tiles;
  const int n_chunks = CONV1 ? a.fp / KB : a.n_chunks;
  const int nkb = 9 * n_chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < ROW_BYTES / 4) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0;
  __syncthreads();

  if (warp >= 8) {
    // producer: one thread keeps the weight ring full; the warpgroup
    // hands its registers to the consumers (accumulators, A fragments)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      uint32_t phase = 0;
      int stage = 0;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], B_STAGE_BYTES);
        tma_load_2d(ring + stage * B_STAGE_BYTES, &wmap, &full[stage], kb * KB, nt * BN);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns proposal m_raw's 64 rows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4, wq = warp % 4, tid = threadIdx.x % 128;
  const int m_raw = 2 * pair + wg;
  const int m = min(m_raw, a.m - 1);  // a missing second proposal repeats the last
  uint8_t* tile = a_tiles + wg * A_WG_BYTES;
  const float* inv_s = reinterpret_cast<const float*>(tile + A_WG_BYTES - INV_BYTES);
  const uint32_t tile_u32 = smem_u32(tile), zero_u32 = smem_u32(zero);
  const uint32_t ring_u32 = smem_u32(ring);
  // this lane's ldmatrix row (lanes 0-15 at k 0-7, 16-31 at k 8-15) and
  // its fragments' rows (lane / 4 and 8 more: one column, two rows apart)
  const int pos = 16 * wq + (lane & 15), oy = pos / OH, ox = pos % OH, khalf = lane >> 4;
  const int frag_oy = 2 * wq, frag_ox = lane >> 2;
  const int n_base = nt * BN + 2 * (lane & 3);  // this thread's first column

  // d[4 i + 2 h + c] is row 16 wq + (lane >> 2) + 8 h and column
  // n_base + 8 i + c of the warpgroup's 64 x 256 product
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  // conv0 adds partial0 during its first chunk, 16 values a tap, each
  // loaded a tap before it is added so the loads run under the products
  float p0[16];
  auto load_p0 = [&](int part) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 4 * part + e / 2, h = e % 2, n = n_base + 8 * i;
      float2 v = make_float2(0.0f, 0.0f);
      if (n < a.f)
        v = *reinterpret_cast<const float2*>(
            a.partial0 + ((int64_t)m * NPOS + 16 * wq + (lane >> 2) + 8 * h) * a.f + n);
      p0[2 * e] = v.x;
      p0[2 * e + 1] = v.y;
    }
  };

  if (CONV1) {
    // X1[m]: chunk 0 as one cp.async group, so its taps start early, the
    // rest as a second; 16-byte units in device-memory order
    const bf16* src = a.x1 + (int64_t)m * NPOS * a.fp;
    for (int g = 0; g < 2; ++g) {
      const int q0 = g == 0 ? 0 : 1, per = g == 0 ? 8 : 8 * (n_chunks - 1);
      for (int e = tid; e < NPOS * per; e += 128) {
        const int p = e / per, r = 8 * q0 + e % per, q = r / 8, j = r % 8;
        cp_async16(tile + q * X1_BYTES + p * ROW_BYTES + ((j ^ (p % OH)) << 4),
                   src + (int64_t)p * a.fp + 8 * r);
      }
      cp_async_commit();
    }
    cp_async_wait<1>();
  } else {
    // every chunk's window cells (L1-cached: a neighbouring proposal of
    // the same image may share them): chunk 0 with both inverse-norm rows
    // as one cp.async group, the rest as a second
    for (int q = 0; q < n_chunks; ++q) {
      const Chunk& ch = a.chunk[q];
      const int t = 1 << ch.log_t, side = t + 1;
      const Window w = window_of(max(a.y[ch.side][m], 0), max(a.x[ch.side][m], 0), ch.log_t);
      for (int e = tid; e < side * side * 8; e += 128) {
        const int cell = e / 8, j = e % 8, cy = cell / side, cx = cell % side;
        const int sy = w.wy + cy, sx = w.wx + cx;  // superblock cell
        const int64_t off =
            ((((int64_t)m * 4 + (sy >> ch.log_t) * 2 + (sx >> ch.log_t)) * t + (sy & (t - 1))) *
                 t + (sx & (t - 1))) * ch.c + ch.coff + 8 * j;
        cp_async16_ca(tile + ch.smem + cell * ROW_BYTES + ((j ^ (cx & 7)) << 4), ch.rows + off);
      }
      if (q == 0) {
        for (int e = tid; e < INV_BYTES / 16; e += 128) {
          const int side = e / (NPIX / 4), u = e % (NPIX / 4);
          cp_async16(tile + A_WG_BYTES - INV_BYTES + e * 16,
                     a.inv[side] + (int64_t)m * NPIX + 4 * u);
        }
        cp_async_commit();
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
  }
  bar_sync_wg(wg);

  uint32_t phase = 0;
  int stage = 0;
  for (int q = 0; q < n_chunks; ++q) {
    if (q == 1) {  // the second cp.async group: the other chunks
      cp_async_wait<0>();
      bar_sync_wg(wg);
    }
    Window w{};
    uint32_t base;
    int wside = 0, inv_side = 0;
    if (CONV1) {
      base = tile_u32 + q * X1_BYTES;
    } else {
      const Chunk& ch = a.chunk[q];
      w = window_of(max(a.y[ch.side][m], 0), max(a.x[ch.side][m], 0), ch.log_t);
      base = tile_u32 + ch.smem;
      wside = (1 << ch.log_t) + 1;
      inv_side = ch.side * NPIX;
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // the lane's ldmatrix row address, or the zero row in the padding
      uint32_t row = zero_u32;
      int swz = 0;
      if (CONV1) {
        const int iy = oy + dy - 1, ix = ox + dx - 1;
        if (iy >= 0 && iy < OH && ix >= 0 && ix < OH) {
          row = base + (iy * OH + ix) * ROW_BYTES;
          swz = ix;
        }
      } else {
        const int py = 2 * oy + dy - 1, px = 2 * ox + dx - 1;
        if (py >= 0 && px >= 0) {
          const int cy = ((w.by + py) >> w.log_ds) - w.wy, cx = ((w.bx + px) >> w.log_ds) - w.wx;
          row = base + (cy * wside + cx) * ROW_BYTES;
          swz = cx & 7;
        }
      }
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(af[kk], row == zero_u32 ? row : row + (((2 * kk + khalf) ^ swz) << 4));
      if (!CONV1) {
        // scale the fragments' rows by their pixels' inverse norms (any
        // finite value in the padding, whose cells read zero)
        const int py = 2 * frag_oy + dy - 1, px = max(2 * frag_ox + dx - 1, 0);
        const __nv_bfloat162 sa = __float2bfloat162_rn(inv_s[inv_side + max(py, 0) * PS + px]);
        const __nv_bfloat162 sb = __float2bfloat162_rn(inv_s[inv_side + (py + 2) * PS + px]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          af[kk][0] = bf16x2_mul(af[kk][0], sa);
          af[kk][1] = bf16x2_mul(af[kk][1], sb);
          af[kk][2] = bf16x2_mul(af[kk][2], sa);
          af[kk][3] = bf16x2_mul(af[kk][3], sb);
        }
      }
      mbar_wait(&full[stage], phase);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16_rs(d, af[kk], sw128_desc(ring_u32 + stage * B_STAGE_BYTES + kk * 32));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(d);
      if (!CONV1 && q == 0) {
        if (tap > 0) {
#pragma unroll
          for (int e = 0; e < 16; ++e) d[16 * (tap - 1) + e] += p0[e];
        }
        if (tap < 8) load_p0(tap);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  if constexpr (!CONV1) {
    // BN0, rounded, into X1 (zeros in the channels past F)
    if (m_raw >= a.m) return;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = n_base + 8 * i;
      if (n >= a.fp) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * wq + (lane >> 2) + 8 * h;
        __nv_bfloat162 v = __floats2bfloat162_rn(0.0f, 0.0f);
        if (n < a.f)
          v = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(d[4 * i + 2 * h], a.bn_s[n]), a.bn_t[n]),
                                    __fadd_rn(__fmul_rn(d[4 * i + 2 * h + 1], a.bn_s[n + 1]),
                                              a.bn_t[n + 1]));
        *reinterpret_cast<__nv_bfloat162*>(a.x1 + ((int64_t)m * NPOS + p) * a.fp + n) = v;
      }
    }
  } else {
    // conv1: BN1, round, ReLU, then the max over the 64 positions: over a
    // thread's two rows, the warp's eight row groups (lanes ^ 4, 8, 16),
    // then the four warps through shared memory (the A tile is free).
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = min(n_base + 8 * i, a.f - 2);  // columns past F are dropped below
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float s = a.bn_s[n + c], t = a.bn_t[n + c];
        float best = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y = __fadd_rn(__fmul_rn(d[4 * i + 2 * h + c], s), t);
          best = fmaxf(best, __bfloat162float(__float2bfloat16_rn(y)));
        }
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 4));
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 8));
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 16));
        d[4 * i + c] = best;
      }
    }
    float* red = reinterpret_cast<float*>(tile);  // [4 warps][256 columns]
    bar_sync_wg(wg);  // every warp is done with the tile
    if (lane < 4) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        red[wq * BN + 8 * i + 2 * lane] = d[4 * i];
        red[wq * BN + 8 * i + 2 * lane + 1] = d[4 * i + 1];
      }
    }
    bar_sync_wg(wg);
    const int n = nt * BN + 2 * tid;
    if (m_raw < a.m && n < a.f) {
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        v[c] = fmaxf(fmaxf(red[2 * tid + c], red[BN + 2 * tid + c]),
                     fmaxf(red[2 * BN + 2 * tid + c], red[3 * BN + 2 * tid + c]));
      *reinterpret_cast<__nv_bfloat162*>(a.out + (int64_t)m * a.f + n) =
          __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

// ------------------------------------------------------------------ f32

constexpr int MAX_SEG = 8;

struct Seg {
  const void* rows[2];  // per side: the level's (M, 4, t, t*c) rows
  const void* w;        // (9, cseg, F) conv0 weights of this segment
  int t, c;             // the level's tile side and channels
  int kind;             // 0: both sides paired, 1: side 1 only, 2: side 2 only
  int cseg;             // the segment's channels: 2c if paired, else c
};

struct Args {
  Seg seg[MAX_SEG];
  int n_seg;
  const int* y[2];
  const int* x[2];
  const float* inv[2];    // (M, 16, 16) f32
  const float* partial0;  // (M, 8, 8, F) f32
  const void* wc1;        // (9, F, F)
  const float* bn0s;
  const float* bn0t;
  const float* bn1s;
  const float* bn1t;
  void* out;  // (M, F)
  int f;
  int x_elems;  // elements of the shared conv-input tile
};

// Stage segment s's scaled expansion: X[pix * cseg + ch].
__device__ __forceinline__ void stage_segment(const Seg& s, float* X, const float* inv_s, int m,
                                              const int* ys, const int* xs) {
  for (int e = threadIdx.x; e < NPIX * s.cseg; e += blockDim.x) {
    const int pix = e / s.cseg, ch = e % s.cseg;
    const int side = s.kind == 0 ? ch / s.c : s.kind - 1;
    const int k = s.kind == 0 ? ch % s.c : ch;
    const float* rows = (const float*)s.rows[side];
    const float v = rows[pixel_offset(m, pix / PS, pix % PS, ys[side], xs[side], s.t, s.c) + k];
    X[e] = __fmul_rn(v, inv_s[side * NPIX + pix]);
  }
}

// The input pixel of conv output position pos at tap (dy, dx), or -1 in
// the zero padding: stride 2 over the 16 x 16 patch, or 1 over 8 x 8.
__device__ __forceinline__ int tap_pixel(int pos, int dy, int dx, int stride, int side) {
  const int py = stride * (pos / OH) - 1 + dy, px = stride * (pos % OH) - 1 + dx;
  return (py >= 0 && py < side && px >= 0 && px < side) ? py * side + px : -1;
}

// Stage K chunk c = (tap, channels [kc, kc + KC)) of one conv into one
// buffer: the 64 im2col rows from the shared tile X (side x side x cin,
// zero outside it) k-major into As[k * lda + pos], and the weight rows
// W[tap][kc + k][0:f] into Bs[k * ldb + n] with 16-byte cp.async copies
// (committed as one group).
template <int KC>
__device__ __forceinline__ void stage_chunk(int c, int cin, int stride, int side, const float* X,
                                            const float* W, int f, int lda, int ldb, float* As,
                                            float* Bs) {
  const int nk = cin / KC;
  const int tap = c / nk, kc = (c % nk) * KC;
  const int dy = tap / 3, dx = tap % 3;
  constexpr int VEC = 16 / sizeof(float);  // elements per 16-byte copy
  for (int e = threadIdx.x; e < NPOS * KC; e += blockDim.x) {
    const int pos = e / KC, k = e % KC;
    const int pix = tap_pixel(pos, dy, dx, stride, side);
    As[k * lda + pos] = pix >= 0 ? X[pix * cin + kc + k] : 0.0f;
  }
  // blockDim.x == f: each pass copies blockDim.x / per_row = VEC rows
  const int per_row = f / VEC;
  const int n = (threadIdx.x % per_row) * VEC;
  const float* wsrc = W + ((int64_t)tap * cin + kc) * f;
  for (int k = threadIdx.x / per_row; k < KC; k += VEC)
    cp_async16(&Bs[k * ldb + n], &wsrc[(int64_t)k * f + n]);
  cp_async_commit();
}

// One conv over X (side x side x cin) against W (9, cin, F), in K chunks
// through S buffers: chunk c + S - 1 is staged (its weights by cp.async)
// while the warps multiply chunk c with mma(A, B); one barrier per chunk.
template <int KC, int S, typename Mma>
__device__ __forceinline__ void conv_pipeline(const float* X, int cin, int stride, int side,
                                              const float* W, int f, int lda, int ldb,
                                              float* As, float* Bs, Mma mma) {
  const int nchunks = 9 * (cin / KC);
  const int a_size = KC * lda, b_size = KC * ldb;
  for (int c = 0; c < S - 1; ++c) {
    if (c < nchunks)
      stage_chunk<KC>(c, cin, stride, side, X, W, f, lda, ldb, As + c * a_size,
                      Bs + c * b_size);
    else
      cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S - 2>();  // chunk c's copies have landed (this thread's)
    __syncthreads();         // ... everyone's; and chunk c - 1's buffers are free
    const int next = c + S - 1;
    if (next < nchunks)
      stage_chunk<KC>(next, cin, stride, side, X, W, f, lda, ldb, As + (next % S) * a_size,
                      Bs + (next % S) * b_size);
    else
      cp_async_commit();  // an empty group keeps the count in step
    mma(As + (c % S) * a_size, Bs + (c % S) * b_size);
  }
  cp_async_wait<0>();
  __syncthreads();  // the buffers and X are free for the caller
}

constexpr int KCF = 16;         // K chunk (f32)
constexpr int LDAF = NPOS + 4;  // k-major im2col stride: 16-byte rows, 2-way writes

constexpr int STAGES_F = 2;     // K-chunk buffers (f32; three do not fit)

// One conv into acc[64] (this thread's output channel n). As holds the
// im2col chunk k-major, so a warp reads four positions as one broadcast
// float4.
__device__ __forceinline__ void conv_f32(float (&acc)[NPOS], const float* X, int cin,
                                         int stride, int side, const float* W, int f, float* As,
                                         float* Bs) {
  const int n = threadIdx.x;
  conv_pipeline<KCF, STAGES_F>(
      X, cin, stride, side, W, f, LDAF, f, As, Bs, [&](const float* A, const float* B) {
#pragma unroll 4
        for (int k = 0; k < KCF; ++k) {
          const float b = B[k * f + n];
          const float4* a4 = reinterpret_cast<const float4*>(A + k * LDAF);
#pragma unroll
          for (int p4 = 0; p4 < NPOS / 4; ++p4) {
            const float4 v = a4[p4];
            acc[4 * p4 + 0] = fmaf(v.x, b, acc[4 * p4 + 0]);
            acc[4 * p4 + 1] = fmaf(v.y, b, acc[4 * p4 + 1]);
            acc[4 * p4 + 2] = fmaf(v.z, b, acc[4 * p4 + 2]);
            acc[4 * p4 + 3] = fmaf(v.w, b, acc[4 * p4 + 3]);
          }
        }
      });
}

__global__ void __launch_bounds__(512) fine_head_f32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f = a.f, m = blockIdx.x, n = threadIdx.x;
  float* X = (float*)smem;
  size_t off = ((size_t)a.x_elems * sizeof(float) + 127) / 128 * 128;
  float* inv_s = (float*)(smem + off);
  off += 2 * NPIX * sizeof(float);
  float* As = (float*)(smem + off);
  off += STAGES_F * KCF * LDAF * sizeof(float);
  float* Bs = (float*)(smem + off);

  int ys[2], xs[2];
  for (int side = 0; side < 2; ++side) {
    ys[side] = max(a.y[side][m], 0);
    xs[side] = max(a.x[side][m], 0);
  }
  for (int e = threadIdx.x; e < 2 * NPIX; e += blockDim.x)
    inv_s[e] = a.inv[e / NPIX][(int64_t)m * NPIX + e % NPIX];

  float acc[NPOS];
#pragma unroll
  for (int pos = 0; pos < NPOS; ++pos) acc[pos] = a.partial0[((int64_t)m * NPOS + pos) * f + n];
  __syncthreads();

  for (int s = 0; s < a.n_seg; ++s) {
    stage_segment(a.seg[s], X, inv_s, m, ys, xs);
    __syncthreads();
    conv_f32(acc, X, a.seg[s].cseg, 2, PS, (const float*)a.seg[s].w, f, As, Bs);
  }

  const float s0 = a.bn0s[n], t0 = a.bn0t[n];
#pragma unroll
  for (int pos = 0; pos < NPOS; ++pos) {
    X[pos * f + n] = __fadd_rn(__fmul_rn(acc[pos], s0), t0);
    acc[pos] = 0.0f;
  }
  __syncthreads();

  conv_f32(acc, X, f, 1, OH, (const float*)a.wc1, f, As, Bs);

  const float s1 = a.bn1s[n], t1 = a.bn1t[n];
  float best = 0.0f;
#pragma unroll
  for (int pos = 0; pos < NPOS; ++pos)
    best = fmaxf(best, __fadd_rn(__fmul_rn(acc[pos], s1), t1));
  ((float*)a.out)[(int64_t)m * f + n] = best;
}

}  // namespace

// bfloat16. Per conv0 K chunk q < n_chunks (<= 16): chunk_rows[q] the
// level's (M, 4, t, t*c) rows of the chunk's side, chunk_log_t[q] =
// log2 t, chunk_c[q] = c (a multiple of 8), chunk_coff[q] the chunk's
// first channel, chunk_side[q] 0 or 1 — each chunk 64 channels. y1, x1,
// y2, x2: (M,) int32 padded corners; inv1, inv2: (M, 16, 16) f32;
// partial0: (M, 8, 8, F) f32; wt0: (F, 9 * 64 n_chunks) and wt1:
// (F, 9 fp) weights, K ordered (chunk, tap, channel), wt1's channels
// past F zero; bn*: (F,) f32; x1buf: (M, 64, fp) scratch; out: (M, F).
// F a multiple of 8, fp = F rounded up to 64, at most 512; the chunks'
// windows ((t+1)^2 cells of 128 bytes each) fit in 62 KB. Returns a
// cudaError_t.
extern "C" int p2p_fine_head_bf16(const void* const* chunk_rows, const int* chunk_log_t,
                                  const int* chunk_c, const int* chunk_coff,
                                  const int* chunk_side, int n_chunks, const void* y1,
                                  const void* x1, const void* y2, const void* x2,
                                  const void* inv1, const void* inv2, const void* partial0,
                                  const void* wt0, const void* wt1, const void* bn0s,
                                  const void* bn0t, const void* bn1s, const void* bn1t,
                                  void* x1buf, void* out, int m, int f, int fp, void* stream) {
  if (n_chunks <= 0 || n_chunks > MAX_CHUNKS || m <= 0 || f <= 0 || f % 8 != 0 ||
      fp != (f + KB - 1) / KB * KB || fp > 8 * KB)
    return (int)cudaErrorInvalidValue;
  HeadArgs a = {};
  int window_bytes = 0;  // conv0's staged windows, chunk after chunk
  for (int q = 0; q < n_chunks; ++q) {
    Chunk& ch = a.chunk[q];
    ch.rows = (const bf16*)chunk_rows[q];
    ch.log_t = chunk_log_t[q];
    ch.c = chunk_c[q];
    ch.coff = chunk_coff[q];
    ch.side = chunk_side[q];
    if (ch.log_t < 0 || ch.log_t > 4 || ch.c % 8 != 0 || ch.coff < 0 || ch.coff + KB > ch.c ||
        ch.side < 0 || ch.side > 1)
      return (int)cudaErrorInvalidValue;
    ch.smem = window_bytes;
    window_bytes += ((1 << ch.log_t) + 1) * ((1 << ch.log_t) + 1) * ROW_BYTES;
  }
  if (window_bytes > (int)(A_WG_BYTES - INV_BYTES)) return (int)cudaErrorInvalidValue;
  a.n_chunks = n_chunks;
  a.y[0] = (const int*)y1;
  a.x[0] = (const int*)x1;
  a.y[1] = (const int*)y2;
  a.x[1] = (const int*)x2;
  a.inv[0] = (const float*)inv1;
  a.inv[1] = (const float*)inv2;
  a.partial0 = (const float*)partial0;
  a.x1 = (bf16*)x1buf;
  a.out = (bf16*)out;
  a.m = m;
  a.f = f;
  a.fp = fp;

  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t rc = cudaFuncSetAttribute(fine_head_bf16_kernel<false>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)SMEM_BYTES);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(fine_head_bf16_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (rc != cudaSuccess) return (int)rc;
    attr_set = true;
  }
  CUtensorMap map0, map1;
  if (!make_map(&map0, wt0, f, (int64_t)9 * KB * n_chunks, BN) ||
      !make_map(&map1, wt1, f, (int64_t)9 * fp, BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t blocks = (int64_t)((m + 1) / 2) * ((f + BN - 1) / BN);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;

  a.bn_s = (const float*)bn0s;
  a.bn_t = (const float*)bn0t;
  fine_head_bf16_kernel<false><<<(unsigned)blocks, THREADS, SMEM_BYTES, st>>>(map0, a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  a.bn_s = (const float*)bn1s;
  a.bn_t = (const float*)bn1t;
  fine_head_bf16_kernel<true><<<(unsigned)blocks, THREADS, SMEM_BYTES, st>>>(map1, a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a bf16 block asks for.
extern "C" int p2p_fine_head_bf16_smem() { return (int)SMEM_BYTES; }

// float32. Per segment (n_seg <= 8): seg_rows1/seg_rows2 the level's
// rows of each side (the unused side may be null), seg_w its (9, cseg, F)
// weights, seg_t/seg_c the level's tile side and channels, seg_kind 0
// (paired, cseg = 2c), 1 or 2 (one side, cseg = c). y1, x1, y2, x2: (M,)
// int32 padded corners; inv1, inv2: (M, 16, 16); partial0: (M, 8, 8, F);
// wc1: (9, F, F); bn*: (F,); out: (M, F). psize must be 16; F a multiple
// of 32 up to 512; every cseg a multiple of 32. Returns a cudaError_t.
extern "C" int p2p_fine_head(const void* const* seg_rows1, const void* const* seg_rows2,
                             const void* const* seg_w, const int* seg_t, const int* seg_c,
                             const int* seg_kind, int n_seg, const void* y1, const void* x1,
                             const void* y2, const void* x2, const void* inv1,
                             const void* inv2, const void* partial0, const void* wc1,
                             const void* bn0s, const void* bn0t, const void* bn1s,
                             const void* bn1t, void* out, int m, int psize, int f,
                             void* stream) {
  if (n_seg <= 0 || n_seg > MAX_SEG || m <= 0 || psize != PS || f <= 0 || f % 32 != 0 ||
      f > 512) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  int cmax = 0;
  for (int s = 0; s < n_seg; ++s) {
    Seg& g = a.seg[s];
    g.rows[0] = (const float*)seg_rows1[s];
    g.rows[1] = (const float*)seg_rows2[s];
    g.w = (const float*)seg_w[s];
    g.t = seg_t[s];
    g.c = seg_c[s];
    g.kind = seg_kind[s];
    g.cseg = g.kind == 0 ? 2 * g.c : g.c;
    if (g.t <= 0 || PS % g.t != 0 || g.kind < 0 || g.kind > 2 || g.cseg % 32 != 0)
      return (int)cudaErrorInvalidValue;
    if (g.cseg > cmax) cmax = g.cseg;
  }
  a.n_seg = n_seg;
  a.y[0] = (const int*)y1;
  a.x[0] = (const int*)x1;
  a.y[1] = (const int*)y2;
  a.x[1] = (const int*)x2;
  a.inv[0] = (const float*)inv1;
  a.inv[1] = (const float*)inv2;
  a.partial0 = (const float*)partial0;
  a.wc1 = (const float*)wc1;
  a.bn0s = (const float*)bn0s;
  a.bn0t = (const float*)bn0t;
  a.bn1s = (const float*)bn1s;
  a.bn1t = (const float*)bn1t;
  a.out = (float*)out;
  a.f = f;
  a.x_elems = NPIX * cmax > NPOS * f ? NPIX * cmax : NPOS * f;
  const size_t smem = ((size_t)a.x_elems * sizeof(float) + 127) / 128 * 128 +
                      2 * NPIX * sizeof(float) +
                      STAGES_F * (KCF * LDAF + (size_t)KCF * f) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fine_head_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fine_head_f32_kernel<<<m, f, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
