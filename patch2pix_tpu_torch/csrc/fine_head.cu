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
// f32: the same two launches at float32 accuracy on the tensor cores by
// 3xTF32 (fine_head_tf32x3_kernel). It replaced a SIMT fmaf kernel of
// one proposal a block (62.03 ms at M = 2400 on the H100, where cuDNN's
// conv-BN-conv-BN-ReLU-max chain on B3's patches takes 38.78 ms). Bounds
// for the 1.450 TFLOP: 21.64 ms on the f32 SIMT pipes (67 TFLOP/s), the
// bound of that kernel; three TF32 products of each at the 495 TFLOP/s
// dense TF32 peak, 8.79 ms, the bound of this one.
//
// Error: each operand x splits into hi = x rounded to TF32 (10 mantissa
// bits, to nearest) and lo = x - hi, exact, |lo| <= 2^-11 |x|. The
// tensor cores sum hi hi' + hi lo' + lo hi' into f32 accumulators; what
// is dropped is lo lo' (<= 2^-22 |x x'|) and lo and lo' truncated to
// TF32 as the tensor cores read them (<= 2^-21 |x x'| each): about 2^-20
// of each product, against the 2e-4 rule that holds the kernel to the
// plain version (float32 products, TF32 off). The tensor cores' own
// accumulation rounds less accurately than an f32 add, and over all
// 3 x 9 x 512 products of an output it cost more than the split did:
// so each 32-channel chunk's 3 x 9 x 32 products accumulate on the
// tensor cores from zero, and the chunk sums are added in f32 registers.
//
// Design: a block is 2 proposals (one per consumer warpgroup) x 128
// output channels. The weights' hi and lo parts, split once per call by
// the wrapper and K-major, come by TMA as 32-channel x 128-column tiles
// (128-byte rows, the 128-byte swizzle) through a 3-stage ring, 32 KB a
// stage, that one producer thread keeps full; each weight byte that
// leaves L2 feeds both proposals. That is 2 x 2 x 18.9 MB per column
// tile and proposal pair, 45 GB a call at M = 2400 and F = 512 (as much
// as the SIMT kernel read, now under three times the products), about
// 9.6 ms at the ~4.7 TB/s of L2 -> SM delivery read on this card: the
// bytes into the SMs, not the tensor cores, are the nearer limit. conv0
// stages every window of its proposal whole, as in bf16 (62 KB for the
// fine stage's levels in 32-channel f32 rows); conv1's X1 (128 KB of f32
// a proposal) streams through eight 8 KB chunk slots by cp.async. The A
// fragments come by ldmatrix, are scaled (conv0) and split in registers.
// Shared memory: the 96 KB ring + 2 x 64 KB A tiles + 1 KB, one block an
// SM. Registers: the chunk's m64n128 accumulator and the running f32
// sum are 64 a thread each, the split fragments 32; ptxas fits them in
// the 168 a thread that 384 threads a block allow (conv0 spills a word;
// the producer warpgroup hands its registers on with setmaxnreg).

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

constexpr int KBF = 32;           // K block: one tap of one 32-channel chunk
constexpr int BNF = 128;          // output channels per block (the wgmma N)
constexpr int STAGES_F = 3;       // weight ring depth, each stage a hi and a lo tile
constexpr int MAX_CHUNKS_F = 32;  // conv0 input channels up to 1024
constexpr uint32_t ROW_F = KBF * 4;                // one cell or pixel of a chunk, 128 B
constexpr uint32_t B_TILE_F = BNF * ROW_F;         // 16 KB
constexpr uint32_t B_STAGE_F = 2 * B_TILE_F;       // the hi and lo tiles of one K block
constexpr uint32_t X1_CHUNK_F = NPOS * ROW_F;      // one conv1 chunk, 8 KB
constexpr int X1_SLOTS = A_WG_BYTES / X1_CHUNK_F;  // conv1 chunks staged at once
// 1 KB of slack aligns the ring to the swizzle's 1024 bytes; the zero
// row follows the A tiles
constexpr uint32_t SMEM_F = 1024 + STAGES_F * B_STAGE_F + 2 * A_WG_BYTES + ROW_F;

struct ChunkF {
  const float* rows;  // the level's (M, 4, t, t*c) rows of this chunk's side
  int log_t, c;       // log2 of the level's tile side; its channels
  int coff;           // the chunk's first channel within the level
  int side;           // 0 or 1
  int smem;           // offset of its window in the warpgroup's A tile
};

struct HeadArgsF {
  ChunkF chunk[MAX_CHUNKS_F];  // conv0's K chunks in weight order
  int n_chunks;
  const int* y[2];
  const int* x[2];
  const float* inv[2];    // (M, 16, 16)
  const float* partial0;  // (M, 8, 8, F)
  const float* bn_s;      // this conv's BatchNorm affine, (F,)
  const float* bn_t;
  float* x1;   // (M, 64, F): conv0's output, conv1's input
  float* out;  // (M, F)
  int m, f;
};

// x rounded to TF32, to nearest with ties away from zero: the low 13
// mantissa bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += A (64 x 8, registers) * B (128 x 8, K-major, swizzled smem)^T in
// TF32: each operand's low 13 mantissa bits are not read
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The float32 instance: the bf16 kernel's structure at float32 accuracy
// by 3xTF32 products. conv0 (CONV1 false): X1[m] = BN0(partial0[m] +
// conv3x3/2 of the scaled expansion); conv1: out[m] = max_pos
// relu(BN1(conv3x3/1 X1)). Block b covers proposals 2 (b / n_tiles) +
// {0, 1} (one per consumer warpgroup) and output channels 128 (b %
// n_tiles) + [0, 128). map_hi / map_lo: the weights' TF32 parts (F, 9
// C'), K ordered (32-channel chunk, tap, channel); a stage of the ring
// holds both parts of one K block.
//
// A tiles: conv0 keeps, per 32-channel chunk, the (t+1) x (t+1) window
// cells of its level and side unexpanded and unscaled (62 KB for the
// fine stage's levels), both sides' inverse norms beside them; conv1
// streams X1[m] through X1_SLOTS slots of 64 pixels, a chunk each.
// Cells and pixels are 128-byte rows swizzled as in the bf16 kernel:
// ldmatrix reads 16-byte units, which for 32-bit values are the TF32
// fragments' layout (row lane / 4 and 8 more, column lane % 4 and 4
// more). Each thread scales its fragments (conv0), then splits each
// value x into hi = rna(x) and lo = x - hi in registers; per k8 step
// three wgmma add lo * B_hi, hi * B_lo and hi * B_hi.
template <bool CONV1>
__global__ void __launch_bounds__(THREADS, 1)
fine_head_tf32x3_kernel(const __grid_constant__ CUtensorMap map_hi,
                        const __grid_constant__ CUtensorMap map_lo,
                        const __grid_constant__ HeadArgsF a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES_F], empty[STAGES_F];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* a_tiles = ring + STAGES_F * B_STAGE_F;
  uint8_t* zero = a_tiles + 2 * A_WG_BYTES;

  const int n_tiles = (a.f + BNF - 1) / BNF;
  const int pair = blockIdx.x / n_tiles, nt = blockIdx.x % n_tiles;
  const int n_chunks = CONV1 ? a.f / KBF : a.n_chunks;
  const int nkb = 9 * n_chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_F; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < ROW_F / 4) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0;
  __syncthreads();

  if (warp >= 8) {
    // producer: one thread keeps the weight ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      uint32_t phase = 0;
      int stage = 0;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], B_STAGE_F);
        uint8_t* dst = ring + stage * B_STAGE_F;
        tma_load_2d(dst, &map_hi, &full[stage], kb * KBF, nt * BNF);
        tma_load_2d(dst + B_TILE_F, &map_lo, &full[stage], kb * KBF, nt * BNF);
        if (++stage == STAGES_F) {
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
  // this lane's ldmatrix row (lanes 0-15 at k 0-3, 16-31 at k 4-7 of a
  // k8 step) and its fragments' rows (lane / 4 and 8 more)
  const int pos = 16 * wq + (lane & 15), oy = pos / OH, ox = pos % OH, khalf = lane >> 4;
  const int frag_oy = 2 * wq, frag_ox = lane >> 2;
  const int n_base = nt * BNF + 2 * (lane & 3);  // this thread's first column

  // acc[4 i + 2 h + c] is row 16 wq + (lane >> 2) + 8 h and column
  // n_base + 8 i + c of the warpgroup's 64 x 128 product, summed in f32
  // on the CUDA cores (conv0 from partial0); d, in the same layout,
  // takes one chunk's products on the tensor cores, whose accumulation
  // rounds less accurately than an f32 add, and is added into acc after
  // each chunk
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n_base + 8 * i;
      float2 v = make_float2(0.0f, 0.0f);
      if (!CONV1 && n < a.f)
        v = *reinterpret_cast<const float2*>(
            a.partial0 + ((int64_t)m * NPOS + 16 * wq + (lane >> 2) + 8 * h) * a.f + n);
      acc[4 * i + 2 * h] = v.x;
      acc[4 * i + 2 * h + 1] = v.y;
    }
  }

  // conv1: X1[m]'s chunk q into slot q % X1_SLOTS, 16-byte units in
  // device-memory order
  auto stage_x1 = [&](int q) {
    const float* src = a.x1 + (int64_t)m * NPOS * a.f + KBF * q;
    uint8_t* dst = tile + (q % X1_SLOTS) * X1_CHUNK_F;
    for (int e = tid; e < NPOS * 8; e += 128) {
      const int p = e / 8, j = e % 8;
      cp_async16(dst + p * ROW_F + ((j ^ (p % OH)) << 4), src + (int64_t)p * a.f + 4 * j);
    }
  };
  if (CONV1) {
    // chunks 0 .. X1_SLOTS - 2, one cp.async group each (empty past the last)
    for (int q = 0; q < X1_SLOTS - 1; ++q) {
      if (q < n_chunks) stage_x1(q);
      cp_async_commit();
    }
  } else {
    // every chunk's window cells (L1-cached: a neighbouring proposal of
    // the same image may share them): chunk 0 with both inverse-norm rows
    // as one cp.async group, the rest as a second
    for (int q = 0; q < n_chunks; ++q) {
      const ChunkF& ch = a.chunk[q];
      const int t = 1 << ch.log_t, side = t + 1;
      const Window w = window_of(max(a.y[ch.side][m], 0), max(a.x[ch.side][m], 0), ch.log_t);
      for (int e = tid; e < side * side * 8; e += 128) {
        const int cell = e / 8, j = e % 8, cy = cell / side, cx = cell % side;
        const int sy = w.wy + cy, sx = w.wx + cx;  // superblock cell
        const int64_t off =
            ((((int64_t)m * 4 + (sy >> ch.log_t) * 2 + (sx >> ch.log_t)) * t + (sy & (t - 1))) *
                 t + (sx & (t - 1))) * ch.c + ch.coff + 4 * j;
        cp_async16_ca(tile + ch.smem + cell * ROW_F + ((j ^ (cx & 7)) << 4), ch.rows + off);
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
    bar_sync_wg(wg);
  }

  uint32_t phase = 0;
  int stage = 0;
  for (int q = 0; q < n_chunks; ++q) {
    Window w{};
    uint32_t base;
    int wside = 0, inv_side = 0;
    if (CONV1) {
      cp_async_wait<X1_SLOTS - 2>();  // chunk q has landed (this thread's part)
      bar_sync_wg(wg);                // ... everyone's; chunk q - 1's slot is free
      if (q + X1_SLOTS - 1 < n_chunks) stage_x1(q + X1_SLOTS - 1);
      cp_async_commit();
      base = tile_u32 + (q % X1_SLOTS) * X1_CHUNK_F;
    } else {
      if (q == 1) {  // the second cp.async group: the other chunks
        cp_async_wait<0>();
        bar_sync_wg(wg);
      }
      const ChunkF& ch = a.chunk[q];
      w = window_of(max(a.y[ch.side][m], 0), max(a.x[ch.side][m], 0), ch.log_t);
      base = tile_u32 + ch.smem;
      wside = (1 << ch.log_t) + 1;
      inv_side = ch.side * NPIX;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // the lane's ldmatrix row address, or the zero row in the padding
      uint32_t row = zero_u32;
      int swz = 0;
      if (CONV1) {
        const int iy = oy + dy - 1, ix = ox + dx - 1;
        if (iy >= 0 && iy < OH && ix >= 0 && ix < OH) {
          row = base + (iy * OH + ix) * ROW_F;
          swz = ix;
        }
      } else {
        const int py = 2 * oy + dy - 1, px = 2 * ox + dx - 1;
        if (py >= 0 && px >= 0) {
          const int cy = ((w.by + py) >> w.log_ds) - w.wy, cx = ((w.bx + px) >> w.log_ds) - w.wx;
          row = base + (cy * wside + cx) * ROW_F;
          swz = cx & 7;
        }
      }
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(hi[kk], row == zero_u32 ? row : row + (((2 * kk + khalf) ^ swz) << 4));
      // the fragments' rows' inverse norms (conv0; any finite value in
      // the padding, whose cells read zero): registers 0 and 2 hold row
      // lane / 4, 1 and 3 the row 8 further (the next output row)
      float sa = 1.0f, sb = 1.0f;
      if (!CONV1) {
        const int py = 2 * frag_oy + dy - 1, px = max(2 * frag_ox + dx - 1, 0);
        sa = inv_s[inv_side + max(py, 0) * PS + px];
        sb = inv_s[inv_side + (py + 2) * PS + px];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = __uint_as_float(hi[kk][r]);
          if (!CONV1) x = __fmul_rn(x, (r & 1) ? sb : sa);
          hi[kk][r] = tf32_rna(x);
          lo[kk][r] = __float_as_uint(__fsub_rn(x, __uint_as_float(hi[kk][r])));
        }
      }
      mbar_wait(&full[stage], phase);
      fence_acc(d);
      wgmma_fence();
      const uint32_t b_hi = ring_u32 + stage * B_STAGE_F, b_lo = b_hi + B_TILE_F;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // the small products first
        wgmma_m64n128k8_tf32_rs(d, lo[kk], sw128_desc(b_hi + kk * 32));
        wgmma_m64n128k8_tf32_rs(d, hi[kk], sw128_desc(b_lo + kk * 32));
        wgmma_m64n128k8_tf32_rs(d, hi[kk], sw128_desc(b_hi + kk * 32));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES_F) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
  }

  if constexpr (!CONV1) {
    // BN0 into X1
    if (m_raw >= a.m) return;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = n_base + 8 * i;
      if (n >= a.f) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * wq + (lane >> 2) + 8 * h;
        *reinterpret_cast<float2*>(a.x1 + ((int64_t)m * NPOS + p) * a.f + n) =
            make_float2(__fadd_rn(__fmul_rn(acc[4 * i + 2 * h], a.bn_s[n]), a.bn_t[n]),
                        __fadd_rn(__fmul_rn(acc[4 * i + 2 * h + 1], a.bn_s[n + 1]),
                                  a.bn_t[n + 1]));
      }
    }
  } else {
    // conv1: BN1, ReLU, then the max over the 64 positions: over a
    // thread's two rows, the warp's eight row groups (lanes ^ 4, 8, 16),
    // then the four warps through shared memory (the X1 slots are free).
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = min(n_base + 8 * i, a.f - 2);  // columns past F are dropped below
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float s = a.bn_s[n + c], t = a.bn_t[n + c];
        float best = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          best = fmaxf(best, __fadd_rn(__fmul_rn(acc[4 * i + 2 * h + c], s), t));
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 4));
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 8));
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 16));
        acc[4 * i + c] = best;
      }
    }
    float* red = reinterpret_cast<float*>(tile);  // [4 warps][128 columns]
    cp_async_wait<0>();
    bar_sync_wg(wg);  // every warp is done with the slots
    if (lane < 4) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        red[wq * BNF + 8 * i + 2 * lane] = acc[4 * i];
        red[wq * BNF + 8 * i + 2 * lane + 1] = acc[4 * i + 1];
      }
    }
    bar_sync_wg(wg);
    const int n = nt * BNF + 2 * tid;
    if (tid < BNF / 2 && m_raw < a.m && n < a.f) {
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        v[c] = fmaxf(fmaxf(red[2 * tid + c], red[BNF + 2 * tid + c]),
                     fmaxf(red[2 * BNF + 2 * tid + c], red[3 * BNF + 2 * tid + c]));
      *reinterpret_cast<float2*>(a.out + (int64_t)m * a.f + n) = make_float2(v[0], v[1]);
    }
  }
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

// float32, 3xTF32 on the tensor cores. Per conv0 K chunk q < n_chunks
// (<= 32): chunk_rows[q] the level's (M, 4, t, t*c) rows of the chunk's
// side, chunk_log_t[q] = log2 t, chunk_c[q] = c (a multiple of 4),
// chunk_coff[q] the chunk's first channel, chunk_side[q] 0 or 1 — each
// chunk 32 channels. y1, x1, y2, x2: (M,) int32 padded corners; inv1,
// inv2: (M, 16, 16); partial0: (M, 8, 8, F); wt0_hi, wt0_lo: (F, 9 * 32
// n_chunks) and wt1_hi, wt1_lo: (F, 9 F), the weights' TF32 parts
// (hi + lo), K ordered (chunk, tap, channel); bn*: (F,); x1buf: (M, 64,
// F) scratch; out: (M, F). F a multiple of 32, at most 512; the chunks'
// windows ((t+1)^2 cells of 128 bytes each) fit in 62 KB. Returns a
// cudaError_t.
extern "C" int p2p_fine_head(const void* const* chunk_rows, const int* chunk_log_t,
                             const int* chunk_c, const int* chunk_coff, const int* chunk_side,
                             int n_chunks, const void* y1, const void* x1, const void* y2,
                             const void* x2, const void* inv1, const void* inv2,
                             const void* partial0, const void* wt0_hi, const void* wt0_lo,
                             const void* wt1_hi, const void* wt1_lo, const void* bn0s,
                             const void* bn0t, const void* bn1s, const void* bn1t, void* x1buf,
                             void* out, int m, int f, void* stream) {
  if (n_chunks <= 0 || n_chunks > MAX_CHUNKS_F || m <= 0 || f <= 0 || f % KBF != 0 || f > 512)
    return (int)cudaErrorInvalidValue;
  HeadArgsF a = {};
  int window_bytes = 0;  // conv0's staged windows, chunk after chunk
  for (int q = 0; q < n_chunks; ++q) {
    ChunkF& ch = a.chunk[q];
    ch.rows = (const float*)chunk_rows[q];
    ch.log_t = chunk_log_t[q];
    ch.c = chunk_c[q];
    ch.coff = chunk_coff[q];
    ch.side = chunk_side[q];
    if (ch.log_t < 0 || ch.log_t > 4 || ch.c % 4 != 0 || ch.coff < 0 || ch.coff % 4 != 0 ||
        ch.coff + KBF > ch.c || ch.side < 0 || ch.side > 1)
      return (int)cudaErrorInvalidValue;
    ch.smem = window_bytes;
    window_bytes += ((1 << ch.log_t) + 1) * ((1 << ch.log_t) + 1) * ROW_F;
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
  a.x1 = (float*)x1buf;
  a.out = (float*)out;
  a.m = m;
  a.f = f;

  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t rc = cudaFuncSetAttribute(fine_head_tf32x3_kernel<false>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)SMEM_F);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(fine_head_tf32x3_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_F);
    if (rc != cudaSuccess) return (int)rc;
    attr_set = true;
  }
  CUtensorMap hi0, lo0, hi1, lo1;
  const int64_t k0 = (int64_t)9 * KBF * n_chunks, k1 = (int64_t)9 * f;
  if (!make_map_f32(&hi0, wt0_hi, f, k0, BNF) || !make_map_f32(&lo0, wt0_lo, f, k0, BNF) ||
      !make_map_f32(&hi1, wt1_hi, f, k1, BNF) || !make_map_f32(&lo1, wt1_lo, f, k1, BNF))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t blocks = (int64_t)((m + 1) / 2) * ((f + BNF - 1) / BNF);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;

  a.bn_s = (const float*)bn0s;
  a.bn_t = (const float*)bn0t;
  fine_head_tf32x3_kernel<false><<<(unsigned)blocks, THREADS, SMEM_F, st>>>(hi0, lo0, a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  a.bn_s = (const float*)bn1s;
  a.bn_t = (const float*)bn1t;
  fine_head_tf32x3_kernel<true><<<(unsigned)blocks, THREADS, SMEM_F, st>>>(hi1, lo1, a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a float32 block asks for.
extern "C" int p2p_fine_head_smem() { return (int)SMEM_F; }
