// B2: dense feature correlation fused with the 2x2x2x2 max-pool.
//
// Replaces patch2pix_tpu/ops/corr_pool_pallas.py corr_pool_fused
// (_corr_pool_impl): for features f1 (B, h1, w1, C) and f2 (B, h2, w2, C)
// with even spatial dims,
//
//   out[b, p, q] = max_{s1, s2} <f1[b, cell(p, s1)], f2[b, cell(q, s2)]>
//
// where p = i1*(w1/2) + j1 is a pooled cell of image 1, s1 = d1*2 + e1
// its window parity and cell(p, s1) = (2*i1 + d1, 2*j1 + e1) (likewise
// q, s2 for image 2). out is (B, h1/2 * w1/2, h2/2 * w2/2) float32: the
// pooled volume, without the 16x larger pre-pool volume ever existing.
//
// Operands come laid out by the wrapper (ops/corr_pool.py
// cell_parity_rows): feature row 4*p + s holds cell(p, s), rows and
// channels zero-padded to the tile. The four parities of a pooled cell
// are then four neighbouring rows, so a tile of raw rows is a tile of
// pooled cells and the pool is a max over aligned groups of 4 x 4
// products, taken in registers: no pre-pool value leaves a thread.
//
// Bound on the H100 (change_stride, 2 x (96, 128, 256)): operations,
// 154.6 GFLOP — 2.31 ms at the 67 TFLOP/s float32 peak, 0.156 ms at
// the 989 TFLOP/s bf16 tensor peak. The inputs (25 MB f32, 12.6 MB bf16)
// stay in L2, so the traffic that matters is L2 -> SM.
//
// float32 (never TF32): register-blocked SIMT. A block of 256 threads
// owns 128 x 128 raw rows (32 x 32 pooled cells); thread (ty, tx) owns
// image-1 cells ty and 16 + ty and image-2 cells tx and 16 + tx: 8 x 8
// raw products = 2 x 2 pooled cells. Operands are K-major ((B, Cp, R)
// from the wrapper), so per channel a thread reads 4 float4 (LDS.128,
// consecutive threads on consecutive 16 bytes) for 64 FMAs. K chunks of
// 16 channels are double-buffered with cp.async. L2 -> SM traffic:
// 2 x 96 x 96 blocks x 256 rows x 1 KB = 4.7 GB.
//
// bf16: Hopper wgmma fed by TMA. A persistent block (one per SM) walks a
// contiguous range of (batch, image-1 panel, image-2 tile) work items.
// The image-1 panel (256 raw rows = 64 pooled cells, all C channels,
// 128 KB at C = 256) stays resident in shared memory; image-2 tiles of
// 64 rows x 64 channels (8 KB) stream through a 4-stage TMA ring with
// full/empty mbarriers, so the next tile's loads overlap this tile's
// epilogue. Warpgroups 0 and 1 each own 128 panel rows (two m64n64k16
// accumulators, 64 registers a thread); warpgroup 2 is the producer
// (one thread issues the TMA copies). Why 256 panel rows: the image-2
// stream is 2 x (12288 / panel rows) x 6.3 MB of L2 -> SM traffic,
// 1.2 GB at 128 rows (about the compute time) and 0.6 GB at 256 (well
// below it). Operands use the 128-byte swizzle that TMA writes and
// wgmma reads. Epilogue: in the wgmma accumulator layout, a row's four
// image-1 parities sit on lanes l ^ 4, l ^ 8, the image-2 parities in a
// thread's register pair and on lane l ^ 1; three butterfly rounds
// (each halves the values a lane holds) leave every lane with 4
// distinct pooled cells, stored as 32-byte runs. Products of bf16 values
// are exact in f32; sums are in another order than a matmul library's,
// so results agree with the plain version to rounding.
//
// bf16 wider than 384 channels (ResNet50/101's layer3: C = 1024): the
// resident panel would need C / 64 x 32 KB (512 KB at C = 1024), beyond
// an SM's 227 KB, so a kernel of its own, corr_pool_stream_kernel,
// streams both operands' K blocks (64 channels each). Its work item is
// one image-1 panel (256 rows) against an image-2 pair of two adjacent
// 192-row tiles, taken by a cluster of 2 CTAs, one tile each: a CTA owns
// 256 x 192 raw rows (64 x 48 pooled cells). Per K block each CTA's
// producer TMA-loads half of the panel's block (128 rows, 16 KB),
// multicast into both CTAs' ring stage, and its own image-2 block (24
// KB): 56 KB a stage, 4 stages. A stage's full barrier waits for the
// 56 KB of its own CTA; its empty barrier counts the consumer warps of
// both CTAs (arrivals on the other CTA's barrier through mapa), so
// neither producer overwrites a stage that either CTA still reads. Two
// consumer warpgroups each own 128 panel rows as two m64n192k16
// accumulators (192 f32 registers a thread; the producer warpgroup
// gives its registers away, setmaxnreg 40 / 232), and one wgmma group
// stays in flight: a K block's stage goes back once the next block's
// products are issued. The clusters are persistent (one CTA an SM, as
// many clusters as fit: 66 on an H100) and take items strided by
// cluster in bands of S_BAND panels, so the clusters in flight share a
// few panels and image-2 pairs of one batch element, which stay in L2.
//
// What bounds it: delivery from L2 into the SMs, not the tensor cores.
// At change_stride's 2 x (96, 128, 1024) (618.5 GFLOP, 0.625 ms at the
// bf16 peak) the kernel it replaced re-read the panel for every 64-row
// image-2 tile: 12.1 GB from L2, 2.88-2.90 ms. The 256 x 128 CTA tile
// first written here (a 2-CTA cluster over 256 image-2 rows) moves 4.8
// GB from L2 (the multicast panel counted once), 7.2 GB into the SMs,
// and reads 1.66 ms; the 256 x 192 tile, 1.29 times fewer bytes into
// the SMs per product (4.0 GB from L2, 5.6 GB into the SMs), reads
// 1.20 ms (an H100 80GB HBM3 at 700 W; PERF.md). The order of the items barely moves it (bands of 1 to 48
// panels within 3%); a wider tile does not fit the registers. The
// epilogue is the resident kernel's butterfly pool over S_BN / 8
// image-2 column groups; 32-byte runs are stored. Image-2 rows are
// padded to a multiple of 2 x S_BN (a whole pair), so the last pair's
// second tile may be all zeros past np2, which the store mask drops.
// C <= 384 keeps the resident kernel.

#include "sm90.cuh"

namespace {

using namespace sm90;

// ------------------------------------------------------------ float32

constexpr int F_TILE = 128;  // raw rows per tile side (32 pooled cells)
constexpr int F_KC = 16;     // channels per stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// f1: (B, cp, rp1), f2: (B, cp, rp2) K-major; rp1, rp2 multiples of
// F_TILE, cp a multiple of F_KC.
__global__ void __launch_bounds__(256, 2)
corr_pool_f32_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                     float* __restrict__ out, int np1, int np2, int rp1, int rp2, int cp) {
  __shared__ __align__(16) float As[2][F_KC][F_TILE];
  __shared__ __align__(16) float Bs[2][F_KC][F_TILE];
  const int b = blockIdx.z;
  const float* a_src = f1 + (int64_t)b * cp * rp1 + blockIdx.y * F_TILE;
  const float* b_src = f2 + (int64_t)b * cp * rp2 + blockIdx.x * F_TILE;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // one stage: 16 channels x 128 rows of each operand, two 16-byte
  // copies of each per thread
  auto stage = [&](int buf, int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + 256 * u, k = e / 32, r = (e % 32) * 4;
      cp_async16(&As[buf][k][r], a_src + (int64_t)(k0 + k) * rp1 + r);
      cp_async16(&Bs[buf][k][r], b_src + (int64_t)(k0 + k) * rp2 + r);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int nk = cp / F_KC;
  stage(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      stage((kc + 1) & 1, (kc + 1) * F_KC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = kc & 1;
#pragma unroll
    for (int k = 0; k < F_KC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // acc[4*ci + s1][4*cj + s2]: image-1 cell ty + 16*ci, image-2 cell
  // tx + 16*cj, parities (s1, s2)
#pragma unroll
  for (int ci = 0; ci < 2; ++ci) {
#pragma unroll
    for (int cj = 0; cj < 2; ++cj) {
      float m = acc[4 * ci][4 * cj];
#pragma unroll
      for (int s1 = 0; s1 < 4; ++s1)
#pragma unroll
        for (int s2 = 0; s2 < 4; ++s2) m = fmaxf(m, acc[4 * ci + s1][4 * cj + s2]);
      const int p = blockIdx.y * 32 + ty + 16 * ci, q = blockIdx.x * 32 + tx + 16 * cj;
      if (p < np1 && q < np2) out[((int64_t)b * np1 + p) * np2 + q] = m;
    }
  }
}

// --------------------------------------------------------------- bf16

constexpr int H_BM = 256;       // image-1 panel rows (64 pooled cells)
constexpr int H_BN = 64;        // image-2 tile rows (16 pooled cells)
constexpr int H_KB = 64;        // channels per 128-byte swizzled row
constexpr int H_STAGES = 4;     // image-2 ring depth
constexpr int H_MAX_CP = 384;   // the resident panel's limit
constexpr int H_THREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr uint32_t H_ABLOCK_BYTES = H_BM * H_KB * 2;  // 32 KB per K block
constexpr uint32_t H_BTILE_BYTES = H_BN * H_KB * 2;   // 8 KB per stage

// 1 KB of slack to align the base to the swizzle's 1024 bytes
size_t h_smem_bytes(int cp) {
  return 1024 + (size_t)(cp / H_KB) * H_ABLOCK_BYTES + (size_t)H_STAGES * H_BTILE_BYTES;
}

// The streamed kernel (cp > H_MAX_CP).
constexpr int S_CLUSTER = 2;                     // CTAs a cluster, one panel
constexpr int S_BN = 192;                        // image-2 tile rows a CTA
constexpr int S_ROWS2 = S_CLUSTER * S_BN;        // image-2 row multiple: a pair of tiles
constexpr int S_HALF = H_BM / S_CLUSTER;         // panel rows a CTA loads and multicasts
constexpr int S_STAGES = 4;
constexpr int S_BAND = 16;                       // panels a band of the work order
constexpr uint32_t S_HALF_BYTES = S_HALF * H_KB * 2;                // 16 KB
constexpr uint32_t S_STAGE_BYTES = H_ABLOCK_BYTES + S_BN * H_KB * 2;  // 56 KB
constexpr size_t S_SMEM_BYTES = 1024 + (size_t)S_STAGES * S_STAGE_BYTES;
static_assert(S_SMEM_BYTES <= 232448 - 64, "the ring and its barriers fit 227 KB");

// d (+)= A (64 x 16, K-major) * B (64 x 16, K-major)^T; scale_d 0
// starts the sum.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with B 192 x 16: d (64 x 192) in 96 registers a thread.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The streamed kernel's pool: max over c of a wgmma accumulator's (j,
// i, c) values, then three butterfly rounds (the resident kernel's,
// which keeps its own inline copy: through this function it ran slower
// on the card). d[4j + 2i + c] is row 16 warp + (lane >> 2) + 8i of
// the m64 half and column 8j + 2 (lane & 3) + c: pooled cell (lane >> 4)
// + 2i of the warp's four, parity (lane >> 2) & 3; image-2 cell 2j +
// b1, parity 2 b0 + c. Each round pairs lanes and halves what a lane
// holds: over c in registers, b0 (splitting j), b2 (splitting i), b3
// (splitting j / 2). Leaves val[m], m < NJ / 4: image-1 cell 2 b2 +
// (lane >> 4) of the warp's four, image-2 cell 8m + 4 b3 + 2 b0 + b1.
template <int NJ>
__device__ __forceinline__ void pool_butterfly(const float (&d)[4 * NJ], int lane,
                                               float (&val)[NJ / 4]) {
  const int b0 = lane & 1, b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
  float v[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[i][j] = fmaxf(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  float u[2][NJ / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < NJ / 2; ++k) {
      const float keep = b0 ? v[i][2 * k + 1] : v[i][2 * k];
      const float send = b0 ? v[i][2 * k] : v[i][2 * k + 1];
      u[i][k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 1));
    }
  float v2[NJ / 2];
#pragma unroll
  for (int k = 0; k < NJ / 2; ++k) {
    const float keep = b2 ? u[1][k] : u[0][k];
    const float send = b2 ? u[0][k] : u[1][k];
    v2[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
#pragma unroll
  for (int m = 0; m < NJ / 4; ++m) {
    const float keep = b3 ? v2[2 * m + 1] : v2[2 * m];
    const float send = b3 ? v2[2 * m] : v2[2 * m + 1];
    val[m] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
}

// The resident kernel (cp <= H_MAX_CP). map1 over (B * rp1 rows, cp)
// with (H_KB, H_BM) boxes, map2 over (B * rp2, cp) with (H_KB, H_BN)
// boxes; rp1 % H_BM == rp2 % H_BN == cp % H_KB == 0.
__global__ void __launch_bounds__(H_THREADS, 1)
corr_pool_bf16_kernel(const __grid_constant__ CUtensorMap map1,
                      const __grid_constant__ CUtensorMap map2, float* __restrict__ out,
                      int batch, int np1, int np2, int rp1, int rp2, int cp) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 2 * H_STAGES];
  uint8_t* a_panel = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int nkb = cp / H_KB;
  uint8_t* ring = a_panel + nkb * H_ABLOCK_BYTES;
  uint64_t* a_full = &bars[0];
  uint64_t* a_empty = &bars[1];
  uint64_t* full = &bars[2];
  uint64_t* empty = &bars[2 + H_STAGES];

  const int nap = rp1 / H_BM, nt2 = rp2 / H_BN;
  const int64_t total = (int64_t)batch * nap * nt2;
  const int64_t t_begin = total * blockIdx.x / gridDim.x;
  const int64_t t_end = total * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, 256);
    for (int s = 0; s < H_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every copy
    if (threadIdx.x != 256) return;
    int64_t panel = -1;
    uint32_t a_loads = 0, phase = 0;
    int stage = 0;
    for (int64_t t = t_begin; t < t_end; ++t) {
      const int64_t pan = t / nt2;
      const int tile = (int)(t % nt2), b = (int)(pan / nap), ap = (int)(pan % nap);
      if (pan != panel) {
        // a new panel: wait until both consumers are done with the old one
        if (a_loads > 0) mbar_wait(a_empty, (a_loads - 1) & 1);
        mbar_expect_tx(a_full, nkb * H_ABLOCK_BYTES);
        for (int kb = 0; kb < nkb; ++kb)
          tma_load_2d(a_panel + kb * H_ABLOCK_BYTES, &map1, a_full, kb * H_KB,
                      b * rp1 + ap * H_BM);
        ++a_loads;
        panel = pan;
      }
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], H_BTILE_BYTES);
        tma_load_2d(ring + stage * H_BTILE_BYTES, &map2, &full[stage], kb * H_KB,
                    b * rp2 + tile * H_BN);
        if (++stage == H_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns panel rows [128 wg, 128 wg + 128) as two
  // m64 halves h
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int b0 = lane & 1, b1 = (lane >> 1) & 1, b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
  const uint32_t a_base = smem_u32(a_panel) + wg * 128 * 128;
  const uint32_t r_base = smem_u32(ring);
  float d[2][32];
  int64_t panel = -1;
  uint32_t a_loads = 0, phase = 0;
  int stage = 0;
  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t pan = t / nt2;
    const int tile = (int)(t % nt2), b = (int)(pan / nap), ap = (int)(pan % nap);
    if (pan != panel) {
      if (a_loads > 0) mbar_arrive(a_empty);
      mbar_wait(a_full, a_loads & 1);
      ++a_loads;
      panel = pan;
    }
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(&full[stage], phase);
      fence_acc(d[0]);
      fence_acc(d[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < H_KB / 16; ++kk) {
        const uint64_t db = sw128_desc(r_base + stage * H_BTILE_BYTES + kk * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t da = sw128_desc(a_base + kb * H_ABLOCK_BYTES + h * 64 * 128 + kk * 32);
          wgmma_m64n64k16(d[h], da, db, (kb | kk) != 0);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d[0]);
      fence_acc(d[1]);
      mbar_arrive(&empty[stage]);
      if (++stage == H_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Pool. d[h][4j + 2i + c] is row 16 warp + (lane >> 2) + 8i of half
    // h and column 8j + 2 (lane & 3) + c: pooled cell (lane >> 4) + 2i
    // of the warp's four, parity (lane >> 2) & 3; image-2 cell 2j + b1,
    // parity 2 b0 + c. Each round pairs lanes and halves what a lane
    // holds: over c in registers, b0 (splitting j), b2 (splitting i),
    // b3 (splitting j / 2).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = fmaxf(d[h][4 * j + 2 * i], d[h][4 * j + 2 * i + 1]);
      float u[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float keep = b0 ? v[i][2 * k + 1] : v[i][2 * k];
          const float send = b0 ? v[i][2 * k] : v[i][2 * k + 1];
          u[i][k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 1));
        }
      float v2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float keep = b2 ? u[1][k] : u[0][k];
        const float send = b2 ? u[0][k] : u[1][k];
        v2[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 4));
      }
      // image-1 cell: panel ap, warpgroup wg, half h, warp, 2 b2 + lane bit 4
      const int p = ap * (H_BM / 4) + wg * 32 + h * 16 + warp * 4 + 2 * b2 + (lane >> 4);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float keep = b3 ? v2[2 * m + 1] : v2[2 * m];
        const float send = b3 ? v2[2 * m] : v2[2 * m + 1];
        const float val = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, 8));
        const int q = tile * (H_BN / 4) + 8 * m + 4 * b3 + 2 * b0 + b1;
        if (p < np1 && q < np2) out[((int64_t)b * np1 + p) * np2 + q] = val;
      }
    }
  }
}

// Item t of the streamed kernel's order: batch elements one after
// another; in each, bands of S_BAND panels (the last one narrower), and
// in a band the image-2 pairs one after another, each against the
// band's panels. Clusters take items t = cluster, cluster + clusters,
// ..., so those in flight work on neighbouring items.
__device__ __forceinline__ void stream_item(int64_t t, int nap, int npair, int& b, int& ap,
                                            int& pair) {
  const int64_t per_batch = (int64_t)nap * npair;
  b = (int)(t / per_batch);
  const int r = (int)(t % per_batch);
  const int first = r / (S_BAND * npair) * S_BAND;
  const int width = min(S_BAND, nap - first);
  const int in_band = r - first * npair;
  pair = in_band / width;
  ap = first + in_band % width;
}

// The streamed kernel (cp > H_MAX_CP), launched in clusters of
// S_CLUSTER CTAs along x. map1 over (B * rp1 rows, cp) with (H_KB,
// S_HALF) boxes, map2 over (B * rp2, cp) with (H_KB, S_BN) boxes; rp1 %
// H_BM == rp2 % S_ROWS2 == cp % H_KB == 0.
__global__ void __launch_bounds__(H_THREADS, 1)
corr_pool_stream_kernel(const __grid_constant__ CUtensorMap map1,
                        const __grid_constant__ CUtensorMap map2, float* __restrict__ out,
                        int batch, int np1, int np2, int rp1, int rp2, int cp) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S_STAGES];
  __shared__ __align__(8) uint64_t empty[S_STAGES];
  // a stage: the panel's K block (rank r's multicast at r * S_HALF_BYTES),
  // then this CTA's image-2 K block
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t rank = cluster_ctarank();
  const int nkb = cp / H_KB, nap = rp1 / H_BM, npair = rp2 / S_ROWS2;
  const int64_t total = (int64_t)batch * nap * npair;
  const int cluster = blockIdx.x / S_CLUSTER, clusters = gridDim.x / S_CLUSTER;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S_CLUSTER * 8);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every barrier of the cluster is set before a copy or an arrival reaches it
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every copy; the warpgroup hands its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      uint32_t phase = 0;
      int stage = 0;
      for (int64_t t = cluster; t < total; t += clusters) {
        int b, ap, pair;
        stream_item(t, nap, npair, b, ap, pair);
        const int row1 = b * rp1 + ap * H_BM + rank * S_HALF;
        const int row2 = b * rp2 + pair * S_ROWS2 + rank * S_BN;
        for (int kb = 0; kb < nkb; ++kb) {
          uint8_t* st = ring + stage * S_STAGE_BYTES;
          mbar_wait_cluster(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], S_STAGE_BYTES);
          tma_load_2d_multicast(st + rank * S_HALF_BYTES, &map1, &full[stage], kb * H_KB, row1,
                                (uint16_t)((1u << S_CLUSTER) - 1));
          tma_load_2d(st + H_ABLOCK_BYTES, &map2, &full[stage], kb * H_KB, row2);
          if (++stage == S_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup wg owns panel rows [128 wg, 128 wg + 128) as
    // two m64 halves h
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int b0 = lane & 1, b1 = (lane >> 1) & 1, b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
    const uint32_t r_base = smem_u32(ring);
    // hand a stage back to both CTAs' producers, one arrival a warp
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0)
        for (int r = 0; r < S_CLUSTER; ++r) mbar_arrive_cluster(&empty[s], r);
    };
    float d[2][S_BN / 2];
    uint32_t phase = 0;
    int stage = 0;
    for (int64_t t = cluster; t < total; t += clusters) {
      int b, ap, pair;
      stream_item(t, nap, npair, b, ap, pair);
      int held = -1;  // the stage whose products may still be in flight
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&full[stage], phase);
        fence_acc(d[0]);
        fence_acc(d[1]);
        wgmma_fence();
        const uint32_t st = r_base + stage * S_STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < H_KB / 16; ++kk) {
          const uint64_t db = sw128_desc(st + H_ABLOCK_BYTES + kk * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint64_t da = sw128_desc(st + (wg * 128 + h * 64) * 128 + kk * 32);
            wgmma_m64n192k16(d[h], da, db, (kb | kk) != 0);
          }
        }
        wgmma_commit();
        // one group in flight: the previous K block's products are done
        wgmma_wait<1>();
        fence_acc(d[0]);
        fence_acc(d[1]);
        if (held >= 0) release(held);
        held = stage;
        if (++stage == S_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d[0]);
      fence_acc(d[1]);
      release(held);

      // Pool: every lane ends with S_BN / 16 distinct pooled cells, in
      // 32-byte runs of 8 lanes.
      const int tile = pair * S_CLUSTER + (int)rank;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float val[S_BN / 32];
        pool_butterfly<S_BN / 8>(d[h], lane, val);
        const int p = ap * (H_BM / 4) + wg * 32 + h * 16 + warp * 4 + 2 * b2 + (lane >> 4);
#pragma unroll
        for (int m = 0; m < S_BN / 32; ++m) {
          const int q = tile * (S_BN / 4) + 8 * m + 4 * b3 + 2 * b0 + b1;
          if (p < np1 && q < np2) out[((int64_t)b * np1 + p) * np2 + q] = val[m];
        }
      }
    }
  }
  // no CTA leaves while the other may still multicast into it or arrive
  // on its barriers
  cluster_sync();
}

// Dynamic shared memory above 48 KB for the resident kernel, set once
// per process.
cudaError_t set_smem_once(size_t bytes) {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(corr_pool_bf16_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = rc == cudaSuccess;
  return rc;
}

// The streamed kernel's launch: S_CLUSTER CTAs a cluster along x, as
// many clusters as can be resident at once (queried once per process),
// at most one an item.
cudaLaunchConfig_t stream_config(cudaLaunchAttribute* attr, int clusters, cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S_CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S_CLUSTER * clusters);
  cfg.blockDim = dim3(H_THREADS);
  cfg.dynamicSmemBytes = S_SMEM_BYTES;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the streamed kernel's shared memory and finds the clusters
// resident at once, once per process.
cudaError_t stream_clusters(int* clusters) {
  static int resident = 0;
  if (resident == 0) {
    cudaError_t rc = cudaFuncSetAttribute(
        corr_pool_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S_SMEM_BYTES);
    if (rc != cudaSuccess) return rc;
    int dev = 0, sms = 0;
    rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = stream_config(&attr, sms / S_CLUSTER, 0);
    rc = cudaOccupancyMaxActiveClusters(&resident, corr_pool_stream_kernel, &cfg);
    if (rc != cudaSuccess) return rc;
    if (resident <= 0) return cudaErrorInvalidConfiguration;
  }
  *clusters = resident;
  return cudaSuccess;
}

}  // namespace

// f1, f2: the wrapper's layouts (float32 (B, cp, rp), K-major; bf16
// (B, rp, cp)); out (B, np1, np2) float32. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t.
extern "C" int p2p_corr_pool(const void* f1, const void* f2, void* out, int batch, int np1,
                             int np2, int rp1, int rp2, int cp, int dtype, void* stream) {
  if (batch <= 0 || np1 <= 0 || np2 <= 0 || rp1 < 4 * np1 || rp2 < 4 * np2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (rp1 % F_TILE || rp2 % F_TILE || cp <= 0 || cp % F_KC) return (int)cudaErrorInvalidValue;
    dim3 grid(rp2 / F_TILE, rp1 / F_TILE, batch);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    corr_pool_f32_kernel<<<grid, 256, 0, s>>>((const float*)f1, (const float*)f2, (float*)out,
                                              np1, np2, rp1, rp2, cp);
  } else if (dtype == 1) {
    const bool streamed = cp > H_MAX_CP;
    if (rp1 % H_BM || rp2 % (streamed ? S_ROWS2 : H_BN) || cp <= 0 || cp % H_KB)
      return (int)cudaErrorInvalidValue;
    CUtensorMap map1, map2;
    if (streamed) {
      int clusters = 0;
      cudaError_t rc = stream_clusters(&clusters);
      if (rc != cudaSuccess) return (int)rc;
      if (!make_map(&map1, f1, (int64_t)batch * rp1, cp, S_HALF) ||
          !make_map(&map2, f2, (int64_t)batch * rp2, cp, S_BN))
        return (int)cudaErrorInvalidValue;
      const int64_t total = (int64_t)batch * (rp1 / H_BM) * (rp2 / S_ROWS2);
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          stream_config(&attr, (int)(total < clusters ? total : clusters), s);
      rc = cudaLaunchKernelEx(&cfg, corr_pool_stream_kernel, map1, map2, (float*)out, batch,
                              np1, np2, rp1, rp2, cp);
      if (rc != cudaSuccess) return (int)rc;
    } else {
      cudaError_t rc = set_smem_once(h_smem_bytes(H_MAX_CP));
      if (rc != cudaSuccess) return (int)rc;
      if (!make_map(&map1, f1, (int64_t)batch * rp1, cp, H_BM) ||
          !make_map(&map2, f2, (int64_t)batch * rp2, cp, H_BN))
        return (int)cudaErrorInvalidValue;
      int dev = 0, sms = 0;
      rc = cudaGetDevice(&dev);
      if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (rc != cudaSuccess) return (int)rc;
      const int64_t total = (int64_t)batch * (rp1 / H_BM) * (rp2 / H_BN);
      const int grid = (int)(total < sms ? total : sms);
      corr_pool_bf16_kernel<<<grid, H_THREADS, h_smem_bytes(cp), s>>>(
          map1, map2, (float*)out, batch, np1, np2, rp1, rp2, cp);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

