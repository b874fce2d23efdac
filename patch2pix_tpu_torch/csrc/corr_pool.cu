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
// Bound on the H100: operations (2 * B * h1*w1 * h2*w2 * C of them;
// the inputs are a few MB and stay in L2). Design: a block owns a tile
// of 16*WM pooled cells of image 1 by 16 of image 2. Its feature rows are
// staged through shared memory in K-chunks, ordered (parity, pooled cell),
// so the raw product tile splits into 16x16 sub-tiles, one per
// (s1, s2) parity pair, that share one element layout. bf16 runs on the
// tensor cores (WMMA m16n16k16, f32 accumulation): warp (pi, s1) keeps
// four accumulators, one per s2, across the whole K loop; the pool is
// then an elementwise max of fragments, and a max across the four s1
// warps through shared memory. float32 runs on plain f32 FMA (never
// TF32): thread (ty, tx) accumulates exactly the 16 dot products of its
// pooled cell and takes their max. Sums are in another order than a
// matmul library's, so results agree with the plain version to rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int TP = 16;   // pooled cells per WMMA sub-tile side
constexpr int WM = 2;    // image-1 sub-tiles per block (bf16 kernel)
constexpr int KC = 64;   // channels per shared-memory stage (bf16)
constexpr int LDS = KC + 8;  // padded row stride (multiple of 8 for WMMA)

// Global row of the feature map for pooled cell p with window parity s
// (or -1 past the end), for a map of width w and pooled width wp.
__device__ __forceinline__ int64_t cell_row(int p, int s, int np, int wp, int w) {
  if (p >= np) return -1;
  const int i = p / wp, j = p % wp;
  return (int64_t)(2 * i + (s >> 1)) * w + 2 * j + (s & 1);
}

// Stage channels [k0, k0+KC) of `nrows` tile rows into shared memory.
// Row r is (sub-tile r / (4*TP), parity (r / TP) % 4, cell r % TP);
// rows past the map and channels past c are zero.
__device__ __forceinline__ void stage_rows_bf16(
    __nv_bfloat16 (*dst)[LDS], const __nv_bfloat16* __restrict__ base,
    int nrows, int tile0, int np, int wp, int w, int c, int k0, bool vec) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  if (vec) {
    // 16-byte loads: 8 channels per load; c % 8 == 0 keeps them aligned
    const int per_row = KC / 8;
    for (int e = tid; e < nrows * per_row; e += nthr) {
      const int r = e / per_row, k = (e % per_row) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      const int s = (r / TP) % 4;
      const int p = tile0 + (r / (4 * TP)) * TP + r % TP;
      const int64_t g = cell_row(p, s, np, wp, w);
      if (g >= 0 && k0 + k < c) {
        v = *reinterpret_cast<const uint4*>(base + g * c + k0 + k);
      }
      *reinterpret_cast<uint4*>(&dst[r][k]) = v;
    }
  } else {
    for (int e = tid; e < nrows * KC; e += nthr) {
      const int r = e / KC, k = e % KC;
      const int s = (r / TP) % 4;
      const int p = tile0 + (r / (4 * TP)) * TP + r % TP;
      const int64_t g = cell_row(p, s, np, wp, w);
      dst[r][k] = (g >= 0 && k0 + k < c) ? base[g * c + k0 + k]
                                          : __float2bfloat16(0.0f);
    }
  }
}

// Block = 4*WM warps; warp w owns image-1 sub-tile w / 4 and parity
// s1 = w % 4, against all four image-2 parities.
__global__ void __launch_bounds__(128 * WM)
corr_pool_bf16_kernel(const __nv_bfloat16* __restrict__ f1,
                      const __nv_bfloat16* __restrict__ f2,
                      float* __restrict__ out,
                      int h1, int w1, int h2, int w2, int c, int vec) {
  __shared__ __align__(128) __nv_bfloat16 As[4 * TP * WM][LDS];
  __shared__ __align__(128) __nv_bfloat16 Bs[4 * TP][LDS];
  __shared__ __align__(128) float Red[4 * WM][TP * TP];

  const int w1p = w1 / 2, w2p = w2 / 2;
  const int np1 = (h1 / 2) * w1p, np2 = (h2 / 2) * w2p;
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * TP * WM;
  const int q0 = blockIdx.x * TP;
  const __nv_bfloat16* a_base = f1 + (int64_t)b * h1 * w1 * c;
  const __nv_bfloat16* b_base = f2 + (int64_t)b * h2 * w2 * c;
  const int warp = threadIdx.x / 32;
  const int pi = warp / 4, s1 = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int s2 = 0; s2 < 4; ++s2) wmma::fill_fragment(acc[s2], 0.0f);

  for (int k0 = 0; k0 < c; k0 += KC) {
    stage_rows_bf16(As, a_base, 4 * TP * WM, p0, np1, w1p, w1, c, k0, vec);
    stage_rows_bf16(Bs, b_base, 4 * TP, q0, np2, w2p, w2, c, k0, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &As[(pi * 4 + s1) * TP][kk], LDS);
#pragma unroll
      for (int s2 = 0; s2 < 4; ++s2) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, &Bs[s2 * TP][kk], LDS);
        wmma::mma_sync(acc[s2], fa, fb, acc[s2]);
      }
    }
    __syncthreads();
  }

  // pool over s2 in registers (same element layout in every fragment)
#pragma unroll
  for (int e = 0; e < acc[0].num_elements; ++e) {
    acc[0].x[e] = fmaxf(fmaxf(acc[0].x[e], acc[1].x[e]),
                        fmaxf(acc[2].x[e], acc[3].x[e]));
  }
  wmma::store_matrix_sync(Red[warp], acc[0], TP, wmma::mem_row_major);
  __syncthreads();
  // pool over s1 across the four warps of each image-1 sub-tile
  for (int e = threadIdx.x; e < WM * TP * TP; e += blockDim.x) {
    const int sub = e / (TP * TP), cell = e % (TP * TP);
    const float* r = &Red[sub * 4][cell];
    const float v = fmaxf(fmaxf(r[0], r[TP * TP]), fmaxf(r[2 * TP * TP], r[3 * TP * TP]));
    const int p = p0 + sub * TP + cell / TP, q = q0 + cell % TP;
    if (p < np1 && q < np2) out[((int64_t)b * np1 + p) * np2 + q] = v;
  }
}

constexpr int KF = 16;  // channels per stage (f32)

__global__ void __launch_bounds__(256)
corr_pool_f32_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                     float* __restrict__ out,
                     int h1, int w1, int h2, int w2, int c) {
  __shared__ float As[KF][4 * TP + 1];
  __shared__ float Bs[KF][4 * TP + 1];
  const int w1p = w1 / 2, w2p = w2 / 2;
  const int np1 = (h1 / 2) * w1p, np2 = (h2 / 2) * w2p;
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * TP, q0 = blockIdx.x * TP;
  const float* a_base = f1 + (int64_t)b * h1 * w1 * c;
  const float* b_base = f2 + (int64_t)b * h2 * w2 * c;
  const int tx = threadIdx.x % TP, ty = threadIdx.x / TP;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < c; k0 += KF) {
    for (int e = threadIdx.x; e < 4 * TP * KF; e += blockDim.x) {
      const int r = e / KF, k = e % KF;  // row (parity, cell), channel
      const int s = r / TP;
      const int64_t ga = cell_row(p0 + r % TP, s, np1, w1p, w1);
      const int64_t gb = cell_row(q0 + r % TP, s, np2, w2p, w2);
      As[k][r] = (ga >= 0 && k0 + k < c) ? a_base[ga * c + k0 + k] : 0.0f;
      Bs[k][r] = (gb >= 0 && k0 + k < c) ? b_base[gb * c + k0 + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KF; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        a[s] = As[k][s * TP + ty];
        bv[s] = Bs[k][s * TP + tx];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float m = acc[0][0];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) m = fmaxf(m, acc[i][j]);
  const int p = p0 + ty, q = q0 + tx;
  if (p < np1 && q < np2) out[((int64_t)b * np1 + p) * np2 + q] = m;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int p2p_corr_pool(const void* f1, const void* f2, void* out,
                             int batch, int h1, int w1, int h2, int w2, int c,
                             int dtype, void* stream) {
  if (batch <= 0 || c <= 0 || (h1 | w1 | h2 | w2) & 1) return (int)cudaErrorInvalidValue;
  const int np1 = (h1 / 2) * (w1 / 2), np2 = (h2 / 2) * (w2 / 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    dim3 grid((np2 + TP - 1) / TP, (np1 + TP * WM - 1) / (TP * WM), batch);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    corr_pool_bf16_kernel<<<grid, 128 * WM, 0, s>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2, (float*)out,
        h1, w1, h2, w2, c, (c % 8) == 0);
  } else if (dtype == 0) {
    dim3 grid((np2 + TP - 1) / TP, (np1 + TP - 1) / TP, batch);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    corr_pool_f32_kernel<<<grid, 256, 0, s>>>(
        (const float*)f1, (const float*)f2, (float*)out, h1, w1, h2, w2, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
