// B1: the outer-tap masked shift-add of the NCN's fold-out conv4d.
//
// Replaces patch2pix_tpu/ops/tap_sum_pallas.py tap_sum_pallas_t (v2)
// and tap_sum_pallas (v1), which compute the same function:
//
//   out[f, col] = bias[col / hw] + sum_{t<9} mask_t(f) * z[f + s_t, t, col]
//
// over the flat cell index f = (b*h1 + i)*w1 + j, with s_t the flat
// shift (di-1)*w1 + (dj-1) of outer tap t = di*3 + dj and mask_t(f) true
// iff (i+di-1, j+dj-1) lies inside the h1 x w1 grid. z is the fold-out
// 2D conv's NCHW output, (N, 9*cout, h2, w2) viewed as (N, 9, m) with
// m = cout*hw; out is (N, m) float32.
//
// Exactness: each z value is widened to f32, the nine taps are added in
// tap order 0..8 (a masked tap adds 0), then the bias; the same adds as
// the plain version, so the result is bit-identical to it.
//
// Bound on the H100: memory. The kernel reads z once from DRAM (each
// row is re-read by the nine output rows it feeds, which the L2 serves:
// the rows live within 2*w1+3 of each other) and writes out once. Its
// design: one block row per output cell f, threads along the contiguous
// m axis, so every tap read and the store are coalesced; the masks are
// computed from f in registers, and a masked tap reads nothing, so z
// needs no padding rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void tap_sum_kernel(const T* __restrict__ z,
                               const float* __restrict__ bias,
                               float* __restrict__ out,
                               int m, int h1, int w1, int hw) {
  const int f = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= m) return;
  const int i = (f / w1) % h1;
  const int j = f % w1;
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int di = t / 3 - 1;
    const int dj = t % 3 - 1;
    float v = 0.0f;
    if (i + di >= 0 && i + di < h1 && j + dj >= 0 && j + dj < w1) {
      const int64_t src = (int64_t)f + di * w1 + dj;
      v = widen(z[(src * 9 + t) * m + col]);
    }
    acc = __fadd_rn(acc, v);
  }
  out[(int64_t)f * m + col] = __fadd_rn(acc, bias[col / hw]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int p2p_tap_sum(const void* z, const void* bias, void* out,
                           int n, int m, int h1, int w1, int hw, int dtype,
                           void* stream) {
  const int threads = 256;
  const int col_blocks = (m + threads - 1) / threads;
  if (n <= 0 || m <= 0 || col_blocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(n, col_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    tap_sum_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (const __nv_bfloat16*)z, (const float*)bias, (float*)out, m, h1, w1, hw);
  } else if (dtype == 0) {
    tap_sum_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)z, (const float*)bias, (float*)out, m, h1, w1, hw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
