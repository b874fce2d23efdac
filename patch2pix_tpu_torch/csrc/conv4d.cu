// B4: direct SAME 3^4 conv4d for small channel counts.
//
// Replaces patch2pix_tpu/ops/conv4d_pallas.py conv4d_pallas
// (_conv4d_pallas_impl / _make_kernel). For x (B, h1, w1, h2, w2, CIN) and
// w (3, 3, 3, 3, CIN, COUT), with zero padding:
//
//   out[b,i,j,k,l,co] = bias[co] + sum_{di,dj,dk,dl,ci}
//       x[b, i+di-1, j+dj-1, k+dk-1, l+dl-1, ci] * w[di,dj,dk,dl,ci,co]
//
// The filter arrives rounded to x's type and widened to float32; every
// product and sum is float32 (fmaf in (di, dj, dl, ci, dk) order), then the
// bias, then one rounding to the output type. The Pallas kernel's layout
// choices (w2 padded to 128 lanes, h2 to a sublane tile, 27 shift panels)
// are TPU facts and are gone.
//
// Layout: the flat cell n = (b*h1 + i)*w1 + j has one (h2, w2, CIN) plane.
// The input is read through element strides (n, ci, k, l), so both the
// 6D channels-last volume and the NCHW view (n, ci, k, l) that the NCN's
// cuDNN fold-in conv leaves behind are taken without a copy. The output is
// written NCHW (n, co, k, l), the layout the next fold-out conv reads.
//
// Bound on the H100: operations, 81 * CIN * COUT FMAs per output cell on
// the f32 pipes (2 * 81 * 16 = 2592 flops per cell at 4->4, ~49 GFLOP for
// the change_stride volume) against a few hundred MB of traffic. Design:
// one block per (cell n, 16 x 32 tile of (k, l)); each thread keeps the
// COUT sums of R = 4 cells of one l column in registers (CIN and COUT are
// template parameters). For each of the nine outer taps (di, dj) whose
// source cell is inside the grid (the test is uniform over the block), the
// 18 x 34 input halo of the source plane is staged through shared memory,
// planar per channel so that a warp reads 32 consecutive words; the
// filter sits in shared memory and every warp reads the same word (a
// broadcast). Shared-memory loads, not FMAs, limit a one-cell-per-thread
// version (a filter load per FMA): here a column of R + 2 inputs serves
// three dk taps and each filter word R cells.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 16, TW = 32;  // output tile (k, l) per block
constexpr int R = 4;             // cells per thread, consecutive in k
constexpr int NT = TW * TH / R;  // threads per block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

struct Shape {
  int h1, w1, h2, w2, tiles_x, tiles;
  int64_t sn, sc, sk, sl;  // input element strides of (n, ci, k, l)
};

template <typename T, typename O, int CIN, int COUT>
__global__ void __launch_bounds__(NT)
conv4d_small_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, O* __restrict__ out, Shape s) {
  __shared__ float ws[81 * CIN * COUT];
  __shared__ float xs[CIN][TH + 2][TW + 2];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % s.tiles;
  const int64_t n = blockIdx.x / s.tiles;
  const int j = (int)(n % s.w1), i = (int)((n / s.w1) % s.h1);
  const int k0 = (tile / s.tiles_x) * TH, l0 = (tile % s.tiles_x) * TW;
  const int r0 = (tid / TW) * R, tx = tid % TW;

  for (int e = tid; e < 81 * CIN * COUT; e += NT) ws[e] = w[e];

  float acc[R][COUT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[r][co] = 0.0f;

  constexpr int HALO = CIN * (TH + 2) * (TW + 2);
  for (int di = 0; di < 3; ++di) {
    if (i + di - 1 < 0 || i + di - 1 >= s.h1) continue;
    for (int dj = 0; dj < 3; ++dj) {
      if (j + dj - 1 < 0 || j + dj - 1 >= s.w1) continue;
      const T* src = x + (n + (int64_t)(di - 1) * s.w1 + (dj - 1)) * s.sn;
      __syncthreads();  // the previous tap's reads are done (and ws is loaded)
      for (int e = tid; e < HALO; e += NT) {
        int ci, r, c;
        if (s.sc == 1) {  // channels innermost in memory: ci fastest
          ci = e % CIN;
          c = (e / CIN) % (TW + 2);
          r = e / (CIN * (TW + 2));
        } else {          // planar input: l fastest
          c = e % (TW + 2);
          r = (e / (TW + 2)) % (TH + 2);
          ci = e / ((TW + 2) * (TH + 2));
        }
        const int gk = k0 + r - 1, gl = l0 + c - 1;
        xs[ci][r][c] = (gk >= 0 && gk < s.h2 && gl >= 0 && gl < s.w2)
                           ? widen(src[ci * s.sc + gk * s.sk + gl * s.sl])
                           : 0.0f;
      }
      __syncthreads();
      const float* wt = ws + (di * 3 + dj) * 9 * CIN * COUT;
#pragma unroll
      for (int dl = 0; dl < 3; ++dl) {
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          float xv[R + 2];
#pragma unroll
          for (int r = 0; r < R + 2; ++r) xv[r] = xs[ci][r0 + r][tx + dl];
#pragma unroll
          for (int dk = 0; dk < 3; ++dk) {
            const float* wr = wt + ((dk * 3 + dl) * CIN + ci) * COUT;
#pragma unroll
            for (int co = 0; co < COUT; ++co) {
              const float wv = wr[co];
#pragma unroll
              for (int r = 0; r < R; ++r) acc[r][co] = fmaf(xv[r + dk], wv, acc[r][co]);
            }
          }
        }
      }
    }
  }
  const int l = l0 + tx;
  const int64_t plane = (int64_t)s.h2 * s.w2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = k0 + r0 + r;
    if (k < s.h2 && l < s.w2) {
      O* o = out + n * COUT * plane + (int64_t)k * s.w2 + l;
#pragma unroll
      for (int co = 0; co < COUT; ++co) narrow(__fadd_rn(acc[r][co], bias[co]), o + co * plane);
    }
  }
}

template <typename T, typename O, int CIN, int COUT>
cudaError_t launch(const void* x, const float* w, const float* bias, void* out,
                   int64_t cells, const Shape& s, cudaStream_t st) {
  conv4d_small_kernel<T, O, CIN, COUT><<<(unsigned)(cells * s.tiles), NT, 0, st>>>(
      (const T*)x, w, bias, (O*)out, s);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t dispatch(int cin, int cout, const void* x, const float* w, const float* bias,
                     void* out, int64_t cells, const Shape& s, cudaStream_t st) {
#define P2P_CASE(CI, CO) \
  if (cin == CI && cout == CO) return launch<T, O, CI, CO>(x, w, bias, out, cells, s, st);
  P2P_CASE(3, 3) P2P_CASE(3, 4) P2P_CASE(3, 5) P2P_CASE(4, 3) P2P_CASE(4, 4) P2P_CASE(5, 3)
#undef P2P_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x: input read at element offset n*sn + ci*sc + k*sk + l*sl for flat
// cell n = (b*h1 + i)*w1 + j; w: (3,3,3,3,cin,cout) float32 contiguous;
// bias: (cout,) float32; out: (B*h1*w1, cout, h2, w2) contiguous. cin and
// cout > 2 with cin*cout <= 16. dtype/odtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
extern "C" int p2p_conv4d_small(const void* x, const void* w, const void* bias, void* out,
                                int batch, int h1, int w1, int h2, int w2, int cin,
                                int cout, long long sn, long long sc, long long sk,
                                long long sl, int dtype, int odtype, void* stream) {
  if (batch <= 0 || h1 <= 0 || w1 <= 0 || h2 <= 0 || w2 <= 0) return (int)cudaErrorInvalidValue;
  Shape s;
  s.h1 = h1;
  s.w1 = w1;
  s.h2 = h2;
  s.w2 = w2;
  s.tiles_x = (w2 + TW - 1) / TW;
  s.tiles = s.tiles_x * ((h2 + TH - 1) / TH);
  s.sn = sn;
  s.sc = sc;
  s.sk = sk;
  s.sl = sl;
  const int64_t cells = (int64_t)batch * h1 * w1;
  if (cells * s.tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && odtype == 1)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(cin, cout, x, wf, bf, out, cells, s, st);
  if (dtype == 1 && odtype == 0)
    return (int)dispatch<__nv_bfloat16, float>(cin, cout, x, wf, bf, out, cells, s, st);
  if (dtype == 0 && odtype == 1)
    return (int)dispatch<float, __nv_bfloat16>(cin, cout, x, wf, bf, out, cells, s, st);
  if (dtype == 0 && odtype == 0)
    return (int)dispatch<float, float>(cin, cout, x, wf, bf, out, cells, s, st);
  return (int)cudaErrorInvalidValue;
}
