// B3: superblock-row window expansion + cross-level hypercolumn
// normalisation + scaling, for both sides of each proposal pair.
//
// Replaces patch2pix_tpu/ops/patch_expand_pallas.py
// expand_scale_pair_pallas (_pallas_impl / _kernel). Per pyramid level l
// (tile side t, channels c, stride ds = psize / t) and side, the input
// rows are (M, 4, t, t*c): the 2x2 superblock of space-to-depth tiles
// around the proposal. For the psize x psize patch pixel (p, q) of
// proposal m with padded corner (y0, x0):
//
//   iy = (y0 + p) / ds - (y0 / psize) * t     (ix likewise from x0, q)
//   e_l[c'] = rows_l[m, (iy/t)*2 + ix/t, iy % t, (ix % t)*c + c']
//   sq = sum_l sum_c' e_l[c']^2      (f32; per level in channel order,
//                                     levels added in pyramid order)
//   inv = round_to_out(rsqrt(sq + 1e-6))
//   out_l[m, p, q, c'] = round_to_out(f32(e_l[c']) * f32(inv))
//
// Every level, the 3-channel image level included, is done here. A
// level's output is either channel-paired (side 1 in channels [0, c),
// side 2 in [c, 2c) of one tensor) or one tensor per side; the caller
// passes each side's output pointer and the output row stride.
//
// Bound on the H100: memory (the rows are read once, the scaled
// patches written once; the patches are 2.7x the rows). Design: one
// block per (proposal, side). Phase 1 gives one thread per patch pixel
// its square-sum; the inverse norms go to shared memory. Phase 2 walks
// each level's output with consecutive threads on consecutive channels,
// so both the row reads and the patch writes are coalesced. The window
// selection is plain indexed reads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;

struct Level {
  const void* rows[2];  // per side: (M, 4, t, t*c)
  void* out[2];         // per side: first channel of the side's output
  int t, c, ostride;    // tile side, channels, output elements per pixel
};

struct Args {
  Level lv[MAX_LEVELS];
  const int* y[2];
  const int* x[2];
  int n_levels, psize;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Offset of pixel (p, q)'s channel 0 inside proposal m's level rows.
__device__ __forceinline__ int64_t pixel_offset(int m, int p, int q, int y0, int x0,
                                                int psize, int t, int c) {
  const int ds = psize / t;
  const int iy = (y0 + p) / ds - (y0 / psize) * t;
  const int ix = (x0 + q) / ds - (x0 / psize) * t;
  const int tile = (iy / t) * 2 + ix / t;
  return ((((int64_t)m * 4 + tile) * t + iy % t) * t + ix % t) * c;
}

template <typename T>
__global__ void __launch_bounds__(256) expand_kernel(Args a) {
  extern __shared__ float inv_s[];  // psize*psize inverse norms
  const int m = blockIdx.x, side = blockIdx.y;
  const int psize = a.psize, npix = psize * psize;
  // a negative corner counts as 0 (the gather clips corners at 0), so
  // every read stays inside the proposal's rows
  const int y0 = max(a.y[side][m], 0), x0 = max(a.x[side][m], 0);

  for (int pix = threadIdx.x; pix < npix; pix += blockDim.x) {
    const int p = pix / psize, q = pix % psize;
    float sq = 0.0f;
    for (int l = 0; l < a.n_levels; ++l) {
      const Level& L = a.lv[l];
      const T* src = (const T*)L.rows[side] + pixel_offset(m, p, q, y0, x0, psize, L.t, L.c);
      float s = 0.0f;
      for (int k = 0; k < L.c; ++k) {
        const float v = widen(src[k]);
        s = __fadd_rn(s, __fmul_rn(v, v));
      }
      sq = l == 0 ? s : __fadd_rn(sq, s);
    }
    inv_s[pix] = round_to(rsqrtf(__fadd_rn(sq, 1e-6f)), (T*)nullptr);
  }
  __syncthreads();

  for (int l = 0; l < a.n_levels; ++l) {
    const Level& L = a.lv[l];
    const T* rows = (const T*)L.rows[side];
    T* out = (T*)L.out[side];
    const int c = L.c;
    for (int e = threadIdx.x; e < npix * c; e += blockDim.x) {
      const int pix = e / c, k = e % c;
      const int p = pix / psize, q = pix % psize;
      const float v = widen(rows[pixel_offset(m, p, q, y0, x0, psize, L.t, c) + k]);
      narrow(__fmul_rn(v, inv_s[pix]),
             out + ((int64_t)m * npix + pix) * L.ostride + k);
    }
  }
}

}  // namespace

// rows1/rows2/out1/out2: per-level pointer arrays; t, c, ostride:
// per-level ints; y1, x1, y2, x2: (M,) int32 padded corners on the
// device. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int p2p_patch_expand(const void* const* rows1, const void* const* rows2,
                                void* const* out1, void* const* out2,
                                const int* t, const int* c, const int* ostride,
                                int n_levels, const void* y1, const void* x1,
                                const void* y2, const void* x2, int m, int psize,
                                int dtype, void* stream) {
  if (n_levels <= 0 || n_levels > MAX_LEVELS || m <= 0 || psize <= 0 ||
      psize * psize > 4096) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  for (int l = 0; l < n_levels; ++l) {
    if (t[l] <= 0 || psize % t[l] != 0) return (int)cudaErrorInvalidValue;
    a.lv[l].rows[0] = rows1[l];
    a.lv[l].rows[1] = rows2[l];
    a.lv[l].out[0] = out1[l];
    a.lv[l].out[1] = out2[l];
    a.lv[l].t = t[l];
    a.lv[l].c = c[l];
    a.lv[l].ostride = ostride[l];
  }
  a.y[0] = (const int*)y1;
  a.x[0] = (const int*)x1;
  a.y[1] = (const int*)y2;
  a.x[1] = (const int*)x2;
  a.n_levels = n_levels;
  a.psize = psize;
  dim3 grid(m, 2);
  const size_t smem = sizeof(float) * psize * psize;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    expand_kernel<__nv_bfloat16><<<grid, 256, smem, s>>>(a);
  } else if (dtype == 0) {
    expand_kernel<float><<<grid, 256, smem, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
