// B3: superblock-row window expansion + cross-level hypercolumn
// normalisation + scaling, for both sides of each proposal pair; and B7,
// the one-level, one-sided, unscaled expansion.
//
// B3 replaces patch2pix_tpu/ops/patch_expand_pallas.py
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
// side 2 in [c, 2c) of one tensor) or one tensor per side.
//
// Bound on the H100: memory. A call reads each side's window cells (at
// most (t+1)^2 cells of c values a level: 8,704 values a proposal side
// at the main path's levels) and writes the scaled patches (npix * 259
// values a side there, 30x the window), at 3.35 TB/s; the operations are
// a few per output value. So the design spends its instructions on the
// writes. One block per proposal does both sides, so a channel-paired
// pixel row is written whole by one block:
//   1. the window's first cell on each axis and, per patch row and
//      column, the window cell it reads (tables in shared memory);
//   2. every level's and side's window, (t+1)^2 cells (t^2 where ds = 1),
//      staged in shared memory once with 16-byte cp.async copies (element
//      copies where a cell is not a whole number of 16-byte units);
//   3. each staged cell's square-sum, once, in channel order (the first
//      version summed a cell again for each of its ds^2 pixels);
//   4. per pixel and side, the levels' cell sums in pyramid order, then
//      inv, in shared memory;
//   5. the writes: each thread scales and stores 16 bytes of one pixel's
//      channels (one uint4 load from the window, one uint4 store); a level
//      whose cell is not a whole number of 16-byte units (the C=3 image
//      level) is written as flat 16-byte runs of its per-side output.
// The window cell stride is padded to an odd number of 16-byte units, so
// that threads summing neighbouring cells read distinct banks. Divisions
// by runtime sizes are multiply-shifts whose constants the wrapper plans
// (ops/patch_expand.py plan). The shared memory a block takes (44.6 KB
// in bf16, 79.4 KB in f32 at the main path's levels) is planned there too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may take on sm_90

// x / d for 0 <= x < 2^31 as (umulhi(x, m) + x) >> s
struct FastDiv {
  uint32_t m, s;
};

// B3's launch plan for one level. ops/patch_expand.py _Level mirrors the
// layout and fills it.
struct Level {
  const void* rows[2];    // per side: (M, 4, t, t*c)
  void* out[2];           // per side: first channel of the side's output
  int32_t t, c, ostride;  // tile side, channels, output elements per pixel
  int32_t w;              // staged window side in cells: t + 1, or t where ds = 1
  int32_t cstride;        // staged elements per cell
  int32_t win[2];         // per side: byte offset of the staged window
  int32_t sq[2];          // per side: float offset of its cells' square-sums
  int32_t vec;            // c * elsize % 16 == 0: cells move in 16-byte chunks
  FastDiv by_w, by_chunks, by_c, by_pixel_chunks;  // w, c / V, c, 2c / V
};

struct Args {
  Level lv[MAX_LEVELS];
  const int32_t* y[2];  // per side: (M,) padded corners
  const int32_t* x[2];
  int32_t n_levels, psize, m, elsize;
  FastDiv by_psize;
  int32_t inv_off, tab_off, geo_off, smem;  // shared-memory layout, bytes
};

__device__ __forceinline__ int fdiv(int x, FastDiv f) {
  return (int)((__umulhi((uint32_t)x, f.m) + (uint32_t)x) >> f.s);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes <-> 4 floats or 8 bf16 values widened to float
__device__ __forceinline__ void unpack(uint4 u, float* f, float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* f, __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *(const uint32_t*)&v;
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16*) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS) expand_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);  // values per 16-byte chunk
  const int m = blockIdx.x, tid = threadIdx.x;
  const int psize = a.psize, npix = psize * psize, nl = a.n_levels;
  float* inv_s = (float*)(smem + a.inv_off);  // [side][pixel]
  // [side][level][axis][psize]: the window cell of each patch row (times
  // the window side) and column
  int* tab = (int*)(smem + a.tab_off);
  int* geo = (int*)(smem + a.geo_off);  // [side][level][axis]: first window cell

  // 1. window geometry; a negative corner counts as 0 (the gather clips
  // corners at 0), so every read stays inside the proposal's rows
  for (int i = tid; i < 4 * nl * psize; i += THREADS) {
    const int k = i / psize, d = i - k * psize;
    const int axis = k & 1, l = (k >> 1) % nl, side = (k >> 1) / nl;
    const Level& lv = a.lv[l];
    const int base = max((axis ? a.x[side] : a.y[side])[m], 0);
    const int ds = psize / lv.t, r = base % psize, w0 = r / ds;
    const int cell = (r + d) / ds - w0;
    tab[i] = axis ? cell : cell * lv.w;
    if (d == 0) geo[k] = w0;
  }
  __syncthreads();

  // 2. stage every level's and side's window
  for (int l = 0; l < nl; ++l) {
    const Level& lv = a.lv[l];
    const int t = lv.t, c = lv.c, w = lv.w;
    const bool vec = lv.vec && (((uintptr_t)lv.rows[0] | (uintptr_t)lv.rows[1]) & 15) == 0;
    const int per_cell = vec ? c / V : c;
    for (int side = 0; side < 2; ++side) {
      const T* rows = (const T*)lv.rows[side] + (int64_t)m * 4 * t * t * c;
      T* win = (T*)(smem + lv.win[side]);
      const int wy0 = geo[(side * nl + l) * 2], wx0 = geo[(side * nl + l) * 2 + 1];
      for (int u = tid; u < w * w * per_cell; u += THREADS) {
        const int cell = fdiv(u, vec ? lv.by_chunks : lv.by_c);
        const int k = (u - cell * per_cell) * (vec ? V : 1);
        const int wy = fdiv(cell, lv.by_w), wx = cell - wy * w;
        const int y = wy0 + wy, x = wx0 + wx, ty = y >= t, tx = x >= t;
        const T* src = rows + (((ty * 2 + tx) * t + y - ty * t) * t + x - tx * t) * c + k;
        T* dst = win + cell * lv.cstride + k;
        if (vec) {
          cp_async16(dst, src);
        } else {
          *dst = *src;
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. each staged cell's square-sum, in channel order. Cells are dealt
  // out in one count over levels and sides, so the long cells of the
  // wide levels fall to different threads.
  int first = 0;
  for (int l = 0; l < nl; ++l) {
    const Level& lv = a.lv[l];
    const int n = lv.w * lv.w;
    for (int side = 0; side < 2; ++side, first += n) {
      const T* win = (const T*)(smem + lv.win[side]);
      float* sq = (float*)smem + lv.sq[side];
      for (int cell = (tid + THREADS - first % THREADS) % THREADS; cell < n; cell += THREADS) {
        const T* e = win + cell * lv.cstride;
        float s = 0.0f;
        if (lv.vec) {
          for (int k = 0; k < lv.c; k += V) {
            float f[V];
            unpack(*(const uint4*)(e + k), f, (T*)nullptr);
#pragma unroll
            for (int j = 0; j < V; ++j) s = __fadd_rn(s, __fmul_rn(f[j], f[j]));
          }
        } else {
          for (int k = 0; k < lv.c; ++k) {
            const float v = widen(e[k]);
            s = __fadd_rn(s, __fmul_rn(v, v));
          }
        }
        sq[cell] = s;
      }
    }
  }
  __syncthreads();

  // 4. per pixel and side: the levels' sums in pyramid order, then inv
  for (int i = tid; i < 2 * npix; i += THREADS) {
    const int side = i >= npix, pix = i - side * npix;
    const int p = fdiv(pix, a.by_psize), q = pix - p * psize;
    float sq = 0.0f;
    for (int l = 0; l < nl; ++l) {
      const int* tb = tab + (side * nl + l) * 2 * psize;
      const float s = ((const float*)smem + a.lv[l].sq[side])[tb[p] + tb[psize + q]];
      sq = l == 0 ? s : __fadd_rn(sq, s);
    }
    inv_s[i] = round_to(rsqrtf(__fadd_rn(sq, 1e-6f)), (T*)nullptr);
  }
  __syncthreads();

  // 5. the scaled patches
  for (int l = 0; l < nl; ++l) {
    const Level& lv = a.lv[l];
    const int c = lv.c;
    // the staged window cell that pixel pix of one side reads
    auto cell_of = [&](int side, int pix) {
      const int p = fdiv(pix, a.by_psize), q = pix - p * psize;
      const int* tb = tab + (side * nl + l) * 2 * psize;
      return (const T*)(smem + lv.win[side]) + (tb[p] + tb[psize + q]) * lv.cstride;
    };
    auto scaled = [&](int side, int pix, int ch) {
      return __fmul_rn(widen(cell_of(side, pix)[ch]), inv_s[side * npix + pix]);
    };
    if (lv.vec) {
      // chunk k: 16 bytes of pixel k / (2c/V), side 1's chunks then side 2's
      const int chunks = c / V, per_pix = 2 * chunks;
      for (int k = tid; k < npix * per_pix; k += THREADS) {
        const int pix = fdiv(k, lv.by_pixel_chunks), j = k - pix * per_pix;
        const int side = j >= chunks, ch = (j - side * chunks) * V;
        const float iv = inv_s[side * npix + pix];
        float f[V];
        unpack(*(const uint4*)(cell_of(side, pix) + ch), f, (T*)nullptr);
#pragma unroll
        for (int j2 = 0; j2 < V; ++j2) f[j2] = __fmul_rn(f[j2], iv);
        *(uint4*)((T*)lv.out[side] + ((int64_t)m * npix + pix) * lv.ostride + ch) =
            pack(f, (T*)nullptr);
      }
    } else {
      // a per-side output (ostride == c): the proposal's npix * c values
      // are one flat run, written in 16-byte chunks between an unaligned
      // head and tail of single values
      const int len = npix * c;
      for (int side = 0; side < 2; ++side) {
        T* out = (T*)lv.out[side] + (int64_t)m * len;
        const int head = min(len, (int)(((16 - ((uintptr_t)out & 15)) & 15) / sizeof(T)));
        const int chunks = (len - head) / V, tail = head + chunks * V;
        for (int k = tid; k < chunks; k += THREADS) {
          const int e0 = head + k * V;
          int pix = fdiv(e0, lv.by_c), ch = e0 - pix * c;
          float f[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            f[j] = scaled(side, pix, ch);
            if (++ch == c) {
              ch = 0;
              ++pix;
            }
          }
          *(uint4*)(out + e0) = pack(f, (T*)nullptr);
        }
        for (int k = tid; k < head + len - tail; k += THREADS) {
          const int e = k < head ? k : tail + k - head;
          const int pix = fdiv(e, lv.by_c);
          narrow(scaled(side, pix, e - pix * c), out + e);
        }
      }
    }
  }
}

// B7: replaces tools/try_expand_kernels.py build (and the function of
// patch_expand_pallas.py _xla_expand_side): out[m, p, q, :] = the window
// cell of pixel (p, q) in one level's rows, a pure copy in the rows'
// type (the copy is type-blind: T is a 2- or 4-byte word).
//
// Bound on the H100: memory, by the writes. A proposal reads a window of
// (t+1)^2 cells (t^2 where ds = 1) and writes psize^2 pixels, 3-28x the
// window at the main path's levels; the ds^2 re-reads of a cell hit L1.
// So the kernel spends its instructions on 16-byte stores:
//   1. per proposal, two tables in shared memory: for each patch row p the
//      element offset of its cell row (tile row, iy % t), for each column q
//      that of its cell column (tile column, ix % t); a pixel's cell starts
//      at rows_m + rt[p] + ct[q];
//   2. where a cell is a whole number of 16-byte units (and the rows are
//      16-byte aligned), each thread moves one unit: one read-only uint4
//      load, one uint4 store, four units in flight;
//   3. otherwise (C = 1 in float32, C = 3 in bf16: the fine-stage prolog's
//      levels) each thread gathers the values of one flat 16-byte run of
//      the proposal's output by table lookups, stepping (p, q, channel)
//      without division, and stores one uint4; an unaligned head and tail
//      go a value at a time.
// Divisions by runtime sizes are multiply-shifts whose constants the
// wrapper plans (ops/patch_expand.py level_plan); there are two per
// 16-byte store and none per value. A block is 256 threads: one proposal,
// or per_block proposals (one row of threads each) where a proposal's
// output is smaller than the block's stores.
struct LevelPlan {
  int32_t psize, t, c;
  int32_t vec;        // move whole cells in 16-byte units
  int32_t per_block;  // proposals a block (blockDim.y)
  int32_t per_pixel;  // work items a pixel: its 16-byte units (vec) or its c values
  FastDiv by_psize, by_ds, by_pixel, by_row;  // psize, psize / t, per_pixel, psize * per_pixel
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
expand_level_kernel(const T* __restrict__ rows, const int* __restrict__ ys,
                    const int* __restrict__ xs, T* __restrict__ out, int m_total,
                    const __grid_constant__ LevelPlan pl) {
  extern __shared__ int tabs[];  // [proposal][row, column][psize]: element offsets
  constexpr int V = 16 / sizeof(T);  // values per 16-byte unit
  constexpr int UNROLL = 4;
  const int psize = pl.psize, t = pl.t, c = pl.c, tid = threadIdx.x, nt = blockDim.x;
  const int m = blockIdx.x * pl.per_block + threadIdx.y;
  int* rt = tabs + threadIdx.y * 2 * psize;
  const int* ct = rt + psize;

  // 1. the tables; a negative corner counts as 0. Cell (r + d) / ds of the
  // 2t x 2t superblock, r = corner % psize, is in tile (hi) and cell (lo)
  if (m < m_total) {
    for (int i = tid; i < 2 * psize; i += nt) {
      const int axis = i >= psize, d = i - axis * psize;
      const int base = max((axis ? xs : ys)[m], 0);
      const int cell = fdiv(base - fdiv(base, pl.by_psize) * psize + d, pl.by_ds);
      const int hi = cell >= t, lo = cell - hi * t;
      rt[i] = axis ? (hi * t * t + lo) * c : (2 * hi * t + lo) * t * c;
    }
  }
  __syncthreads();
  if (m >= m_total) return;
  const T* src = rows + (int64_t)m * 4 * t * t * c;
  const int row = psize * pl.per_pixel;  // work items a patch row

  if (pl.vec) {
    // 2. unit k of the proposal's output: pixel (p, q), unit j of its cell
    const int n = psize * row;
    uint4* dst = (uint4*)(out + (int64_t)m * psize * psize * c);
    for (int k0 = tid; k0 < n; k0 += UNROLL * nt) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = k0 + u * nt;
        if (k < n) {
          const int p = fdiv(k, pl.by_row), r = k - p * row;
          const int q = fdiv(r, pl.by_pixel), j = r - q * pl.per_pixel;
          v[u] = __ldg((const uint4*)(src + rt[p] + ct[q]) + j);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k0 + u * nt < n) dst[k0 + u * nt] = v[u];
      }
    }
    return;
  }

  // 3. flat 16-byte runs of the proposal's psize^2 * c values
  const int len = psize * row;
  T* dst = out + (int64_t)m * len;
  const int head = min(len, (int)(((16 - ((uintptr_t)dst & 15)) & 15) / sizeof(T)));
  const int chunks = (len - head) / V, tail = head + chunks * V;
  for (int k = tid; k < chunks; k += nt) {
    const int e0 = head + k * V;
    int p = fdiv(e0, pl.by_row);
    const int r = e0 - p * row;
    int q = fdiv(r, pl.by_pixel), ch = r - q * c;
    union {
      uint4 u;
      T e[V];
    } v;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v.e[j] = __ldg(src + rt[p] + ct[q] + ch);
      if (++ch == c) {
        ch = 0;
        if (++q == psize) {
          q = 0;
          ++p;
        }
      }
    }
    *(uint4*)(dst + e0) = v.u;
  }
  for (int k = tid; k < head + len - tail; k += nt) {
    const int e = k < head ? k : tail + k - head;
    const int p = fdiv(e, pl.by_row), r = e - p * row;
    const int q = fdiv(r, pl.by_pixel);
    dst[e] = __ldg(src + rt[p] + ct[q] + r - q * c);
  }
}

template <typename T>
const void* level_kernel() {
  return (const void*)expand_level_kernel<T>;
}

}  // namespace

// The size of B7's LevelPlan, which the wrapper checks its mirror against.
extern "C" int p2p_expand_level_plan_size() { return (int)sizeof(LevelPlan); }

// B7. plan: a LevelPlan (ops/patch_expand.py level_plan); rows: (M, 4, t,
// t*c); y0, x0: (M,) int32 padded corners; out: (M, psize, psize, c);
// elsize: bytes per element, 2 or 4. Returns a cudaError_t.
extern "C" int p2p_expand_level(const void* plan, const void* rows, const void* y0,
                                const void* x0, void* out, int m, int elsize, void* stream) {
  const LevelPlan& pl = *(const LevelPlan*)plan;
  const int pb = pl.per_block;
  const bool ok =
      m > 0 && (elsize == 2 || elsize == 4) && pl.c > 0 && pl.t > 0 && pl.psize > 0 &&
      pl.psize % pl.t == 0 && (int64_t)4 * pl.t * pl.t * pl.c < INT32_MAX &&
      (int64_t)pl.psize * pl.psize * pl.c < INT32_MAX && pb > 0 && pb <= 8 && THREADS % pb == 0 &&
      ((uintptr_t)out & (elsize - 1)) == 0 &&
      (pl.vec ? pl.c * elsize % 16 == 0 && pl.per_pixel == pl.c * elsize / 16 &&
                    (((uintptr_t)rows | (uintptr_t)out) & 15) == 0
              : pl.per_pixel == pl.c);
  const int smem = 2 * pb * pl.psize * (int)sizeof(int);
  if (!ok || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + pb - 1) / pb), block(THREADS / pb, pb);
  cudaStream_t s = (cudaStream_t)stream;
  if (elsize == 2) {
    expand_level_kernel<uint16_t><<<grid, block, smem, s>>>(
        (const uint16_t*)rows, (const int*)y0, (const int*)x0, (uint16_t*)out, m, pl);
  } else {
    expand_level_kernel<uint32_t><<<grid, block, smem, s>>>(
        (const uint32_t*)rows, (const int*)y0, (const int*)x0, (uint32_t*)out, m, pl);
  }
  return (int)cudaGetLastError();
}

// B7's registers a thread, static shared memory and local (spill) bytes
// for elsize 2 or 4, from cudaFuncGetAttributes.
extern "C" int p2p_expand_level_attrs(int elsize, int* regs, int* smem, int* local) {
  if (elsize != 2 && elsize != 4) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(
      &fa, elsize == 2 ? level_kernel<uint16_t>() : level_kernel<uint32_t>());
  if (rc != cudaSuccess) return (int)rc;
  *regs = fa.numRegs;
  *smem = (int)fa.sharedSizeBytes;
  *local = (int)fa.localSizeBytes;
  return 0;
}

// The size of B3's Args, which the wrapper checks its mirror against.
extern "C" int p2p_expand_args_size() { return (int)sizeof(Args); }

// B3. args: an Args (the plan of ops/patch_expand.py with its pointers
// filled in); dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int p2p_patch_expand(const void* args, int dtype, void* stream) {
  const Args& a = *(const Args*)args;
  if ((dtype != 0 && dtype != 1) || a.elsize != (dtype == 1 ? 2 : 4) || a.n_levels <= 0 ||
      a.n_levels > MAX_LEVELS || a.m <= 0 || a.psize <= 0 || a.psize * a.psize > 4096 ||
      a.smem <= 0 || a.smem > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < a.n_levels; ++l) {
    const Level& lv = a.lv[l];
    if (lv.t <= 0 || lv.c <= 0 || a.psize % lv.t != 0) return (int)cudaErrorInvalidValue;
    // 16-byte stores need aligned outputs; flat runs need per-side outputs
    const bool ok = lv.vec ? (lv.c * a.elsize % 16 == 0 && lv.ostride * a.elsize % 16 == 0 &&
                              (((uintptr_t)lv.out[0] | (uintptr_t)lv.out[1]) & 15) == 0)
                           : lv.ostride == lv.c;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  static int attr_smem[2] = {0, 0};  // dynamic shared memory set up per instantiation
  if (a.smem > attr_smem[dtype]) {
    cudaError_t rc = cudaFuncSetAttribute(
        dtype == 1 ? (const void*)expand_kernel<__nv_bfloat16> : (const void*)expand_kernel<float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (rc != cudaSuccess) return (int)rc;
    attr_smem[dtype] = a.smem;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    expand_kernel<__nv_bfloat16><<<a.m, THREADS, a.smem, s>>>(a);
  } else {
    expand_kernel<float><<<a.m, THREADS, a.smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
