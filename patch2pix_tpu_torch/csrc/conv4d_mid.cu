// B4's C -> C instances: the NCN's middle 4D conv, SAME 3^4 with
// Cin = Cout = C (C 10 or 16), bf16 in, float32 sums, bf16 or float32 out.
//
//   out[b,i,j,k,l,co] = bias[co] + sum_{di,dj,dk,dl,ci}
//       x[b, i+di-1, j+dj-1, k+dk-1, l+dl-1, ci] * w[di,dj,dk,dl,ci,co]
//
// with zero padding on all four spatial axes. Both x and out are the 6D
// channels-last volume (B, h1, w1, h2, w2, C), contiguous: what B4's Cin-1
// kernel writes for the NCN's first layer, and what the fold-out conv of
// the NCN's last layer takes as it is.
//
// Replaces no Pallas kernel. The JAX package sends layers with
// cin * cout > 16 to XLA's per-tap convs (patch2pix_tpu/ops/conv4d.py
// conv4d_xla_taps): nine 2D convs a direction, each on a padded copy of
// the volume sliced per outer tap, their sums added in float32. On the
// H100 that loop took ~184 ms a direction for NCNet InLoc's 16 -> 16 at
// (1, 75, 100, 75, 100) (cuDNN at ~22 TFLOP/s, plus the pad, the slices,
// the float32 adds and the final cast), and NCNet's 10 -> 10 ran on
// cuDNN's generic engine. This kernel does all 81 taps in one pass.
//
// Bound: 2 * 81 * C * C multiply-adds a position. At 16 -> 16 on
// (1, 75, 100, 75, 100) that is 2.33 TFLOP, 2.36 ms at the bf16 peak,
// above the 1.08 ms of its bytes (bf16 in and out once); at 10 -> 10 on
// (1, 48, 64, 48, 64), 0.155 ms at the peak (the kernel pads 10 channels
// to 16 and does 2.56x that many products).
//
// Design: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32
// accumulate) with K = one tap's 16 input channels and N = its 16 output
// channels (two n-tiles): a tap costs 2 MMAs per 16 output positions.
// With N = 16 every A fragment is worth only two MMAs of one tap, so the
// design is about reusing A (and B) from registers, since shared memory
// feeds at most 128 bytes a clock an SM:
//   - A block owns a strip of J cells (b, i, j0 .. j0+J-1) and a band of
//     BASE = 192 "base positions" of the (k, l) plane. The plane's rows
//     are grouped by R = 4 (group q: rows 4q .. 4q+3); base position f
//     is (group f / w2, column f % w2), so the band is 192 consecutive
//     (group, column) pairs and may cross row groups. Warp w owns base
//     positions f0 + 16w .. f0 + 16w + 15 and their four rows: four m16
//     tiles, whose 16 rows (positions) are any 16 cells of the plane,
//     since ldmatrix takes one row address a lane. So l is never padded
//     to a tile: at (75, 100) a plane costs 1.3% more rows and its last
//     band 1% more positions.
//   - The block walks the strip's J + 2 source columns, three source
//     planes each (di), as B4's other kernels do. A staged plane holds,
//     for the band, source rows 4q - 1 .. 4q + 4 of each base position:
//     six "rho rows" of 194 positions (base f0 - 1 .. f0 + 192), 32 bytes
//     a position (16 bf16 channels; channels 10-15 of C 10 are zeros).
//     For each dl a warp loads six A fragments (rho 0..5, ldmatrix.x4 at
//     position offset dl - 1); each serves the three dk of up to three
//     cells (dj = 0, 1, 2: the three cells of the strip that read this
//     plane, the cells' sums in three register slots that rotate), so a
//     loaded A fragment feeds up to 18 MMAs and a B fragment (a tap's
//     filter, one 16-byte load a lane) eight: 107 bytes of shared memory
//     an MMA.
//   - The l edges need no padding in the staged plane: a lane whose
//     position is at column 0 (dl = 0) or w2 - 1 (dl = 2) points its
//     ldmatrix row at a zero slot. Rows beyond the plane are staged as
//     zeros (cp.async with no source bytes), as are planes' positions
//     past the last group.
//   - Planes go global -> shared by cp.async (two 16-byte copies a
//     position at C 16; five 4-byte copies at C 10, whose 20-byte cells
//     are not 16-byte aligned) into a ring of four buffers three planes
//     ahead of the one read, one barrier a plane. A position's two
//     16-byte halves swap places in every other group of four positions,
//     so the eight rows of an 8x8 ldmatrix tile fall on distinct banks
//     at any position offset.
//   - The filter (81 taps x 16 x 16, as the m16n8k16 B fragments the
//     wrapper packs: ops/conv4d_mid.py mid_fragments) stays in shared
//     memory for the block's life: 41,472 bytes. With the ring, 191,232
//     bytes: one block an SM, 12 warps.
//   - A cell is complete after its last column: each lane adds the
//     float32 bias and rounds once to the output type, writing a
//     position's channels pair by pair.
// Numerics: the products of bf16 values are exact in float32; the tensor
// core adds each tap's 16 products and the accumulator with its own
// rounding, in another order than the plain version; one rounding to
// the output at the end (the loop it replaces rounded each tap's sum to
// bf16 first). A pad channel or the zero slot is 0 * x, so an inf in x
// turns its neighbours to NaN where the plain version's sum may stay
// finite.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARP = 12;
constexpr int NTHREADS = 32 * NWARP;
constexpr int R = 4;                // output rows a warp tile (a row group)
constexpr int RHO = R + 2;          // source rows staged under them
constexpr int BASE = 16 * NWARP;    // base positions a block
constexpr int STAGED = BASE + 2;    // staged positions a rho row: base f0 - 1 .. f0 + BASE
constexpr int ZERO = STAGED;        // index of the zero slot after them
constexpr int ROWB = (STAGED + 1) * 32;  // bytes of a rho row, 32 a position
constexpr int PLANEB = RHO * ROWB;  // bytes of a staged plane
constexpr int NBUF = 4;             // the ring of staged planes
constexpr int NTAP = 81;
constexpr int FRAGB = NTAP * 32 * 16;  // the B fragments: 16 bytes a lane and tap
constexpr int SMEM = NBUF * PLANEB + FRAGB;
// staged positions a plane, and a thread's share of them
constexpr int NPOS = RHO * STAGED;
constexpr int PER = (NPOS + NTHREADS - 1) / NTHREADS;

struct Shape {
  int h1, w1, h2, w2;
  int J;       // cells a strip
  int strips;  // strips along w1
  int cells;   // B * h1
  int nbase;   // base positions of a plane: ceil(h2 / R) * w2
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES (4 or 16) from global src to shared dst; with in false nothing
// is read and dst is zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool in) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store2(float a, float b, float* o) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(float a, float b, __nv_bfloat16* o) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// The byte offset in a rho row of half h (channels 8h .. 8h+7) of staged
// position p: the halves swap in every other group of four positions.
__device__ __forceinline__ uint32_t half_offset(int p, int h) {
  return p * 32 + ((h ^ ((p >> 2) & 1)) * 16);
}

// One block: strip (b*h1 + i, j0 .. j0+J-1) x base positions f0 .. f0+191.
// Source plane q = 3*c + di is cell (b, i+di-1, j0-1+c); it goes to ring
// buffer q % NBUF, copied while planes q-3 .. q-1 are read.
template <int C, typename O>
__global__ void __launch_bounds__(NTHREADS, 1)
conv4d_mid_kernel(const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ frag,
                  const float* __restrict__ bias, O* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint4* bs = reinterpret_cast<const uint4*>(smem + NBUF * PLANEB);
  const uint32_t ring = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  int rest = blockIdx.x;
  const int strip = rest % s.strips;
  rest /= s.strips;
  const int bi = rest % s.cells;  // b*h1 + i
  const int f0 = (rest / s.cells) * BASE;
  const int i = bi % s.h1;
  const int j0 = strip * s.J;
  const int ncells = min(s.J, s.w1 - j0);
  const int ncols = ncells + 2;
  const int64_t plane = (int64_t)s.h2 * s.w2 * C;  // elements of a cell

  // zeros: the pad channels of C 10, the zero slots, planes' unstaged
  // positions; then the filter
  for (int e = tid; e < NBUF * PLANEB / 16; e += NTHREADS)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < NTAP * 32; e += NTHREADS)
    reinterpret_cast<uint4*>(smem + NBUF * PLANEB)[e] = frag[e];
  __syncthreads();

  // this thread's staging tasks, the same in every plane: each one
  // position's offset in the source cell (-1: zero) and its byte offset
  // in a staged plane (half 0's; half 1's is it ^ 16; -1: no task)
  int goff[PER], soff[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int p = tid + u * NTHREADS;
    const int rho = p / STAGED, sp = p % STAGED;
    const int f = f0 - 1 + sp;
    const int k = f >= 0 ? (f / s.w2) * R + rho - 1 : -1;
    const bool in = p < NPOS && f >= 0 && f < s.nbase && k >= 0 && k < s.h2;
    goff[u] = in ? k * s.w2 + f % s.w2 : -1;
    soff[u] = p < NPOS ? rho * ROWB + (int)half_offset(sp, 0) : -1;
  }
  auto stage = [&](int q) {
    const int c = q / 3, di = q % 3;
    const int si = i + di - 1, sj = j0 - 1 + c;
    if (c < ncols && si >= 0 && si < s.h1 && sj >= 0 && sj < s.w1) {
      const __nv_bfloat16* src = x + ((int64_t)(bi + di - 1) * s.w1 + sj) * plane;
      const uint32_t dst = ring + (q % NBUF) * PLANEB;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        if (soff[u] < 0) continue;
        const bool in = goff[u] >= 0;
        const __nv_bfloat16* p = in ? src + (int64_t)goff[u] * C : x;
        if (C == 16) {
          cp_async<16>(dst + soff[u], p, in);
          cp_async<16>(dst + (soff[u] ^ 16), p + 8, in);
        } else {
          // 20-byte cells: five words, channel pairs 0-1 .. 8-9
#pragma unroll
          for (int wd = 0; wd < C / 2; ++wd)
            cp_async<4>(dst + (soff[u] ^ ((wd >> 2) * 16)) + (wd & 3) * 4, p + 2 * wd, in);
        }
      }
    }
    cp_async_commit();  // a group a plane, empty where nothing is staged
  };

  // this lane's ldmatrix row: position m of the warp's 16 (matrices 0, 1:
  // m 0-7, 8-15 of channels 0-7; matrices 2, 3 the same of channels
  // 8-15), at source column offset dl - 1; the zero slot where that
  // column lies off the plane
  const int m = (lane & 7) + ((lane >> 3) & 1) * 8, h = lane >> 4;
  const int col = (f0 + 16 * warp + m) % s.w2;
  uint32_t aoff[3];
#pragma unroll
  for (int dl = 0; dl < 3; ++dl) {
    const bool off = (dl == 0 && col == 0) || (dl == 2 && col == s.w2 - 1);
    aoff[dl] = off ? ZERO * 32 + h * 16 : half_offset(16 * warp + m + dl, h);
  }

  float acc[3][R][2][4];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][r][nt][e] = 0.0f;

  stage(0);
  stage(1);
  stage(2);
  for (int cg = 0; cg < (ncols + 2) / 3; ++cg) {
#pragma unroll
    for (int u3 = 0; u3 < 3; ++u3) {
      const int c = 3 * cg + u3;
      if (c >= ncols) break;
      // the strip's cell j0 + c - dj reads this column through tap dj;
      // its sums are in slot (c - dj) % 3
      bool live[3];
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) live[dj] = c - dj >= 0 && c - dj < ncells;
      for (int di = 0; di < 3; ++di) {
        const int q = 3 * c + di;
        cp_async_wait<2>();  // this thread's copies of plane q have landed
        __syncthreads();     // everyone's have; plane q - 1's buffer is free
        stage(q + 3);
        const int si = i + di - 1, sj = j0 - 1 + c;
        if (si < 0 || si >= s.h1 || sj < 0 || sj >= s.w1) continue;
        const uint32_t xb = ring + (q % NBUF) * PLANEB;
        const uint4* bt = bs + di * 27 * 32 + lane;
#pragma unroll
        for (int dl = 0; dl < 3; ++dl) {
          uint32_t a[RHO][4];
#pragma unroll
          for (int rho = 0; rho < RHO; ++rho) ldsm_x4(a[rho], xb + rho * ROWB + aoff[dl]);
#pragma unroll
          for (int dk = 0; dk < 3; ++dk)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              if (!live[dj]) continue;
              // tap (di, dj, dk, dl): B fragments of both n-tiles
              const uint4 bb = bt[((dj * 3 + dk) * 3 + dl) * 32];
              float(&cs)[R][2][4] = acc[(u3 - dj + 3) % 3];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                mma_bf16(cs[r][0], a[r + dk], bb.x, bb.y);
                mma_bf16(cs[r][1], a[r + dk], bb.z, bb.w);
              }
            }
        }
      }
      if (c < 2) continue;
      // column c completes cell j0 + c - 2: bias, one rounding, store
      float(&done)[R][2][4] = acc[(u3 + 1) % 3];
      if (c - 2 < ncells) {
        O* ocell = out + ((int64_t)bi * s.w1 + j0 + c - 2) * plane;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int f = f0 + 16 * warp + g + 8 * hh;
          if (f >= s.nbase) continue;
          const int k0 = (f / s.w2) * R, l = f % s.w2;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (k0 + r >= s.h2) continue;
            O* o = ocell + ((int64_t)(k0 + r) * s.w2 + l) * C;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int co = 8 * nt + 2 * t;
              if (co >= C) continue;
              store2(__fadd_rn(done[r][nt][2 * hh], __ldg(bias + co)),
                     __fadd_rn(done[r][nt][2 * hh + 1], __ldg(bias + co + 1)), o + co);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) done[r][nt][e] = 0.0f;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <int C, typename O>
cudaError_t launch(const void* x, const void* frag, const float* bias, void* out,
                   int64_t blocks, const Shape& s, cudaStream_t st) {
  static bool attr_set = false;  // once per process: above 48 KB only with the attribute
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        conv4d_mid_kernel<C, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  conv4d_mid_kernel<C, O><<<(unsigned)blocks, NTHREADS, SMEM, st>>>(
      (const __nv_bfloat16*)x, (const uint4*)frag, bias, (O*)out, s);
  return cudaGetLastError();
}

template <typename O>
cudaError_t dispatch(int c, const void* x, const void* frag, const float* bias, void* out,
                     int64_t blocks, const Shape& s, cudaStream_t st) {
  if (c == 16) return launch<16, O>(x, frag, bias, out, blocks, s, st);
  if (c == 10) return launch<10, O>(x, frag, bias, out, blocks, s, st);
  return cudaErrorInvalidValue;
}

template <typename O>
cudaError_t attrs(int c, cudaFuncAttributes* a) {
  if (c == 16) return cudaFuncGetAttributes(a, conv4d_mid_kernel<16, O>);
  if (c == 10) return cudaFuncGetAttributes(a, conv4d_mid_kernel<10, O>);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: bfloat16 (B, h1, w1, h2, w2, c) contiguous, 16-byte aligned at c 16
// (4-byte at c 10); frag: int32 (81, 32, 4) from ops/conv4d_mid.py
// mid_fragments; bias: float32 (c,); out: (B, h1, w1, h2, w2, c)
// contiguous, bfloat16 (odtype 1) or float32 (0); c 10 or 16; strip: cells
// a block walks along w1, 1 .. w1.
extern "C" int p2p_conv4d_mid(const void* x, const void* frag, const void* bias, void* out,
                              int batch, int h1, int w1, int h2, int w2, int c, int strip,
                              int odtype, void* stream) {
  if (batch < 1 || h1 < 1 || w1 < 1 || h2 < 1 || w2 < 1 || strip < 1 || strip > w1 ||
      (uintptr_t)x % (c == 16 ? 16 : 4) != 0 || (int64_t)h2 * w2 * c >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.h1 = h1;
  s.w1 = w1;
  s.h2 = h2;
  s.w2 = w2;
  s.J = strip;
  s.strips = (w1 + strip - 1) / strip;
  s.cells = batch * h1;
  s.nbase = (h2 + R - 1) / R * w2;
  const int64_t bands = (s.nbase + BASE - 1) / BASE;
  const int64_t blocks = (int64_t)s.strips * s.cells * bands;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (odtype == 1) return (int)dispatch<__nv_bfloat16>(c, x, frag, bf, out, blocks, s, st);
  if (odtype == 0) return (int)dispatch<float>(c, x, frag, bf, out, blocks, s, st);
  return (int)cudaErrorInvalidValue;
}

// Registers a thread and local (spill) memory bytes a block of the
// kernel for (c, odtype), and the dynamic shared memory it launches with.
extern "C" int p2p_conv4d_mid_attrs(int c, int odtype, void* regs, void* dyn_smem,
                                    void* local) {
  cudaFuncAttributes a;
  const cudaError_t rc = odtype == 1 ? attrs<__nv_bfloat16>(c, &a) : attrs<float>(c, &a);
  if (rc != cudaSuccess) return (int)rc;
  *(int*)regs = a.numRegs;
  *(int*)dyn_smem = SMEM;
  *(int*)local = (int)a.localSizeBytes;
  return 0;
}
