// B4: direct SAME 3^4 conv4d for small channel counts.
//
// Replaces patch2pix_tpu/ops/conv4d_pallas.py conv4d_pallas
// (_conv4d_pallas_impl / _make_kernel). For x (B, h1, w1, h2, w2, CIN) and
// w (3, 3, 3, 3, CIN, COUT), with zero padding:
//
//   out[b,i,j,k,l,co] = bias[co] + sum_{di,dj,dk,dl,ci}
//       x[b, i+di-1, j+dj-1, k+dk-1, l+dl-1, ci] * w[di,dj,dk,dl,ci,co]
//
// The filter is rounded to x's type; every product and sum is float32,
// then the bias, then one rounding to the output type.
//
// Layout: the flat cell n = (b*h1 + i)*w1 + j has one (h2, w2, CIN) plane.
// The input is read through element strides (n, ci, k, l), so both the
// 6D channels-last volume (what the NCN's cuDNN fold-in conv leaves on
// the card: its one-channel input reads as channels-last, and cuDNN
// writes its output so) and an NCHW view (n, ci, k, l) are taken without
// a copy. The output is written NCHW (n, co, k, l), the layout the next
// fold-out conv reads.
//
// Two kernels, by the input's type.
//
// bfloat16 input: conv4d_small_mma_kernel, an implicit GEMM on the tensor
// cores (mma.sync.m16n8k16, bf16 in, f32 accumulate). The Pallas kernel's
// idea is kept: a shift-structured weight matrix turns the narrow (dk, dl,
// ci) -> co contraction into a matrix product. Its TPU layout (w2 padded to
// 128 lanes, panels as wide as w2) is not. Here one MMA tile is M = 16
// consecutive l of one output row pair (k, k+1), N = (2 rows, COUT) padded
// to 8 (16 for COUT 5), K = (4 input rows k-1 .. k+2, 3 dl, CIN padded to
// even) padded to 16s. The filter of each outer tap (di, dj) is a banded
// K x N matrix, B[(r, dl, ci), (ro, co)] = w[di, dj, r-ro, dl, ci, co] for
// 0 <= r-ro <= 2, else 0, packed by the wrapper into the m16n8k16 B
// fragments (ops/conv4d_small.py band_index / mma_fragments) and kept in
// shared memory for the block's life. 4->4 costs 27 MMAs per 16 x 2 x 4
// outputs, 1.33x the useful multiply-adds.
//   A block (8 warps, one output row pair each) owns a strip of J = 16
// output cells (b, i, j0 .. j0+J-1; fewer where w1 is narrow) and one
// 16 x 32 (k, l) tile. It walks the J+2 source columns sj = j0-1 .. j0+J,
// three source rows each; every staged source plane feeds the up to three
// cells of the strip that read it (taps dj = 0, 1, 2), so each A fragment
// loaded from shared memory serves three MMAs. The cells' sums sit in three
// register slots that rotate: after column c the cell j0+c-2 is complete,
// is written and its slot restarts for cell j0+c+1. A plane is staged
// channel-interleaved (ci fastest, CIN padded with zeros to even), so every
// A register is one aligned 32-bit load of a (ci, ci+1) pair; the row pitch
// (42 positions) puts the two input rows one A load can span on disjoint
// banks. Staging goes through registers: a channels-last CIN 4 input (the
// NCN's) takes one 8-byte load a position, already channel-interleaved;
// any other strides take one 2-byte load an element, paired in registers.
// The wrapper picks the staging and passes it. Three register sets and
// three shared buffers, one per source row: a plane's loads are issued
// three planes before it is stored, and one barrier a plane.
//   Bound: 48.9 GFLOP (65 with the band's zeros) at 4->4 on the
// change_stride volume is 0.066 ms at the bf16 peak, below the 0.090 ms of
// its bytes. What bounds this kernel is instruction issue at two blocks an
// SM (113 registers with channels-last staging): the MMAs themselves
// (mma.sync reaches about a third of the dense bf16 rate here, ~0.18 ms),
// the shared-memory A and B fragment loads (2.3 wavefronts an MMA), the
// staging loads and the per-plane barrier; the staging reads 3.4x the
// input from L2 (each plane is read by the strips of three rows i).
// wgmma m64n24k16 (A from registers, the three dj taps side by side in N)
// was measured slower than mma.sync at this N on the H100, so the kernel
// stays on mma.sync.
//   Numerics: the products of bf16 values are exact in f32; the tensor
// core adds the 16 products of a k-step and the accumulator with its own
// rounding (not IEEE round-to-nearest at each add: a few f32 ulps of the
// largest term), in another order than the plain version. Both are far
// below the bf16 output's ulp; the rules (one bf16 ulp + 1e-5 for bf16
// output, 1e-4 for f32) absorb them. A pad entry of the band is 0 * x, so
// an inf in x turns the output rows beside it to NaN where the plain
// version's sum would stay finite (as with the Pallas kernel's panels).
//
// float32 input: conv4d_small_kernel, the SIMT kernel (fmaf in (di, dj, dl,
// ci, dk) order), bound by its 81 * CIN * COUT FMAs per output cell on the
// f32 pipes (~49 GFLOP at 4->4, 0.73 ms at 67 TFLOP/s). One block per (cell
// n, 16 x 32 tile of (k, l)); each thread keeps the COUT sums of R = 4
// cells of one l column in registers. For each of the nine outer taps whose
// source cell is inside the grid, the 18 x 34 input halo of the source plane
// is staged through shared memory, planar per channel; the filter sits in
// shared memory and every warp reads the same word (a broadcast).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 16, TW = 32;  // output tile (k, l) per block
constexpr int R = 4;             // cells per thread, consecutive in k
constexpr int NT = TW * TH / R;  // threads per block

__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

struct Shape {
  int h1, w1, h2, w2, tiles_x, tiles;
  int64_t sn, sc, sk, sl;  // input element strides of (n, ci, k, l)
};

template <typename O, int CIN, int COUT>
__global__ void __launch_bounds__(NT)
conv4d_small_kernel(const float* __restrict__ x, const float* __restrict__ w,
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
      const float* src = x + (n + (int64_t)(di - 1) * s.w1 + (dj - 1)) * s.sn;
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
                           ? src[ci * s.sc + gk * s.sk + gl * s.sl]
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

template <typename O, int CIN, int COUT>
cudaError_t launch(const void* x, const float* w, const float* bias, void* out,
                   int64_t cells, const Shape& s, cudaStream_t st) {
  conv4d_small_kernel<O, CIN, COUT><<<(unsigned)(cells * s.tiles), NT, 0, st>>>(
      (const float*)x, w, bias, (O*)out, s);
  return cudaGetLastError();
}

template <typename O>
cudaError_t dispatch(int cin, int cout, const void* x, const float* w, const float* bias,
                     void* out, int64_t cells, const Shape& s, cudaStream_t st) {
#define P2P_CASE(CI, CO) \
  if (cin == CI && cout == CO) return launch<O, CI, CO>(x, w, bias, out, cells, s, st);
  P2P_CASE(3, 3) P2P_CASE(3, 4) P2P_CASE(3, 5) P2P_CASE(4, 3) P2P_CASE(4, 4) P2P_CASE(5, 3)
#undef P2P_CASE
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- bf16: tensor cores

namespace mma {

constexpr int NWARP = 8;              // warps a block, one output row pair each
constexpr int MT = 2 * NWARP;         // output rows k of a tile
constexpr int MW = 32;                // output columns l of a tile: two m16 groups
constexpr int GMAX = 6;               // column groups a strip: J = 3*G - 2 cells
constexpr int ROWS = MT + 2, COLS = MW + 2;  // the staged halo of a source plane
constexpr int PITCH = 42;             // staged positions a row (bank spread)
constexpr int NTHREADS = 32 * NWARP;
// staging tasks, one halo position each, and tasks a thread
constexpr int TASKS = ROWS * COLS, PER = (TASKS + NTHREADS - 1) / NTHREADS;

// How a plane is staged, by the input's layout (chosen by the wrapper):
// 0 any strides, one 2-byte load per element; 1 channels-last with CIN 4
// (ci stride 1, l stride 4, the cell and k strides multiples of 4, x
// 8-byte aligned), one 8-byte load per position.

template <int CIN, int COUT>
struct Dims {
  static constexpr int CW = (CIN + 1) / 2;     // 32-bit words a staged position
  static constexpr int NPAIRS = 4 * 3 * CW;    // K as (row r, dl, channel pair)
  static constexpr int KS = (NPAIRS + 7) / 8;  // k-steps of 16
  static constexpr int NT = (2 * COUT + 7) / 8;
  static constexpr int BUF = ROWS * PITCH * CW;  // words of one staged plane
};

struct Shape {
  int h1, w1, h2, w2, groups, strips, tiles_x, tiles;
  int64_t sn;      // input element stride of the cell n
  int sc, sk, sl;  // of (ci, k, l): offsets inside a cell fit in 31 bits
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block: strip (b*h1 + i, j0 .. j0+J-1), J = 3*groups - 2, x one
// MT x MW tile of (k, l). Warp w computes output rows k0+2w, k0+2w+1 at both
// 16-column groups. Source plane q = 3*c + di is cell (b, i+di-1, j0-1+c)
// for column c < 3*groups; it goes global -> register set di -> shared
// buffer di, its loads issued three planes before its store. Two blocks
// share an SM (128 registers a thread).
template <typename O, int CIN, int COUT, int MODE>
__global__ void __launch_bounds__(NTHREADS, 2)
conv4d_small_mma_kernel(const uint16_t* __restrict__ x, const uint32_t* __restrict__ frag,
                        const float* __restrict__ bias, O* __restrict__ out, Shape s) {
  using D = Dims<CIN, COUT>;
  constexpr int CW = D::CW, KS = D::KS, NTL = D::NT;
  constexpr int NB = 9 * KS * NTL;  // B fragment tiles: (tap, k-step, n-tile)
  __shared__ __align__(16) uint32_t xs[3][D::BUF];
  __shared__ uint2 bs[NB][32];  // a lane's two B registers side by side
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  int rest = blockIdx.x;
  const int tile = rest % s.tiles;
  rest /= s.tiles;
  const int J = 3 * s.groups - 2;
  const int j0 = (rest % s.strips) * J;
  const int bi = rest / s.strips;  // b*h1 + i
  const int i = bi % s.h1;
  const int jend = min(j0 + J, s.w1);
  const int k0 = (tile / s.tiles_x) * MT, l0 = (tile % s.tiles_x) * MW;

  // the banded filter's B fragments, all nine taps, for the block's life
  // (read after the first plane's barrier)
  for (int e = tid; e < NB * 32; e += NTHREADS)
    bs[e / 32][e % 32] = make_uint2(frag[(e / 32) * 64 + e % 32],
                                    frag[(e / 32) * 64 + 32 + e % 32]);

  // this lane's A columns: for k-step ks, register pair h holds K pair
  // p = 8*ks + t + 4*h = (r*3 + dl)*CW + cp, the word of input row r,
  // column dl, channels (2cp, 2cp+1); -1 past the last pair (zero)
  int aoff[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 8 * ks + t + 4 * h, rd = p / CW;
      aoff[ks][h] = p < D::NPAIRS ? ((rd / 3) * PITCH + rd % 3) * CW + p % CW : -1;
    }

  // the staging tasks of this thread, the same in every plane: for halo
  // position (kk, cc), its offset inside a source plane (-1: zero padding)
  // and its first shared-memory word (-1: no task)
  int soff[PER];
  int sdst[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * NTHREADS;
    const int kk = e / COLS, cc = e % COLS;
    const int gk = k0 + kk - 1, gl = l0 + cc - 1;
    const bool in = e < TASKS && gk >= 0 && gk < s.h2 && gl >= 0 && gl < s.w2;
    soff[u] = in ? gk * s.sk + gl * s.sl : -1;
    sdst[u] = e < TASKS ? (kk * PITCH + cc) * CW : -1;
  }

  float acc[3][2][NTL][4];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int lg = 0; lg < 2; ++lg)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][lg][nt][e] = 0.0f;

  const int ncols = 3 * s.groups;
  auto valid = [&](int c, int di) {  // uniform over the block
    const int si = i + di - 1, sj = j0 - 1 + c;
    return c < ncols && si >= 0 && si < s.h1 && sj >= 0 && sj < s.w1;
  };
  uint32_t st[3][PER][CW];
  // global -> registers, channels paired; a plane outside the grid is zero
  auto load = [&](int c, int di, uint32_t (&r)[PER][CW]) {
    const bool ok = valid(c, di);
    const uint16_t* src = x + ((int64_t)(bi + di - 1) * s.w1 + (j0 - 1 + c)) * s.sn;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const bool in = ok && soff[u] >= 0;
      const uint16_t* pos = src + soff[u];
      if (MODE == 1) {  // (ci 0..3) of one position, already paired
        const uint2 v = in ? *reinterpret_cast<const uint2*>(pos) : make_uint2(0u, 0u);
        r[u][0] = v.x;
        r[u][CW - 1] = v.y;
      } else {
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          const uint32_t lo = in ? pos[(2 * w) * s.sc] : 0u;
          const uint32_t hi = (in && 2 * w + 1 < CIN) ? pos[(2 * w + 1) * s.sc] : 0u;
          r[u][w] = lo | (hi << 16);
        }
      }
    }
  };
#pragma unroll
  for (int di = 0; di < 3; ++di) load(0, di, st[di]);

  const int krow = 2 * warp;  // the warp's first output row in the tile
  const bool rows_in = k0 + krow < s.h2;
  for (int cg = 0; cg < s.groups; ++cg) {
#pragma unroll
    for (int u3 = 0; u3 < 3; ++u3) {
      const int c = 3 * cg + u3;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        uint32_t* xb = xs[di];
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          if (sdst[u] < 0) continue;
          uint32_t* d = xb + sdst[u];
          if (CW == 2) {  // 8-byte aligned: sdst is even
            *reinterpret_cast<uint2*>(d) = make_uint2(st[di][u][0], st[di][u][CW - 1]);
          } else {
#pragma unroll
            for (int w = 0; w < CW; ++w) d[w] = st[di][u][w];
          }
        }
        __syncthreads();  // xb is staged; its readers three planes back are done
        const bool ok = valid(c, di);
        load(c + 1, di, st[di]);  // in flight during the next three planes
        if (!ok || !rows_in) continue;
        const bool right = l0 + 16 < s.w2;  // the second 16-column group, uniform
        const uint32_t* xa = xb + (krow * PITCH + g) * CW;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int o0 = aoff[ks][0], o1 = aoff[ks][1];
          uint32_t a[2][4];
#pragma unroll
          for (int lg = 0; lg < 2; ++lg) {
            const uint32_t* p = xa + 16 * lg * CW;
            if (D::NPAIRS % 8 == 0) {  // every K pair is real
              a[lg][0] = p[o0];
              a[lg][1] = p[o0 + 8 * CW];
              a[lg][2] = p[o1];
              a[lg][3] = p[o1 + 8 * CW];
            } else {
              a[lg][0] = o0 >= 0 ? p[o0] : 0u;
              a[lg][1] = o0 >= 0 ? p[o0 + 8 * CW] : 0u;
              a[lg][2] = o1 >= 0 ? p[o1] : 0u;
              a[lg][3] = o1 >= 0 ? p[o1 + 8 * CW] : 0u;
            }
          }
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            // the strip's cell j0 + c - dj reads this plane through tap (di, dj)
            if (c - dj < 0 || c - dj >= J || j0 + c - dj >= jend) continue;
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt) {
              const uint2 bb = bs[((di * 3 + dj) * KS + ks) * NTL + nt][lane];
              float(&c4)[2][NTL][4] = acc[(u3 - dj + 3) % 3];
              mma_bf16(c4[0][nt], a[0][0], a[0][1], a[0][2], a[0][3], bb.x, bb.y);
              if (right) mma_bf16(c4[1][nt], a[1][0], a[1][1], a[1][2], a[1][3], bb.x, bb.y);
            }
          }
        }
      }
      // column c completes cell j0 + c - 2: bias, one rounding, NCHW store
      if (c >= 2 && j0 + c - 2 < jend) {
        const int u = (u3 + 1) % 3;  // = (c - 2) % 3
        const int64_t plane = (int64_t)s.h2 * s.w2;
        O* o = out + ((int64_t)bi * s.w1 + j0 + c - 2) * COUT * plane;
#pragma unroll
        for (int lg = 0; lg < 2; ++lg)
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int n = 8 * nt + 2 * t + (e & 1), m = g + 8 * (e >> 1);
              const int ro = n / COUT, co = n % COUT;
              const int k = k0 + krow + ro, l = l0 + 16 * lg + m;
              if (n < 2 * COUT && k < s.h2 && l < s.w2)
                narrow(__fadd_rn(acc[u][lg][nt][e], __ldg(bias + co)),
                       o + co * plane + (int64_t)k * s.w2 + l);
            }
      }
      if (c >= 2) {
        const int u = (u3 + 1) % 3;
#pragma unroll
        for (int lg = 0; lg < 2; ++lg)
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][lg][nt][e] = 0.0f;
      }
    }
  }
}

template <typename O, int CIN, int COUT, int MODE>
cudaError_t launch(const void* x, const void* frag, const float* bias, void* out,
                   int64_t blocks, const Shape& s, cudaStream_t st) {
  conv4d_small_mma_kernel<O, CIN, COUT, MODE><<<(unsigned)blocks, NTHREADS, 0, st>>>(
      (const uint16_t*)x, (const uint32_t*)frag, bias, (O*)out, s);
  return cudaGetLastError();
}

// mode 1 exists for CIN 4 only
#define P2P_MMA_CASES(F)                                                       \
  F(3, 3, 0) F(3, 4, 0) F(3, 5, 0) F(4, 3, 0) F(4, 4, 0) F(5, 3, 0) F(4, 3, 1) \
  F(4, 4, 1)

template <typename O>
cudaError_t dispatch(int cin, int cout, int mode, const void* x, const void* frag,
                     const float* bias, void* out, int64_t blocks, const Shape& s,
                     cudaStream_t st) {
#define P2P_CASE(CI, CO, M)                   \
  if (cin == CI && cout == CO && mode == M) \
    return launch<O, CI, CO, M>(x, frag, bias, out, blocks, s, st);
  P2P_MMA_CASES(P2P_CASE)
#undef P2P_CASE
  return cudaErrorInvalidValue;
}

template <typename O>
cudaError_t attrs(int cin, int cout, int mode, cudaFuncAttributes* a) {
#define P2P_CASE(CI, CO, M)                   \
  if (cin == CI && cout == CO && mode == M) \
    return cudaFuncGetAttributes(a, conv4d_small_mma_kernel<O, CI, CO, M>);
  P2P_MMA_CASES(P2P_CASE)
#undef P2P_CASE
  return cudaErrorInvalidValue;
}

// Whether this input may take staging mode 1 (see above).
inline bool channels_last4(const void* x, int cin, long long sn, long long sc, long long sk,
                           long long sl) {
  return ((uintptr_t)x & 7) == 0 && cin == 4 && sc == 1 && sl == 4 && sn % 4 == 0 &&
         sk % 4 == 0;
}

}  // namespace mma

}  // namespace

// x: input read at element offset n*sn + ci*sc + k*sk + l*sl for flat
// cell n = (b*h1 + i)*w1 + j; w: (3,3,3,3,cin,cout) float32 contiguous;
// bias: (cout,) float32; out: (B*h1*w1, cout, h2, w2) contiguous. cin and
// cout > 2 with cin*cout <= 16. dtype/odtype: 0 = float32, 1 = bfloat16;
// this entry takes float32 x only (bf16 goes to p2p_conv4d_small_mma).
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
  if (dtype == 0 && odtype == 1)
    return (int)dispatch<__nv_bfloat16>(cin, cout, x, wf, bf, out, cells, s, st);
  if (dtype == 0 && odtype == 0)
    return (int)dispatch<float>(cin, cout, x, wf, bf, out, cells, s, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel: x as above, bfloat16 (dtype 1); frag: the banded
// filter's B fragments, int32 (9, KS, NT, 2, 32) from ops/conv4d_small.py
// mma_fragments; bias and out as above; mode: the staging (0 any strides,
// 1 channels-last CIN 4, refused where x is not so). Returns a cudaError_t.
extern "C" int p2p_conv4d_small_mma(const void* x, const void* frag, const void* bias,
                                    void* out, int batch, int h1, int w1, int h2, int w2,
                                    int cin, int cout, long long sn, long long sc,
                                    long long sk, long long sl, int dtype, int odtype,
                                    int mode, void* stream) {
  if (dtype != 1 || batch <= 0 || h1 <= 0 || w1 <= 0 || h2 <= 0 || w2 <= 0 ||
      (mode != 0 && !(mode == 1 && mma::channels_last4(x, cin, sn, sc, sk, sl))))
    return (int)cudaErrorInvalidValue;
  mma::Shape s;
  s.h1 = h1;
  s.w1 = w1;
  s.h2 = h2;
  s.w2 = w2;
  // strips of J = 3*groups - 2 cells: 16 where w1 allows, fewer for a
  // narrow w1 (one cell at w1 = 1)
  s.groups = min(mma::GMAX, (w1 + 4) / 3);
  const int J = 3 * s.groups - 2;
  s.strips = (w1 + J - 1) / J;
  s.tiles_x = (w2 + mma::MW - 1) / mma::MW;
  s.tiles = s.tiles_x * ((h2 + mma::MT - 1) / mma::MT);
  s.sn = sn;
  // offsets inside a cell are 32-bit in the kernel
  if (sc < 0 || sk < 0 || sl < 0 ||
      (cin - 1) * sc + (h2 - 1) * sk + (w2 - 1) * sl > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  s.sc = (int)sc;
  s.sk = (int)sk;
  s.sl = (int)sl;
  const int64_t blocks = (int64_t)batch * h1 * s.strips * s.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (odtype == 1)
    return (int)mma::dispatch<__nv_bfloat16>(cin, cout, mode, x, frag, bf, out, blocks, s, st);
  if (odtype == 0)
    return (int)mma::dispatch<float>(cin, cout, mode, x, frag, bf, out, blocks, s, st);
  return (int)cudaErrorInvalidValue;
}

// Registers a thread, static shared memory and local (spill) memory
// bytes a block of the bf16 kernel for (cin, cout, odtype, staging mode).
extern "C" int p2p_conv4d_small_mma_attrs(int cin, int cout, int odtype, int mode, void* regs,
                                          void* smem, void* local) {
  cudaFuncAttributes a;
  const cudaError_t rc = odtype == 1 ? mma::attrs<__nv_bfloat16>(cin, cout, mode, &a)
                                     : mma::attrs<float>(cin, cout, mode, &a);
  if (rc != cudaSuccess) return (int)rc;
  *(int*)regs = a.numRegs;
  *(int*)smem = (int)a.sharedSizeBytes;
  *(int*)local = (int)a.localSizeBytes;
  return 0;
}
