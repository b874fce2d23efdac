// B4: direct SAME 3^4 conv4d for small channel counts.
//
// Replaces patch2pix_tpu/ops/conv4d_pallas.py conv4d_pallas
// (_conv4d_pallas_impl / _make_kernel). For x (B, h1, w1, h2, w2, CIN) and
// w (3, 3, 3, 3, CIN, COUT), with zero padding:
//
//   out[b,i,j,k,l,co] = bias[co] + sum_{di,dj,dk,dl,ci}
//       x[b, i+di-1, j+dj-1, k+dk-1, l+dl-1, ci] * w[di,dj,dk,dl,ci,co]
//
// The filter is rounded to x's type; every product is float32 (exact for
// bf16, within ~2^-21 of itself for float32: 3xTF32, below), every sum
// float32, then the bias, then one rounding to the output type.
//
// Layout: the flat cell n = (b*h1 + i)*w1 + j has one (h2, w2, CIN) plane.
// The input is read through element strides (n, ci, k, l), so both the
// 6D channels-last volume (what the NCN's first layer leaves on the card)
// and an NCHW view (n, ci, k, l) are taken without a copy. The output is
// written NCHW (n, co, k, l), except the CIN 1 kernel's (its section).
//
// Three kernels, all on the tensor cores: two by the input's type, and a
// bf16 one for CIN 1, the NCN's first layer, described in its own section.
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
// float32 input: conv4d_small_tf32_kernel, the same implicit GEMM on the
// tensor cores in TF32 (mma.sync.m16n8k8), every float32 product formed
// from three TF32 products (3xTF32: x = hi + lo, w = hi' + lo', x * w ~
// lo*hi' + hi*lo' + hi*hi'). It keeps the bf16 kernel's block, strip,
// tile, rotating cell slots and banded filter; K = (4 rows, 3 dl, CIN) is
// not paired and is padded to 8s (40 / 48 / 64 for CIN 3 / 4 / 5). The
// wrapper splits the band once a call (ops/fine_stage.py tf32_split) and
// lays hi and lo out as the m16n8k8 B fragments (ops/conv4d_small.py
// tf32_fragments): one 16-byte shared load a lane and tile. The input is
// split in registers as each A element comes from shared memory (rounded
// as tf32_split rounds, cvt.rna.tf32.f32's bits, then lo = x - hi); each
// split pair serves the three dj cells with three products each. Planes
// go global -> shared by cp.async, no staging registers (16 bytes a
// position for a channels-last CIN 4 input 16-byte aligned, the NCN's; 4
// bytes an element for any strides), into a ring of four buffers three
// planes ahead, one barrier a plane. At 4->4 a block has 27,648 B of fragments and 39,168 B of planes
// (dynamic shared memory, planned in Python as tf32_smem_bytes), two
// blocks an SM.
//   Bound: 3 x 48.9 GFLOP at 4->4 on the change_stride volume is 0.297 ms
// at the 495 TFLOP/s TF32 peak, above the 0.180 ms of its bytes (one
// float32 FMA a product on the f32 pipes, the SIMT kernel this one
// replaced, is bound at 0.730 ms). At this N it is bound by instruction
// throughput, as the bf16 kernel is: a warp's plane is 108 MMAs (6 k-steps x 3 cells x 2
// column groups x 3 products) among about a thousand other instructions
// (A loads and splits, B loads, the tap's float32 adds, the branches
// around the MMAs of a strip's edge cells), four warps a scheduler. The
// di loop is not unrolled (only u3 picks the cells' register slots): half
// the build time, and no slower.
//   Numerics: lo*lo' (~2^-22 of a product) is dropped and the tensor cores
// read lo's top 11 bits. A plane's (one outer tap's) products start from
// zero on the tensor cores and are added into the cells' float32 sums in
// registers, so the tensor cores' own accumulation spans 18 MMAs at most
// (accumulating all nine taps there erred five times more on an H100).
// An inf or NaN in x turns the outputs beside it to NaN (its lo is NaN,
// and a pad entry of the band is 0 * x) where the plain version's sum may
// stay finite.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

// ------------------------------------------------- bf16: tensor cores

namespace mma {

constexpr int NWARP = 8;              // warps a block, one output row pair each
constexpr int MT = 2 * NWARP;         // output rows k of a tile
constexpr int MW = 32;                // output columns l of a tile: two m16 groups
constexpr int GMAX = 6;               // column groups a strip: J = 3*G - 2 cells
constexpr int ROWS = MT + 2;          // the staged halo of a source plane
constexpr int COLS = MW + 2;
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

// ------------------------------------------------- bf16, CIN 1: the NCN's first layer

// conv4d_cin1_kernel: the bf16 kernel's design for a one-channel input.
// Replaces no Pallas kernel: the JAX package runs this layer as the
// fold-in (patch2pix_tpu/ops/conv4d.py conv4d_fold_in), a 9-tap shifted
// stack under one 9-channel conv, which on the H100 cost ~13.7 ms a
// direction at the change_stride volume (a 9x stack copy and cuDNN's
// generic engine). K packs (row, dl) with no channel axis: the pair of K
// entries 2q, 2q+1 (q = 3h + dl, q < 6) is input rows 2h, 2h+1 of the
// warp's four at column dl, so K is 12 of 16 entries in one k-step and a
// tile of 16 positions x 2 rows costs 4 MMAs an outer tap at COUT 16 (the
// paired layout would pad CIN to 2 and take two k-steps). A staged plane
// holds, per row pair and position, the 32-bit word (row 2rp, row
// 2rp+1): every A register is one aligned shared load. Staging mode 2
// reads a plane whose l stride is 1 with 16-byte loads, 8 positions of
// one row a lane; neighbouring lanes hold a pair's two rows and swap
// halves by shuffle before they interleave. Mode 0 takes any strides, one
// 2-byte load an element. The strip walk and the rotating cell slots are
// the bf16 kernel's; a column's three planes are staged together into
// one of two sets of buffers, one barrier a column.
//   COUT 16 keeps 96 accumulators a thread (three cells x two 16-column
// groups x (2 rows, 16 co)), so a block is 12 warps (24 output rows a
// tile) at one block an SM and up to 168 registers: 8 warps ran 20%
// slower, 8 warps at two blocks an SM spilled and ran 30% slower, 16
// warps (128 registers) spilled and ran 50% slower (H100). The output is
// channels-last, (B, h1, w1, h2, w2, COUT), the layout the cuDNN conv of
// the NCN's next layer takes as it is (an NCHW-per-cell input cost the
// 16 -> 9 fold-out conv 0.55 ms more a direction on the H100). Each warp
// writes an output row's 32 positions x COUT channels, one contiguous run,
// through shared memory in 16-byte stores; the sums get the float32 bias
// and one rounding to the output type.
//   Bound: at 1 -> 16 on the change_stride volume the bytes (37.7 MB in,
// 604 MB out: 0.19 ms at 3.35 TB/s) bound it; the 48.9 GFLOP (87 with the
// band's zeros) take 0.05 ms at the bf16 peak. It runs at ~40% of the
// bytes bound: every column the 12 warps pass one barrier together, so
// the MMAs, the epilogue (bias, rounding, shared-memory transpose of the
// output rows) and the staging of a column do not overlap across warps;
// deferring the stores into the next column, staging by cp.async and
// 16-byte B loads were each measured slower (registers).

constexpr int NWARP1 = 12;            // warps a block, one output row pair each
constexpr int MT1 = 2 * NWARP1;       // output rows k of a tile
constexpr int RP1 = MT1 / 2 + 1;      // staged row pairs: input rows k0-1 .. k0+MT1
constexpr int PITCH1 = MW + 16;       // staged positions (words) a row pair: l0-8 .. l0+39
constexpr int NTHREADS1 = 32 * NWARP1;
// mode 2: a task is one 16-byte load, 8 positions of one row; the two
// rows of a pair go to neighbouring lanes, which swap halves
constexpr int VTASKS = 2 * RP1 * PITCH1 / 8, VWARPS = (VTASKS + 31) / 32;
// mode 0: a task is one word, positions l0-1 .. l0+MW of a row pair
constexpr int ETASKS = RP1 * COLS, PER1 = (ETASKS + NTHREADS1 - 1) / NTHREADS1;

// The dynamic shared memory of a block, in bytes: the staged planes,
// the B fragments, and each warp's two output rows on their way out.
template <typename O, int COUT>
struct Cin1Plan {
  static constexpr int NT = (2 * COUT + 7) / 8;
  static constexpr int NB = 9 * NT;               // B fragment tiles: (tap, n-tile)
  static constexpr int RUN = MW * COUT;           // a tile row's outputs, one contiguous run
  static constexpr int XS = 2 * 3 * RP1 * PITCH1 * 4;  // two columns of three planes
  static constexpr int BS = NB * 32 * 8;
  static constexpr int SMEM = XS + BS + NWARP1 * 2 * RUN * (int)sizeof(O);
};

__device__ __forceinline__ void narrow2(float a, float b, float* o) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void narrow2(float a, float b, __nv_bfloat16* o) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// One block: strip (b*h1 + i, j0 .. j0+J-1) x one MT1 x MW tile of (k, l),
// as conv4d_small_mma_kernel. Warp w computes output rows k0+2w, k0+2w+1.
template <typename O, int COUT, int MODE>
__global__ void __launch_bounds__(NTHREADS1, 1)
conv4d_cin1_kernel(const uint16_t* __restrict__ x, const uint32_t* __restrict__ frag,
                   const float* __restrict__ bias, O* __restrict__ out, Shape s) {
  using P = Cin1Plan<O, COUT>;
  constexpr int NTL = P::NT, NB = P::NB, RUN = P::RUN;
  constexpr int VEC = 16 / (int)sizeof(O);       // outputs a 16-byte store
  extern __shared__ __align__(16) uint4 smem1[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem1);                       // [3][RP1 * PITCH1]
  uint2* bs = reinterpret_cast<uint2*>(reinterpret_cast<char*>(smem1) + P::XS);  // [NB][32]
  O* scr = reinterpret_cast<O*>(reinterpret_cast<char*>(smem1) + P::XS + P::BS);
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
  const int k0 = (tile / s.tiles_x) * MT1, l0 = (tile % s.tiles_x) * MW;

  for (int e = tid; e < NB * 32; e += NTHREADS1)
    bs[e] = make_uint2(frag[(e / 32) * 64 + e % 32], frag[(e / 32) * 64 + 32 + e % 32]);

  // this lane's A words: K pair t (a0, a1) is (h, dl) = (t / 3, t % 3); K
  // pair t + 4 (a2, a3) is (1, t + 1) for t < 2, else past K (zero)
  const int off0 = (t / 3) * PITCH1 + t % 3;
  const int off1 = t < 2 ? PITCH1 + 1 + t : -1;

  // the staging tasks of this thread, the same in every plane: the
  // offset of each task's input inside a source plane (-1: zero padding)
  // and its first shared word (-1: no task)
  constexpr int PER = MODE == 2 ? 1 : PER1;
  int soff[PER][2];
  int sdst[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * NTHREADS1;
    if (MODE == 2) {
      const int rp = (e >> 1) / (PITCH1 / 8), v = (e >> 1) % (PITCH1 / 8), rr = e & 1;
      const int gk = k0 - 1 + 2 * rp + rr, gl = l0 - 8 + 8 * v;
      // w2 % 8 == 0: the 8 positions are all in or all out
      const bool in = e < VTASKS && gk >= 0 && gk < s.h2 && gl >= 0 && gl < s.w2;
      soff[u][0] = in ? gk * s.sk + gl : -1;
      soff[u][1] = -1;
      sdst[u] = e < VTASKS ? rp * PITCH1 + 8 * v + 4 * rr : -1;
    } else {
      const int rp = e / COLS, gl = l0 - 1 + e % COLS;
      sdst[u] = e < ETASKS ? rp * PITCH1 + 7 + e % COLS : -1;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int gk = k0 - 1 + 2 * rp + rr;
        const bool in = sdst[u] >= 0 && gl >= 0 && gl < s.w2 && gk >= 0 && gk < s.h2;
        soff[u][rr] = in ? gk * s.sk + gl * s.sl : -1;
      }
    }
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
  // global -> registers: mode 2 one 16-byte load, mode 0 one word a task
  // (row 2rp low, row 2rp+1 high); a plane outside the grid is not read
  constexpr int SW = MODE == 2 ? 4 : PER1;
  uint32_t st[3][SW];
  auto load = [&](int c, int di, uint32_t (&r)[SW]) {
    const bool ok = valid(c, di);
    const uint16_t* src = x + ((int64_t)(bi + di - 1) * s.w1 + (j0 - 1 + c)) * s.sn;
    if (MODE == 2) {
      const uint4 v = ok && soff[0][0] >= 0
                          ? __ldg(reinterpret_cast<const uint4*>(src + soff[0][0]))
                          : make_uint4(0u, 0u, 0u, 0u);
      r[0] = v.x;
      r[1] = v.y;
      r[2] = v.z;
      r[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const uint32_t lo = ok && soff[u][0] >= 0 ? src[soff[u][0]] : 0u;
        const uint32_t hi = ok && soff[u][1] >= 0 ? src[soff[u][1]] : 0u;
        r[u] = lo | (hi << 16);
      }
    }
  };
#pragma unroll
  for (int di = 0; di < 3; ++di) load(0, di, st[di]);

  const int krow = 2 * warp;  // the warp's first output row in the tile
  const bool rows_in = k0 + krow < s.h2;
  const bool right = l0 + 16 < s.w2;  // the second 16-column group, uniform
  const int nl = min(MW, s.w2 - l0);  // positions of the tile's rows
  // a tile row goes out in 16-byte stores where every row's run is 16-byte
  // aligned, else one output at a time
  const bool vec = (int64_t)s.w2 * COUT * (int)sizeof(O) % 16 == 0;
  O* sc = scr + warp * 2 * RUN;  // the warp's two rows: (row, position, co), co fastest
  for (int cg = 0; cg < s.groups; ++cg) {
#pragma unroll
    for (int u3 = 0; u3 < 3; ++u3) {
      const int c = 3 * cg + u3;
      // the column's three planes, in the buffers of its parity
      uint32_t* xcol = xs + (c & 1) * 3 * RP1 * PITCH1;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        uint32_t* xb = xcol + di * RP1 * PITCH1;
        if (MODE == 2) {
          if (warp < VWARPS) {  // uniform: the warps with staging tasks
            // the even lane holds row 2rp, the odd lane row 2rp+1, of the
            // same 8 positions: the even lane keeps positions 0-3, the odd
            // lane 4-7, and each takes the other row's from its neighbour
            const bool odd = lane & 1;
            const uint32_t* v = st[di];
            const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
            const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
            const uint32_t a0 = odd ? r0 : v[0], a1 = odd ? r1 : v[1];  // row 2rp
            const uint32_t b0 = odd ? v[2] : r0, b1 = odd ? v[3] : r1;  // row 2rp+1
            if (sdst[0] >= 0)  // word p = (row 2rp, row 2rp+1) at position p
              *reinterpret_cast<uint4*>(xb + sdst[0]) =
                  make_uint4(__byte_perm(a0, b0, 0x5410), __byte_perm(a0, b0, 0x7632),
                             __byte_perm(a1, b1, 0x5410), __byte_perm(a1, b1, 0x7632));
          }
        } else {
#pragma unroll
          for (int u = 0; u < PER; ++u)
            if (sdst[u] >= 0) xb[sdst[u]] = st[di][u];
        }
      }
      // the column is staged; the buffers it overwrote were read two
      // columns back, before every warp reached the last barrier
      __syncthreads();
#pragma unroll
      for (int di = 0; di < 3; ++di) load(c + 1, di, st[di]);  // in flight for a column
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        if (!valid(c, di) || !rows_in) continue;
        const uint32_t* xb = xcol + di * RP1 * PITCH1;
        // position m of the warp's tile reads word m + dl + 7 of its row pairs
        const uint32_t* xa = xb + warp * PITCH1 + g + 7;
        uint32_t a[2][4];
#pragma unroll
        for (int lg = 0; lg < 2; ++lg) {
          const uint32_t* p = xa + 16 * lg;
          a[lg][0] = p[off0];
          a[lg][1] = p[off0 + 8];
          a[lg][2] = off1 >= 0 ? p[off1] : 0u;
          a[lg][3] = off1 >= 0 ? p[off1 + 8] : 0u;
        }
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          // the strip's cell j0 + c - dj reads this plane through tap (di, dj)
          if (c - dj < 0 || c - dj >= J || j0 + c - dj >= jend) continue;
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt) {
            const uint2 bb = bs[((di * 3 + dj) * NTL + nt) * 32 + lane];
            float(&c4)[2][NTL][4] = acc[(u3 - dj + 3) % 3];
            mma_bf16(c4[0][nt], a[0][0], a[0][1], a[0][2], a[0][3], bb.x, bb.y);
            if (right) mma_bf16(c4[1][nt], a[1][0], a[1][1], a[1][2], a[1][3], bb.x, bb.y);
          }
        }
      }
      // column c completes cell j0 + c - 2: bias, one rounding, store
      if (c >= 2 && j0 + c - 2 < jend && rows_in) {
        const int u = (u3 + 1) % 3;  // = (c - 2) % 3
        O* o = out + (((int64_t)bi * s.w1 + j0 + c - 2) * s.h2 + k0 + krow) * s.w2 * COUT +
               l0 * COUT;  // the warp's first row at position l0
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
          const int n = 8 * nt + 2 * t;  // COUT even: columns n, n+1 in one row
          if (n >= 2 * COUT) continue;
          const int ro = n / COUT, co = n % COUT;
          const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1);
#pragma unroll
          for (int lg = 0; lg < 2; ++lg)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = 16 * lg + g + 8 * h;
              const float v0 = __fadd_rn(acc[u][lg][nt][2 * h], b0);
              const float v1 = __fadd_rn(acc[u][lg][nt][2 * h + 1], b1);
              if (vec)
                narrow2(v0, v1, sc + ro * RUN + m * COUT + co);
              else if (k0 + krow + ro < s.h2 && m < nl) {
                narrow(v0, o + (int64_t)ro * s.w2 * COUT + m * COUT + co);
                narrow(v1, o + (int64_t)ro * s.w2 * COUT + m * COUT + co + 1);
              }
            }
        }
        if (vec) {
          __syncwarp();
          const int nv = nl * COUT / VEC;  // 16-byte pieces of a row's run
#pragma unroll
          for (int ro = 0; ro < 2; ++ro)
            if (k0 + krow + ro < s.h2)
              for (int v = lane; v < nv; v += 32)
                reinterpret_cast<uint4*>(o + (int64_t)ro * s.w2 * COUT)[v] =
                    reinterpret_cast<const uint4*>(sc + ro * RUN)[v];
          __syncwarp();
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

template <typename O, int COUT, int MODE>
cudaError_t launch_cin1(const void* x, const void* frag, const float* bias, void* out,
                        int64_t blocks, const Shape& s, cudaStream_t st) {
  constexpr int smem = Cin1Plan<O, COUT>::SMEM;
  static bool attr_set = false;  // once per process: above 48 KB only with the attribute
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        conv4d_cin1_kernel<O, COUT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  conv4d_cin1_kernel<O, COUT, MODE><<<(unsigned)blocks, NTHREADS1, smem, st>>>(
      (const uint16_t*)x, (const uint32_t*)frag, bias, (O*)out, s);
  return cudaGetLastError();
}

// the COUT the port's NCN configurations put after a one-channel input:
// 16 (Patch2Pix), 10 (ImMatchNet), 4 (the (4, 4, 1) NCN); mode 0 and 2
#define P2P_CIN1_CASES(F) F(4, 0) F(4, 2) F(10, 0) F(10, 2) F(16, 0) F(16, 2)

template <typename O>
cudaError_t dispatch_cin1(int cout, int mode, const void* x, const void* frag,
                          const float* bias, void* out, int64_t blocks, const Shape& s,
                          cudaStream_t st) {
#define P2P_CASE(CO, M)             \
  if (cout == CO && mode == M) \
    return launch_cin1<O, CO, M>(x, frag, bias, out, blocks, s, st);
  P2P_CIN1_CASES(P2P_CASE)
#undef P2P_CASE
  return cudaErrorInvalidValue;
}

template <typename O>
cudaError_t attrs_cin1(int cout, int mode, cudaFuncAttributes* a, int* dyn) {
#define P2P_CASE(CO, M)                                              \
  if (cout == CO && mode == M) {                                     \
    *dyn = Cin1Plan<O, CO>::SMEM;                                    \
    return cudaFuncGetAttributes(a, conv4d_cin1_kernel<O, CO, M>);  \
  }
  P2P_CIN1_CASES(P2P_CASE)
#undef P2P_CASE
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- float32: 3xTF32

// The float32 kernel keeps the bf16 kernel's block, strip, tile and
// banded filter; what differs is below. A staged position holds CIN
// words (ci fastest, not padded), PITCH_F positions a row; the planes go
// global -> shared by cp.async, no registers between, into a ring of
// NBUF_F buffers three planes ahead of the one read.
constexpr int PITCH_F = 34;
constexpr int NBUF_F = 4;

template <int CIN, int COUT>
struct DimsF {
  static constexpr int KQ = 4 * 3 * CIN;       // K as (row r, dl, ci)
  static constexpr int KS = (KQ + 7) / 8;      // k-steps of 8
  static constexpr int NT = (2 * COUT + 7) / 8;
  static constexpr int NB = 9 * KS * NT;       // B tiles: (tap, k-step, n-tile)
  static constexpr int BUF = ROWS * PITCH_F * CIN;  // words of one staged plane
  // dynamic shared memory: the B tiles (a lane's hi and lo words, 16
  // bytes), then the ring of staged planes
  static constexpr int SMEM = NB * 32 * 16 + NBUF_F * BUF * 4;
};

// x rounded to TF32 as ops/fine_stage.py tf32_split rounds it: to nearest
// with ties away from zero, the low 13 mantissa bits zero. For finite x
// these are cvt.rna.tf32.f32's bits, in two integer instructions where
// the cvt takes about four (8% of the kernel's time at 4->4 on an H100). An
// inf stays inf and a NaN leaves hi or lo NaN, so NaN reaches the output.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// c += A (16 x 8, row) * B (8 x 8, col) in TF32: the low 13 mantissa
// bits of each operand register are not read
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
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

// One block: as conv4d_small_mma_kernel. Source plane q = 3*c + di goes
// to ring buffer q % NBUF_F, copied while planes q-3 .. q-1 are read.
// Each A element is split in registers into hi (TF32) and lo = x - hi;
// with the wrapper's hi and lo filter fragments every product is
// lo*hi' + hi*lo' + hi*hi' (lo*lo', ~2^-22 of it, is dropped). A plane's
// (outer tap's) sums for the three cells start from zero on the tensor
// cores and are added to the cells' float32 sums in registers.
template <typename O, int CIN, int COUT, int MODE>
__global__ void __launch_bounds__(NTHREADS, 2)
conv4d_small_tf32_kernel(const float* __restrict__ x, const uint4* __restrict__ frag,
                         const float* __restrict__ bias, O* __restrict__ out, Shape s) {
  using D = DimsF<CIN, COUT>;
  constexpr int KS = D::KS, NTL = D::NT, NB = D::NB;
  extern __shared__ __align__(16) uint4 smem_f[];
  uint4* bs = smem_f;  // [NB][32]: a lane's (hi b0, hi b1, lo b0, lo b1)
  float* xs = reinterpret_cast<float*>(smem_f + NB * 32);  // [NBUF_F][BUF]
  const uint32_t xs_u32 = (uint32_t)__cvta_generic_to_shared(xs);
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
  for (int e = tid; e < NB * 32; e += NTHREADS) bs[e] = __ldg(frag + e);

  // this lane's A columns: for k-step ks, registers a[2h], a[2h+1] hold K
  // index q = 8*ks + t + 4*h = (r*3 + dl)*CIN + ci, the word of input row
  // r, column dl, channel ci (at A rows g and g+8); -1 past the last (zero).
  // Where CIN is a multiple of 4, t only moves ci: the offsets are
  // constants and t goes into the lane's base.
  constexpr bool T_IN_BASE = CIN % 4 == 0;
  int aoff[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 8 * ks + 4 * h + (T_IN_BASE ? 0 : t), rd = q / CIN;
      aoff[ks][h] = q < D::KQ ? ((rd / 3) * PITCH_F + rd % 3) * CIN + q % CIN : -1;
    }

  // the staging tasks of this thread, the same in every plane: for halo
  // position (kk, cc), its offset inside a source plane (-1: zero padding)
  // and its first word in a staged plane (-1: no task)
  int soff[PER];
  int sdst[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * NTHREADS;
    const int kk = e / COLS, cc = e % COLS;
    const int gk = k0 + kk - 1, gl = l0 + cc - 1;
    const bool in = e < TASKS && gk >= 0 && gk < s.h2 && gl >= 0 && gl < s.w2;
    soff[u] = in ? gk * s.sk + gl * s.sl : -1;
    sdst[u] = e < TASKS ? (kk * PITCH_F + cc) * CIN : -1;
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
  // plane q's copies as one cp.async group (empty for a plane outside the
  // grid, which is never read); zero padding is zero-filled
  auto copy_plane = [&](int q) {
    const int c = q / 3, di = q - 3 * c;
    if (valid(c, di)) {
      const float* src = x + ((int64_t)(bi + di - 1) * s.w1 + (j0 - 1 + c)) * s.sn;
      const uint32_t dst = xs_u32 + (uint32_t)((q % NBUF_F) * D::BUF * 4);
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        if (sdst[u] < 0) continue;
        const bool in = soff[u] >= 0;
        const float* pos = in ? src + soff[u] : x;
        const uint32_t d = dst + 4u * sdst[u];
        if (MODE == 1) {  // (ci 0..3) of one position, 16 bytes
          cp_async<16>(d, pos, in);
        } else {
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) cp_async<4>(d + 4 * ci, in ? pos + ci * s.sc : x, in);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < NBUF_F - 1; ++q) copy_plane(q);

  const int krow = 2 * warp;  // the warp's first output row in the tile
  const bool rows_in = k0 + krow < s.h2;
  const bool right = l0 + 16 < s.w2;  // the second 16-column group, uniform
  for (int cg = 0; cg < s.groups; ++cg) {
#pragma unroll
    for (int u3 = 0; u3 < 3; ++u3) {
      const int c = 3 * cg + u3;
      // not unrolled (see the header)
#pragma unroll 1
      for (int di = 0; di < 3; ++di) {
        const int q = 3 * c + di;
        cp_async_wait<NBUF_F - 2>();  // this thread's copies of plane q are in
        __syncthreads();  // and everyone's; plane q-1's readers are done with its buffer
        copy_plane(q + NBUF_F - 1);  // into plane q-1's buffer
        if (!valid(c, di) || !rows_in) continue;
        const float* xa = xs + (q % NBUF_F) * D::BUF + (krow * PITCH_F + g) * CIN +
                          (T_IN_BASE ? t : 0);
        // this outer tap's sums for the cells j0+c-dj, from zero
        float part[3][2][NTL][4];
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int lg = 0; lg < 2; ++lg)
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[dj][lg][nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t hi[2][4], lo[2][4];
#pragma unroll
          for (int lg = 0; lg < 2; ++lg)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int m8 = 0; m8 < 2; ++m8) {  // A rows g, g+8: 8 positions on in l
                const int o = aoff[ks][h];
                const float v = o >= 0 ? xa[16 * lg * CIN + o + 8 * CIN * m8] : 0.0f;
                const uint32_t vh = tf32_round(v);
                hi[lg][2 * h + m8] = vh;
                lo[lg][2 * h + m8] = __float_as_uint(__fsub_rn(v, __uint_as_float(vh)));
              }
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            // the strip's cell j0 + c - dj reads this plane through tap (di, dj)
            if (c - dj < 0 || c - dj >= J || j0 + c - dj >= jend) continue;
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt) {
              const uint4 b = bs[(((di * 3 + dj) * KS + ks) * NTL + nt) * 32 + lane];
#pragma unroll
              for (int lg = 0; lg < 2; ++lg) {
                if (lg == 1 && !right) continue;
                // the small products first
                mma_tf32(part[dj][lg][nt], lo[lg], b.x, b.y);
                mma_tf32(part[dj][lg][nt], hi[lg], b.z, b.w);
                mma_tf32(part[dj][lg][nt], hi[lg], b.x, b.y);
              }
            }
          }
        }
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          if (c - dj < 0 || c - dj >= J || j0 + c - dj >= jend) continue;
          float(&c4)[2][NTL][4] = acc[(u3 - dj + 3) % 3];
#pragma unroll
          for (int lg = 0; lg < 2; ++lg)
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                c4[lg][nt][e] = __fadd_rn(c4[lg][nt][e], part[dj][lg][nt][e]);
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
cudaError_t launch_tf32(const void* x, const void* frag, const float* bias, void* out,
                        int64_t blocks, const Shape& s, cudaStream_t st) {
  constexpr int smem = DimsF<CIN, COUT>::SMEM;
  static bool attr_set = false;  // once per process: two blocks an SM need the
  if (!attr_set) {               // shared-memory carveout and, above 48 KB, the size
    cudaError_t rc = cudaFuncSetAttribute(conv4d_small_tf32_kernel<O, CIN, COUT, MODE>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(conv4d_small_tf32_kernel<O, CIN, COUT, MODE>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  conv4d_small_tf32_kernel<O, CIN, COUT, MODE><<<(unsigned)blocks, NTHREADS, smem, st>>>(
      (const float*)x, (const uint4*)frag, bias, (O*)out, s);
  return cudaGetLastError();
}

template <typename O>
cudaError_t dispatch_tf32(int cin, int cout, int mode, const void* x, const void* frag,
                          const float* bias, void* out, int64_t blocks, const Shape& s,
                          cudaStream_t st) {
#define P2P_CASE(CI, CO, M)                   \
  if (cin == CI && cout == CO && mode == M) \
    return launch_tf32<O, CI, CO, M>(x, frag, bias, out, blocks, s, st);
  P2P_MMA_CASES(P2P_CASE)
#undef P2P_CASE
  return cudaErrorInvalidValue;
}

template <typename O>
cudaError_t attrs_tf32(int cin, int cout, int mode, cudaFuncAttributes* a, int* dyn) {
#define P2P_CASE(CI, CO, M)                                                     \
  if (cin == CI && cout == CO && mode == M) {                                   \
    *dyn = DimsF<CI, CO>::SMEM;                                                 \
    return cudaFuncGetAttributes(a, conv4d_small_tf32_kernel<O, CI, CO, M>);  \
  }
  P2P_MMA_CASES(P2P_CASE)
#undef P2P_CASE
  return cudaErrorInvalidValue;
}

// Whether this input may take staging mode 1 (see above): channels-last
// CIN 4, a position of 4 elements ``align`` bytes aligned.
inline bool channels_last4(const void* x, int align, int cin, long long sn, long long sc,
                           long long sk, long long sl) {
  return ((uintptr_t)x % align) == 0 && cin == 4 && sc == 1 && sl == 4 && sn % 4 == 0 &&
         sk % 4 == 0;
}

// The kernels' launch geometry in s (mt output rows a tile); the block count, or -1 where the
// shape or strides are refused.
inline int64_t plan(Shape& s, int mt, int batch, int h1, int w1, int h2, int w2, int cin,
                    long long sn, long long sc, long long sk, long long sl) {
  if (batch <= 0 || h1 <= 0 || w1 <= 0 || h2 <= 0 || w2 <= 0) return -1;
  s.h1 = h1;
  s.w1 = w1;
  s.h2 = h2;
  s.w2 = w2;
  // strips of J = 3*groups - 2 cells: 16 where w1 allows, fewer for a
  // narrow w1 (one cell at w1 = 1)
  s.groups = min(GMAX, (w1 + 4) / 3);
  const int J = 3 * s.groups - 2;
  s.strips = (w1 + J - 1) / J;
  s.tiles_x = (w2 + MW - 1) / MW;
  s.tiles = s.tiles_x * ((h2 + mt - 1) / mt);
  s.sn = sn;
  // offsets inside a cell are 32-bit in the kernels
  if (sc < 0 || sk < 0 || sl < 0 ||
      (cin - 1) * sc + (h2 - 1) * sk + (w2 - 1) * sl > 0x7fffffffLL)
    return -1;
  s.sc = (int)sc;
  s.sk = (int)sk;
  s.sl = (int)sl;
  const int64_t blocks = (int64_t)batch * h1 * s.strips * s.tiles;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

}  // namespace mma

}  // namespace

// Every entry point: x read at element offset n*sn + ci*sc + k*sk + l*sl
// for flat cell n = (b*h1 + i)*w1 + j; bias: (cout,) float32; out float32
// (odtype 0) or bfloat16 (odtype 1). Each returns a cudaError_t. The first
// two: out (B*h1*w1, cout, h2, w2) contiguous; cin and cout > 2 with
// cin*cout <= 16; mode: the staging (0 any strides, 1 channels-last CIN 4,
// refused where x is not so).

// The bf16 kernel: x bfloat16 (dtype 1); frag: the banded filter's B
// fragments, int32 (9, KS, NT, 2, 32) from ops/conv4d_small.py
// mma_fragments.
extern "C" int p2p_conv4d_small_mma(const void* x, const void* frag, const void* bias,
                                    void* out, int batch, int h1, int w1, int h2, int w2,
                                    int cin, int cout, long long sn, long long sc,
                                    long long sk, long long sl, int dtype, int odtype,
                                    int mode, void* stream) {
  if (dtype != 1 || (mode != 0 && !(mode == 1 && mma::channels_last4(x, 8, cin, sn, sc, sk, sl))))
    return (int)cudaErrorInvalidValue;
  mma::Shape s;
  const int64_t blocks = mma::plan(s, mma::MT, batch, h1, w1, h2, w2, cin, sn, sc, sk, sl);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (odtype == 1)
    return (int)mma::dispatch<__nv_bfloat16>(cin, cout, mode, x, frag, bf, out, blocks, s, st);
  if (odtype == 0)
    return (int)mma::dispatch<float>(cin, cout, mode, x, frag, bf, out, blocks, s, st);
  return (int)cudaErrorInvalidValue;
}

// The float32 kernel: x float32 (dtype 0); frag: the banded filter's hi
// and lo B fragments, float32 (9, KS, NT, 32, 4) from ops/conv4d_small.py
// tf32_fragments.
extern "C" int p2p_conv4d_small_tf32(const void* x, const void* frag, const void* bias,
                                     void* out, int batch, int h1, int w1, int h2, int w2,
                                     int cin, int cout, long long sn, long long sc,
                                     long long sk, long long sl, int dtype, int odtype,
                                     int mode, void* stream) {
  if (dtype != 0 ||
      (mode != 0 && !(mode == 1 && mma::channels_last4(x, 16, cin, sn, sc, sk, sl))))
    return (int)cudaErrorInvalidValue;
  mma::Shape s;
  const int64_t blocks = mma::plan(s, mma::MT, batch, h1, w1, h2, w2, cin, sn, sc, sk, sl);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (odtype == 1)
    return (int)mma::dispatch_tf32<__nv_bfloat16>(cin, cout, mode, x, frag, bf, out, blocks,
                                                  s, st);
  if (odtype == 0)
    return (int)mma::dispatch_tf32<float>(cin, cout, mode, x, frag, bf, out, blocks, s, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel for CIN 1 (the NCN's first layer): x bfloat16, read at
// element offset n*sn + k*sk + l*sl; frag: the Cin-1 banded filter's B
// fragments, int32 (9, 1, NT, 2, 32) from ops/conv4d_small.py
// mma_fragments; out: (B, h1, w1, h2, w2, cout) contiguous, channels-last.
// cout 4, 10 or 16. mode: the staging (0 any strides; 2 the l stride 1,
// the cell and k strides and w2 multiples of 8, x 16-byte aligned,
// refused where x is not so).
extern "C" int p2p_conv4d_cin1(const void* x, const void* frag, const void* bias, void* out,
                               int batch, int h1, int w1, int h2, int w2, int cout,
                               long long sn, long long sk, long long sl, int odtype, int mode,
                               void* stream) {
  if (mode == 2 && !((uintptr_t)x % 16 == 0 && sl == 1 && sn % 8 == 0 && sk % 8 == 0 &&
                     w2 % 8 == 0))
    return (int)cudaErrorInvalidValue;
  mma::Shape s;
  const int64_t blocks = mma::plan(s, mma::MT1, batch, h1, w1, h2, w2, 1, sn, 0, sk, sl);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  const float* bf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (odtype == 1)
    return (int)mma::dispatch_cin1<__nv_bfloat16>(cout, mode, x, frag, bf, out, blocks, s, st);
  if (odtype == 0)
    return (int)mma::dispatch_cin1<float>(cout, mode, x, frag, bf, out, blocks, s, st);
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

// The same for the float32 kernel, and the dynamic shared memory it
// launches with.
extern "C" int p2p_conv4d_small_tf32_attrs(int cin, int cout, int odtype, int mode,
                                           void* regs, void* smem, void* dyn_smem,
                                           void* local) {
  cudaFuncAttributes a;
  int dyn = 0;
  const cudaError_t rc = odtype == 1
                             ? mma::attrs_tf32<__nv_bfloat16>(cin, cout, mode, &a, &dyn)
                             : mma::attrs_tf32<float>(cin, cout, mode, &a, &dyn);
  if (rc != cudaSuccess) return (int)rc;
  *(int*)regs = a.numRegs;
  *(int*)smem = (int)a.sharedSizeBytes;
  *(int*)dyn_smem = dyn;
  *(int*)local = (int)a.localSizeBytes;
  return 0;
}

// Registers a thread, dynamic shared memory and local (spill) memory
// bytes a block of the CIN 1 kernel for (cout, odtype, staging mode).
extern "C" int p2p_conv4d_cin1_attrs(int cout, int odtype, int mode, void* regs,
                                     void* dyn_smem, void* local) {
  cudaFuncAttributes a;
  int dyn = 0;
  const cudaError_t rc = odtype == 1 ? mma::attrs_cin1<__nv_bfloat16>(cout, mode, &a, &dyn)
                                     : mma::attrs_cin1<float>(cout, mode, &a, &dyn);
  if (rc != cudaSuccess) return (int)rc;
  *(int*)regs = a.numRegs;
  *(int*)dyn_smem = dyn;
  *(int*)local = (int)a.localSizeBytes;
  return 0;
}
