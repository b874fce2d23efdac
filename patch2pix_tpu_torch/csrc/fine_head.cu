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
// Bound on the H100: operations. Each conv is a per-proposal implicit
// GEMM (64 positions x 9*C' or 9*F) @ (9*C' or 9*F x F); at F = 512 the
// two are ~0.6 GFLOP per proposal, ~1.46 TFLOP for M = 2400. Design: one
// block per proposal, F threads (one warp per 32 output channels). The
// conv input of the current segment (16 x 16 x C') or conv1's input
// (8 x 8 x F, the BN0 output, which never leaves the chip) sits in shared
// memory. The K loop walks (tap, channel chunk) through two buffers:
// while the warps multiply one chunk, the block gathers the next chunk's
// 64 x KC im2col rows from that tile (zero outside it) and copies its
// KC x F weight rows from global memory (L2-resident) with cp.async;
// every warp updates its 64 x 32 slice of the product, one barrier per
// chunk.
//   bf16: tensor cores, WMMA m16n16k16 with f32 accumulators (four row
//   tiles x two column tiles per warp), seeded from partial0; epilogues go
//   through a per-warp 16 x 16 staging tile.
//   f32: SIMT fmaf, never TF32; each thread owns one output channel's 64
//   sums and reads the im2col chunk as broadcast float4s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int MAX_SEG = 8;
constexpr int PS = 16;      // patch side
constexpr int OH = 8;       // conv output side
constexpr int NPIX = PS * PS;
constexpr int NPOS = OH * OH;

struct Seg {
  const void* rows[2];  // per side: the level's (M, 4, t, t*c) rows
  const void* w;        // (9, cseg, F) conv0 weights of this segment
  int t, c;             // the level's tile side and channels
  int kind;             // 0: both sides paired, 1: side 1 only, 2: side 2 only
  int cseg;             // the segment's channels: 2c if paired, else c
};

struct Args {
  Seg seg[MAX_SEG];
  int n_seg;
  const int* y[2];
  const int* x[2];
  const float* inv[2];    // (M, 16, 16) f32
  const float* partial0;  // (M, 8, 8, F) f32
  const void* wc1;        // (9, F, F)
  const float* bn0s;
  const float* bn0t;
  const float* bn1s;
  const float* bn1t;
  void* out;  // (M, F)
  int f;
  int x_elems;  // elements of the shared conv-input tile
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_f(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v) { return to_f(v, (T*)nullptr); }
template <typename T>
__device__ __forceinline__ float round_to(float v) { return widen(narrow<T>(v)); }

// Offset of pixel (p, q)'s channel 0 inside proposal m's level rows (B3's
// window indexing).
__device__ __forceinline__ int64_t pixel_offset(int m, int p, int q, int y0, int x0, int t,
                                                int c) {
  const int ds = PS / t;
  const int iy = (y0 + p) / ds - (y0 / PS) * t;
  const int ix = (x0 + q) / ds - (x0 / PS) * t;
  const int tile = (iy / t) * 2 + ix / t;
  return ((((int64_t)m * 4 + tile) * t + iy % t) * t + ix % t) * c;
}

// Stage segment s's scaled expansion: X[pix * cseg + ch], rounded to T.
template <typename T>
__device__ __forceinline__ void stage_segment(const Seg& s, T* X, const float* inv_s, int m,
                                              const int* ys, const int* xs) {
  for (int e = threadIdx.x; e < NPIX * s.cseg; e += blockDim.x) {
    const int pix = e / s.cseg, ch = e % s.cseg;
    const int side = s.kind == 0 ? ch / s.c : s.kind - 1;
    const int k = s.kind == 0 ? ch % s.c : ch;
    const T* rows = (const T*)s.rows[side];
    const float v = widen(rows[pixel_offset(m, pix / PS, pix % PS, ys[side], xs[side], s.t,
                                            s.c) + k]);
    X[e] = narrow<T>(__fmul_rn(v, inv_s[side * NPIX + pix]));
  }
}

// The input pixel of conv output position pos at tap (dy, dx), or -1 in
// the zero padding: stride 2 over the 16 x 16 patch, or 1 over 8 x 8.
__device__ __forceinline__ int tap_pixel(int pos, int dy, int dx, int stride, int side) {
  const int py = stride * (pos / OH) - 1 + dy, px = stride * (pos % OH) - 1 + dx;
  return (py >= 0 && py < side && px >= 0 && px < side) ? py * side + px : -1;
}

// ------------------------------------------------------------ K chunks

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage K chunk c = (tap, channels [kc, kc + KC)) of one conv into one
// buffer: the 64 im2col rows from the shared tile X (side x side x cin,
// zero outside it) into As — row-major As[pos * lda + k] by 16-byte
// copies, or k-major As[k * lda + pos] — and the weight rows
// W[tap][kc + k][0:f] into Bs[k * ldb + n] with 16-byte cp.async copies
// (committed as one group). Few instructions per chunk matter: the block
// stages 288 chunks per proposal.
template <typename T, int KC, bool KMAJOR>
__device__ __forceinline__ void stage_chunk(int c, int cin, int stride, int side, const T* X,
                                            const T* W, int f, int lda, int ldb, T* As,
                                            T* Bs) {
  const int nk = cin / KC;
  const int tap = c / nk, kc = (c % nk) * KC;
  const int dy = tap / 3, dx = tap % 3;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  if (KMAJOR) {
    for (int e = threadIdx.x; e < NPOS * KC; e += blockDim.x) {
      const int pos = e / KC, k = e % KC;
      const int pix = tap_pixel(pos, dy, dx, stride, side);
      As[k * lda + pos] = pix >= 0 ? X[pix * cin + kc + k] : narrow<T>(0.0f);
    }
  } else {  // 16-byte copies of im2col rows
    constexpr int PER = KC / VEC;
    for (int e = threadIdx.x; e < NPOS * PER; e += blockDim.x) {
      const int pos = e / PER, q = (e % PER) * VEC;
      const int pix = tap_pixel(pos, dy, dx, stride, side);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (pix >= 0) v = *reinterpret_cast<const uint4*>(&X[pix * cin + kc + q]);
      *reinterpret_cast<uint4*>(&As[pos * lda + q]) = v;
    }
  }
  // blockDim.x == f: each pass copies blockDim.x / per_row = VEC rows
  const int per_row = f / VEC;
  const int n = (threadIdx.x % per_row) * VEC;
  const T* wsrc = W + ((int64_t)tap * cin + kc) * f;
  for (int k = threadIdx.x / per_row; k < KC; k += VEC)
    cp_async16(&Bs[k * ldb + n], &wsrc[(int64_t)k * f + n]);
  cp_async_commit();
}

// One conv over X (side x side x cin) against W (9, cin, F), in K chunks
// through S buffers: chunk c + S - 1 is staged (its weights by cp.async)
// while the warps multiply chunk c with mma(A, B); one barrier per chunk.
template <typename T, int KC, bool KMAJOR, int S, typename Mma>
__device__ __forceinline__ void conv_pipeline(const T* X, int cin, int stride, int side,
                                              const T* W, int f, int lda, int ldb, T* As,
                                              T* Bs, Mma mma) {
  const int nchunks = 9 * (cin / KC);
  const int a_size = KMAJOR ? KC * lda : NPOS * lda, b_size = KC * ldb;
  for (int c = 0; c < S - 1; ++c) {
    if (c < nchunks)
      stage_chunk<T, KC, KMAJOR>(c, cin, stride, side, X, W, f, lda, ldb, As + c * a_size,
                                 Bs + c * b_size);
    else
      cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S - 2>();  // chunk c's copies have landed (this thread's)
    __syncthreads();         // ... everyone's; and chunk c - 1's buffers are free
    const int next = c + S - 1;
    if (next < nchunks)
      stage_chunk<T, KC, KMAJOR>(next, cin, stride, side, X, W, f, lda, ldb,
                                 As + (next % S) * a_size, Bs + (next % S) * b_size);
    else
      cp_async_commit();  // an empty group keeps the count in step
    mma(As + (c % S) * a_size, Bs + (c % S) * b_size);
  }
  cp_async_wait<0>();
  __syncthreads();  // the buffers and X are free for the caller
}

// ------------------------------------------------------------------ bf16

constexpr int KCB = 32;        // K chunk (bf16)
constexpr int LDA = KCB + 8;   // im2col row stride: conflict-free ldmatrix rows

using bf16 = __nv_bfloat16;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int STAGES_B = 2;    // K-chunk buffers (bf16; a third bought nothing)

// One conv as an implicit GEMM into acc (the warp's 64 x 32 slice).
__device__ __forceinline__ void conv_bf16(Acc (&acc)[4][2], const bf16* X, int cin, int stride,
                                          int side, const bf16* W, int f, bf16* As, bf16* Bs) {
  const int ldb = f + 8;
  const int warp = threadIdx.x / 32;
  conv_pipeline<bf16, KCB, false, STAGES_B>(
      X, cin, stride, side, W, f, LDA, ldb, As, Bs, [&](const bf16* A, const bf16* B) {
#pragma unroll
        for (int kk = 0; kk < KCB; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            wmma::load_matrix_sync(fb[ni], &B[kk * ldb + 32 * warp + 16 * ni], ldb);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, &A[16 * mi * LDA + kk], LDA);
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], fa, fb[ni], acc[mi][ni]);
          }
        }
      });
}

__global__ void __launch_bounds__(512) fine_head_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f = a.f, m = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* X = (bf16*)smem;
  size_t off = ((size_t)a.x_elems * sizeof(bf16) + 127) / 128 * 128;
  float* inv_s = (float*)(smem + off);
  off += 2 * NPIX * sizeof(float);
  bf16* As = (bf16*)(smem + off);
  off += STAGES_B * NPOS * LDA * sizeof(bf16);
  bf16* Bs = (bf16*)(smem + off);
  float* stage = (float*)Bs + warp * 256;  // per-warp epilogue tile (aliases Bs)

  int ys[2], xs[2];
  for (int side = 0; side < 2; ++side) {
    ys[side] = max(a.y[side][m], 0);
    xs[side] = max(a.x[side][m], 0);
  }
  for (int e = threadIdx.x; e < 2 * NPIX; e += blockDim.x)
    inv_s[e] = round_to<bf16>(a.inv[e / NPIX][(int64_t)m * NPIX + e % NPIX]);

  Acc acc[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      wmma::load_matrix_sync(acc[mi][ni],
                             a.partial0 + ((int64_t)m * NPOS + 16 * mi) * f + 32 * warp + 16 * ni,
                             f, wmma::mem_row_major);
  __syncthreads();

  // conv0, segment by segment
  for (int s = 0; s < a.n_seg; ++s) {
    stage_segment<bf16>(a.seg[s], X, inv_s, m, ys, xs);
    __syncthreads();
    conv_bf16(acc, X, a.seg[s].cseg, 2, PS, (const bf16*)a.seg[s].w, f, As, Bs);
  }

  // BN0 affine, rounded: X1[pos * f + ch]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      wmma::store_matrix_sync(stage, acc[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int ch = 32 * warp + 16 * ni + e % 16, pos = 16 * mi + e / 16;
        X[pos * f + ch] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(stage[e], a.bn0s[ch]),
                                                         a.bn0t[ch]));
      }
      __syncwarp();
      wmma::fill_fragment(acc[mi][ni], 0.0f);
    }
  __syncthreads();

  // conv1 over the 8 x 8 BN0 output
  conv_bf16(acc, X, f, 1, OH, (const bf16*)a.wc1, f, As, Bs);

  // BN1 affine rounded, ReLU, max over the 64 positions
  bf16* out = (bf16*)a.out;
#pragma unroll
  for (int ni = 0; ni < 2; ++ni) {
    const int ch = 32 * warp + 16 * ni + lane % 16;
    float best = 0.0f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      wmma::store_matrix_sync(stage, acc[mi][ni], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)  // column e % 16 == lane % 16
        best = fmaxf(best, round_to<bf16>(__fadd_rn(__fmul_rn(stage[e], a.bn1s[ch]),
                                                    a.bn1t[ch])));
      __syncwarp();
    }
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 16));
    if (lane < 16) out[(int64_t)m * f + ch] = __float2bfloat16_rn(best);
  }
}

// ------------------------------------------------------------------ f32

constexpr int KCF = 16;         // K chunk (f32)
constexpr int LDAF = NPOS + 4;  // k-major im2col stride: 16-byte rows, 2-way writes

constexpr int STAGES_F = 2;     // K-chunk buffers (f32; three do not fit)

// One conv into acc[64] (this thread's output channel n). As holds the
// im2col chunk k-major, so a warp reads four positions as one broadcast
// float4.
__device__ __forceinline__ void conv_f32(float (&acc)[NPOS], const float* X, int cin,
                                         int stride, int side, const float* W, int f, float* As,
                                         float* Bs) {
  const int n = threadIdx.x;
  conv_pipeline<float, KCF, true, STAGES_F>(
      X, cin, stride, side, W, f, LDAF, f, As, Bs, [&](const float* A, const float* B) {
#pragma unroll 4
        for (int k = 0; k < KCF; ++k) {
          const float b = B[k * f + n];
          const float4* a4 = reinterpret_cast<const float4*>(A + k * LDAF);
#pragma unroll
          for (int p4 = 0; p4 < NPOS / 4; ++p4) {
            const float4 v = a4[p4];
            acc[4 * p4 + 0] = fmaf(v.x, b, acc[4 * p4 + 0]);
            acc[4 * p4 + 1] = fmaf(v.y, b, acc[4 * p4 + 1]);
            acc[4 * p4 + 2] = fmaf(v.z, b, acc[4 * p4 + 2]);
            acc[4 * p4 + 3] = fmaf(v.w, b, acc[4 * p4 + 3]);
          }
        }
      });
}

__global__ void __launch_bounds__(512) fine_head_f32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f = a.f, m = blockIdx.x, n = threadIdx.x;
  float* X = (float*)smem;
  size_t off = ((size_t)a.x_elems * sizeof(float) + 127) / 128 * 128;
  float* inv_s = (float*)(smem + off);
  off += 2 * NPIX * sizeof(float);
  float* As = (float*)(smem + off);
  off += STAGES_F * KCF * LDAF * sizeof(float);
  float* Bs = (float*)(smem + off);

  int ys[2], xs[2];
  for (int side = 0; side < 2; ++side) {
    ys[side] = max(a.y[side][m], 0);
    xs[side] = max(a.x[side][m], 0);
  }
  for (int e = threadIdx.x; e < 2 * NPIX; e += blockDim.x)
    inv_s[e] = a.inv[e / NPIX][(int64_t)m * NPIX + e % NPIX];

  float acc[NPOS];
#pragma unroll
  for (int pos = 0; pos < NPOS; ++pos) acc[pos] = a.partial0[((int64_t)m * NPOS + pos) * f + n];
  __syncthreads();

  for (int s = 0; s < a.n_seg; ++s) {
    stage_segment<float>(a.seg[s], X, inv_s, m, ys, xs);
    __syncthreads();
    conv_f32(acc, X, a.seg[s].cseg, 2, PS, (const float*)a.seg[s].w, f, As, Bs);
  }

  const float s0 = a.bn0s[n], t0 = a.bn0t[n];
#pragma unroll
  for (int pos = 0; pos < NPOS; ++pos) {
    X[pos * f + n] = __fadd_rn(__fmul_rn(acc[pos], s0), t0);
    acc[pos] = 0.0f;
  }
  __syncthreads();

  conv_f32(acc, X, f, 1, OH, (const float*)a.wc1, f, As, Bs);

  const float s1 = a.bn1s[n], t1 = a.bn1t[n];
  float best = 0.0f;
#pragma unroll
  for (int pos = 0; pos < NPOS; ++pos)
    best = fmaxf(best, __fadd_rn(__fmul_rn(acc[pos], s1), t1));
  ((float*)a.out)[(int64_t)m * f + n] = best;
}

}  // namespace

// Per segment (n_seg <= 8): seg_rows1/seg_rows2 the level's rows of each
// side (the unused side may be null), seg_w its (9, cseg, F) weights,
// seg_t/seg_c the level's tile side and channels, seg_kind 0 (paired,
// cseg = 2c), 1 or 2 (one side, cseg = c). y1, x1, y2, x2: (M,) int32
// padded corners; inv1, inv2: (M, 16, 16) f32; partial0: (M, 8, 8, F) f32;
// wc1: (9, F, F); bn*: (F,) f32; out: (M, F). psize must be 16; F a
// multiple of 32 up to 512; every cseg a multiple of 32. dtype: 0 =
// float32, 1 = bfloat16 (rows, weights and out). Returns a cudaError_t.
extern "C" int p2p_fine_head(const void* const* seg_rows1, const void* const* seg_rows2,
                             const void* const* seg_w, const int* seg_t, const int* seg_c,
                             const int* seg_kind, int n_seg, const void* y1, const void* x1,
                             const void* y2, const void* x2, const void* inv1,
                             const void* inv2, const void* partial0, const void* wc1,
                             const void* bn0s, const void* bn0t, const void* bn1s,
                             const void* bn1t, void* out, int m, int psize, int f, int dtype,
                             void* stream) {
  if (n_seg <= 0 || n_seg > MAX_SEG || m <= 0 || psize != PS || f <= 0 || f % 32 != 0 ||
      f > 512) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  int cmax = 0;
  for (int s = 0; s < n_seg; ++s) {
    Seg& g = a.seg[s];
    g.rows[0] = seg_rows1[s];
    g.rows[1] = seg_rows2[s];
    g.w = seg_w[s];
    g.t = seg_t[s];
    g.c = seg_c[s];
    g.kind = seg_kind[s];
    g.cseg = g.kind == 0 ? 2 * g.c : g.c;
    if (g.t <= 0 || PS % g.t != 0 || g.kind < 0 || g.kind > 2 || g.cseg % 32 != 0)
      return (int)cudaErrorInvalidValue;
    if (g.cseg > cmax) cmax = g.cseg;
  }
  a.n_seg = n_seg;
  a.y[0] = (const int*)y1;
  a.x[0] = (const int*)x1;
  a.y[1] = (const int*)y2;
  a.x[1] = (const int*)x2;
  a.inv[0] = (const float*)inv1;
  a.inv[1] = (const float*)inv2;
  a.partial0 = (const float*)partial0;
  a.wc1 = wc1;
  a.bn0s = (const float*)bn0s;
  a.bn0t = (const float*)bn0t;
  a.bn1s = (const float*)bn1s;
  a.bn1t = (const float*)bn1t;
  a.out = out;
  a.f = f;
  a.x_elems = NPIX * cmax > NPOS * f ? NPIX * cmax : NPOS * f;
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem;
  if (dtype == 1) {
    smem = ((size_t)a.x_elems * sizeof(bf16) + 127) / 128 * 128 + 2 * NPIX * sizeof(float) +
           STAGES_B * (NPOS * LDA + (size_t)KCB * (f + 8)) * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(
        fine_head_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fine_head_bf16_kernel<<<m, f, smem, st>>>(a);
  } else if (dtype == 0) {
    smem = ((size_t)a.x_elems * sizeof(float) + 127) / 128 * 128 + 2 * NPIX * sizeof(float) +
           STAGES_F * (KCF * LDAF + (size_t)KCF * f) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fine_head_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fine_head_f32_kernel<<<m, f, smem, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
