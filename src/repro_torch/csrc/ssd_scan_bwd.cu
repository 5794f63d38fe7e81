// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu), written for
// sm_90a.
//
// Replaces no TPU kernel. The JAX package trains Mamba2 layers by
// differentiating ref.py::ssd_chunked (src/repro/models/ssm.py pins the
// scan to "reference"), so its backward is whatever XLA makes of that
// program. A GPU training step needs a backward for kernel 8, and this is
// it. Held against kernels/ssd_scan/ssd_scan.py::ssd_scan_bwd_plain,
// which writes the same arithmetic out step by step (and which the CPU
// tests hold against jax.vjp of ref.py::ssd_chunked).
//
// Computes, for the forward's x (B, S, H, P), B/C (B, S, G, N) and dy
// (B, S, H, P) in T (fp32 or bf16), dt (B, S, H), A (H,) and D (H,) (or
// null) in fp32, chunks of Q = min(chunk_size, S) rows, the final state's
// cotangent taken as 0 (training drops the state), with A_cum the
// inclusive cumsum of dt A over a chunk, a its last row, F_ij =
// exp(A_cum_i - A_cum_j) dt_j for i >= j (0 above the diagonal), M =
// (C B^T) F and dM = dy x^T:
//   1. per chunk, the state it adds, S_c = sum_j exp(a - A_cum_j) dt_j
//      x_j B_j^T, and its output's gradient on its incoming state, L_c =
//      sum_i exp(A_cum_i) dy_i C_i^T (P x N each);
//   2. the state passing: state_in[0] = 0, state_in[c+1] = exp(a_c)
//      state_in[c] + S_c; then in reverse G_c, the gradient of S_c (0 for
//      the last chunk), G_{c-1} = L_c + exp(a_c) G_c, and a_c's gradient
//      exp(a_c) <state_in[c], G_c>;
//   3. per chunk, row side: dC = (dM F) B + exp(A_cum) dy state_in, and
//      A_cum's gradient from the rows: rowsum(dM M) + exp(A_cum) C .
//      (dy state_in);
//   4. per chunk, column side: dx = M^T dy + exp(a - A_cum) dt G B + D dy,
//      dB = (dM F)^T C + exp(a - A_cum) dt G^T x, ddt's direct part
//      colsum(dM (C B^T) exp(A_cum_i - A_cum_j)) + exp(a - A_cum) x^T G B,
//      A_cum's gradient from the columns (minus dt times that colsum,
//      minus exp(a - A_cum) dt x^T G B), a's from the chunk state (the
//      sum of the latter), and dD's part, sum dy . x;
//   5. A_cum's gradient, with a's added at the chunk's last row, summed
//      in reverse over the chunk (the cumsum's transpose): ddt = its
//      direct part + A that, and dA's part sum dt that;
//   6. dB and dC summed over the H / G heads of a group; dA and dD over
//      batch rows and chunks.
// dx, dB and dC come out in T; ddt (B, S, H), dA (H,) and dD (H,) in
// fp32. Rows past S read as dt = x = B = C = dy = 0, as in the forward.
// N = 64, P a multiple of 32 up to 128, Q <= 256, G dividing H.
//
// What bounds it on the H100, at zamba2's training microbatch (B=5,
//   S=1024, H=80, P=64, N=64, G=1, Q=256, bf16): bytes read once and
//   written once are x, dy and dx (52.4 MB each), B, C, dB and dC (0.66
//   MB each), dt and ddt (1.6 MB each): ~163 MB, 49 us at 3.35 TB/s. The
//   operations are those of the function, counted on the causal half of
//   each chunk (Q (Q + 1) / 2 pairs): five pair products (C B^T and its
//   weighted product with C and B, N multiply-adds a pair each; dy x^T
//   and M^T dy, P each) and five (Q, P, N) products for the states (S_c,
//   L_c, dy state_in, G B, x G): ~50 GFLOP, 51 us on the tensor cores'
//   989 TFLOP/s. So its bound is about 0.05 ms, operations and bytes
//   within 5% of each other: the bf16 tensor cores could reach it only
//   with both in one pass.
//
// What this design does about that bound: little, on purpose. It is the
//   first, simple version: fp32 arithmetic on the CUDA cores (~60 TFLOP/s
//   of FMA, so ~0.8 ms at best for its ~50 GFLOP, ~60 GFLOP as it runs
//   them: the (Q, Q) products are taken on 64 x 64 tiles, so the
//   diagonal tiles' upper halves count too), six launches in order
//   on one stream, and fp32 scratch between them (the chunk states and
//   their gradients, P N a chunk; dB and dC per head, B S H N each, 105 MB
//   apiece at zamba2's shape, written once and read once). Every (Q, Q)
//   tile pair is recomputed twice (once for the row outputs, once for the
//   column outputs), so no (Q, Q) matrix reaches device memory and no
//   output needs an atomic. Its tensor-core redesign (wgmma on bf16
//   operands, one pass over the tile pairs) is on ROADMAP's speed list.
//   * ssd_bwd_states, a block a chunk: A_cum (a sequential scan in shared
//     memory), S_c and L_c over 64-row tiles in shared memory, a thread
//     owning P/16 x 4 elements of each.
//   * ssd_bwd_pass, a block a (b, h): the state passing forward (each
//     S_c overwritten by state_in[c]) and in reverse (each L_c by G_c),
//     the a_c gradient as a fixed-order block sum.
//   * ssd_bwd_rows, a block a (chunk, 64-row tile i): the tile pairs (i,
//     j <= i) in order, C B^T and dy x^T by 4 x 4 register tiles, dC by
//     (dM F) B through shared memory.
//   * ssd_bwd_cols, a block a (chunk, 64-row tile j): the tile pairs (i
//     >= j, j) in order, dx by M^T dy and dB by (dM F)^T C.
//   * ssd_bwd_dt, a block a chunk: the reverse cumsum, ddt and dA's part.
//   * ssd_bwd_final: dB and dC over a group's heads in head order; dA and
//     dD over their parts in (b, chunk, tile) order.
//   Shared-memory tiles are padded to 65 floats a row, and a thread owns
//   rows ty + 16 ii and columns tx + 16 jj of a 64-wide tile, so the 16
//   lanes of a row group read 16 banks and the two row groups of a warp
//   read broadcasts.
//
// Determinism: no float atomics. Every output element and every scratch
// part is written by one thread, every sum runs in a fixed order (the
// group sum of dB/dC and the sums of dA/dD over batch rows and chunks go
// through the fp32 scratch and a last pass), so two runs give equal bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int kN = 64;           // state dim
constexpr int kTile = 64;        // rows a tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kMaxQ = 256;       // largest chunk
constexpr int kMaxP = 128;       // largest head dim
constexpr int kLd = kN + 1;      // padded shared row of an N-wide tile
constexpr int kLdT = kTile + 1;  // padded shared row of a 64-wide tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Shape {
  int B, S, H, P, G, Q, nc, nt;
};

// scratch, carved from one buffer (ssd_scan_bwd_cuda allocates it): A_cum's
// gradient and what sums into dA in fp64, the rest fp32
struct Work {
  double *drow, *dcol;                // chunks x Q each
  double *dlast, *dapart;             // chunks each
  double *lastp;                      // chunks x nt
  float *acum, *ddtp;                 // chunks x Q each
  float *ss, *lg;                     // chunks x P x N each
  float *ddp;                         // chunks x nt
  float *dbh, *dch;                   // B x S x H x N each
};

// chunk-major index of (b, h, c)
struct Chunk {
  int b, h, c, g, qv;                 // qv: rows of the chunk inside S
  size_t row0;                        // b * S + c * Q
  __device__ Chunk(const Shape& sh, int ch) {
    c = ch % sh.nc;
    const int bh = ch / sh.nc;
    h = bh % sh.H;
    b = bh / sh.H;
    g = h / (sh.H / sh.G);
    qv = min(sh.Q, sh.S - c * sh.Q);
    row0 = (size_t)b * sh.S + (size_t)c * sh.Q;
  }
};

// rows i0 .. i0 + 63 of a chunk's (rows, F) slice into shared memory
// (row stride ldd), each times scale[r] if given; rows at or past nv as 0
template <typename T, int F>
__device__ __forceinline__ void load_tile(float* dst, int ldd,
                                          const T* __restrict__ src,
                                          size_t stride, size_t base, int i0,
                                          int nv, const float* scale,
                                          int tid) {
  for (int e = tid; e < kTile * F; e += kThreads) {
    const int r = e / F, f = e % F;
    float v = 0.f;
    if (r < nv) {
      v = to_f(src[base + (size_t)(i0 + r) * stride + f]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ldd + f] = v;
  }
}

// a block's sum, in a fixed order; the result in thread 0
template <typename F>
__device__ __forceinline__ F block_sum(F v, F* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int tid = threadIdx.x;
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  F s = 0;
  if (tid == 0)
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

// the sum over the 16 lanes tx of a row group (lanes of one half-warp)
template <typename F>
__device__ __forceinline__ F row_group_sum(F v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A causal pair (i >= j)'s terms, taken by the row side and the column
// side with the same operations: l = exp(A_cum_i - A_cum_j) (0 above the
// diagonal), m = (C_i . B_j) l dt_j (M's entry) and v = dM_ij m, its
// term in A_cum's gradient (+v at row i, -v at row j). The two sums of
// v are taken in fp64 from these same fp32 values, so a pair whose rows
// both lie at or after row k cancels exactly in the reverse cumsum at k:
// only the pairs that straddle k are left, which is how the gradient of
// A (a small sum of large terms: the reference path's fp32 autograd is
// ~8e-5 off its own fp64 version on zamba2's A_log) keeps its digits.
struct Pair {
  float l, m, v;
  __device__ __forceinline__ Pair(bool live, float ai, float aj, float dt,
                                  float cb, float dm) {
    l = live ? expf(ai - aj) : 0.f;
    m = cb * (l * dt);
    v = dm * m;
  }
};

// ---------------------------------------------------------------------
// 1. A_cum, the chunk states S_c and the incoming-state gradients L_c
// ---------------------------------------------------------------------
template <int P>
constexpr int states_smem() {
  return (int)sizeof(float) *
         (3 * kMaxQ + 2 * kTile * (P + 1) + 2 * kTile * kLd);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const T* __restrict__ dy, Shape sh,
               Work w) {
  constexpr int kLdP = P + 1, kPR = P / 16;
  extern __shared__ float sm[];
  float* acum_s = sm;
  float* wt_s = acum_s + kMaxQ;          // exp(a - A_cum) dt
  float* ea_s = wt_s + kMaxQ;            // exp(A_cum)
  float* xw = ea_s + kMaxQ;              // x times wt
  float* dye = xw + kTile * kLdP;        // dy times exp(A_cum)
  float* bt = dye + kTile * kLdP;
  float* ct = bt + kTile * kLd;
  const int ch = blockIdx.x;
  const Chunk k(sh, ch);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a_h = A[k.h];
  for (int i = tid; i < sh.Q; i += kThreads)
    acum_s[i] = i < k.qv ? dt[(k.row0 + i) * sh.H + k.h] * a_h : 0.f;
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < sh.Q; ++i) {
      run += acum_s[i];
      acum_s[i] = run;
    }
  }
  __syncthreads();
  const float a_last = acum_s[sh.Q - 1];
  for (int i = tid; i < sh.Q; i += kThreads) {
    const float dti = i < k.qv ? dt[(k.row0 + i) * sh.H + k.h] : 0.f;
    wt_s[i] = expf(a_last - acum_s[i]) * dti;
    ea_s[i] = expf(acum_s[i]);
    w.acum[(size_t)ch * sh.Q + i] = acum_s[i];
  }

  float sacc[kPR][4], lacc[kPR][4];
#pragma unroll
  for (int a = 0; a < kPR; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sacc[a][b] = lacc[a][b] = 0.f;
  const size_t xs = (size_t)sh.H * P, bs = (size_t)sh.G * kN;
  const size_t xb = (k.row0 * sh.H + k.h) * P;
  const size_t bb = (k.row0 * sh.G + k.g) * kN;
  for (int i0 = 0; i0 < sh.Q; i0 += kTile) {
    const int nv = k.qv - i0;
    __syncthreads();
    load_tile<T, P>(xw, kLdP, x, xs, xb, i0, nv, wt_s + i0, tid);
    load_tile<T, P>(dye, kLdP, dy, xs, xb, i0, nv, ea_s + i0, tid);
    load_tile<T, kN>(bt, kLd, Bm, bs, bb, i0, nv, nullptr, tid);
    load_tile<T, kN>(ct, kLd, Cm, bs, bb, i0, nv, nullptr, tid);
    __syncthreads();
    const int rows = min(kTile, max(nv, 0));
    for (int j = 0; j < rows; ++j) {
      float xv[kPR], dv[kPR], bv[4], cv[4];
#pragma unroll
      for (int a = 0; a < kPR; ++a) {
        xv[a] = xw[j * kLdP + ty + 16 * a];
        dv[a] = dye[j * kLdP + ty + 16 * a];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        bv[b] = bt[j * kLd + tx + 16 * b];
        cv[b] = ct[j * kLd + tx + 16 * b];
      }
#pragma unroll
      for (int a = 0; a < kPR; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          sacc[a][b] = fmaf(xv[a], bv[b], sacc[a][b]);
          lacc[a][b] = fmaf(dv[a], cv[b], lacc[a][b]);
        }
    }
  }
  float* ss = w.ss + (size_t)ch * P * kN;
  float* lg = w.lg + (size_t)ch * P * kN;
#pragma unroll
  for (int a = 0; a < kPR; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int idx = (ty + 16 * a) * kN + tx + 16 * b;
      ss[idx] = sacc[a][b];
      lg[idx] = lacc[a][b];
    }
}

// ---------------------------------------------------------------------
// 2. the state passing, forward then in reverse
// ---------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass(Shape sh, Work w) {
  constexpr int kE = P * kN / kThreads;
  __shared__ double red[kThreads / 32];
  const int bh = blockIdx.x, tid = threadIdx.x;
  float state[kE], gnext[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) state[e] = gnext[e] = 0.f;
  for (int c = 0; c < sh.nc; ++c) {
    const size_t ch = (size_t)bh * sh.nc + c;
    const float e_a = expf(w.acum[ch * sh.Q + sh.Q - 1]);
    float* ss = w.ss + ch * P * kN;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int idx = tid + e * kThreads;
      const float add = ss[idx];
      ss[idx] = state[e];
      state[e] = fmaf(e_a, state[e], add);
    }
  }
  for (int c = sh.nc - 1; c >= 0; --c) {
    const size_t ch = (size_t)bh * sh.nc + c;
    const float e_a = expf(w.acum[ch * sh.Q + sh.Q - 1]);
    const float* ss = w.ss + ch * P * kN;
    float* lg = w.lg + ch * P * kN;
    double part = 0.0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int idx = tid + e * kThreads;
      const float loc = lg[idx];
      lg[idx] = gnext[e];
      part = fma((double)ss[idx], (double)gnext[e], part);
      gnext[e] = fmaf(e_a, gnext[e], loc);
    }
    part = block_sum(part, red);
    if (tid == 0) w.dlast[ch] = e_a * part;
  }
}

// ---------------------------------------------------------------------
// 3. row side: dC and A_cum's gradient from the rows
// ---------------------------------------------------------------------
template <int P>
constexpr int rows_smem() {
  return (int)sizeof(float) *
         (2 * kTile * kLd + 2 * kTile * (P + 1) + kTile * kLdT + P * kLd +
          3 * kTile);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rows(const T* __restrict__ x, const float* __restrict__ dt,
             const T* __restrict__ Bm, const T* __restrict__ Cm,
             const T* __restrict__ dy, Shape sh, Work w) {
  constexpr int kLdP = P + 1;
  extern __shared__ float sm[];
  float* ci = sm;
  float* bj = ci + kTile * kLd;
  float* dyi = bj + kTile * kLd;
  float* xj = dyi + kTile * kLdP;
  float* dcb = xj + kTile * kLdP;
  float* sst = dcb + kTile * kLdT;
  float* ai = sst + P * kLd;
  float* aj = ai + kTile;
  float* dtj = aj + kTile;
  const int it = blockIdx.x % sh.nt, ch = blockIdx.x / sh.nt;
  const Chunk k(sh, ch);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = it * kTile;
  const size_t xs = (size_t)sh.H * P, bs = (size_t)sh.G * kN;
  const size_t xb = (k.row0 * sh.H + k.h) * P;
  const size_t bb = (k.row0 * sh.G + k.g) * kN;
  const float* acum = w.acum + (size_t)ch * sh.Q;
  load_tile<T, kN>(ci, kLd, Cm, bs, bb, i0, k.qv - i0, nullptr, tid);
  load_tile<T, P>(dyi, kLdP, dy, xs, xb, i0, k.qv - i0, nullptr, tid);
  const float* ss = w.ss + (size_t)ch * P * kN;
  for (int e = tid; e < P * kN; e += kThreads)
    sst[(e / kN) * kLd + e % kN] = ss[e];
  for (int r = tid; r < kTile; r += kThreads)
    ai[r] = i0 + r < sh.Q ? acum[i0 + r] : 0.f;
  __syncthreads();

  // the carried state's terms: u = dy state_in (64 x N)
  float dc[4][4];
  double rowp[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dc[a][b] = 0.f;
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    float dv[4], sv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) dv[a] = dyi[(ty + 16 * a) * kLdP + p];
#pragma unroll
    for (int b = 0; b < 4; ++b) sv[b] = sst[p * kLd + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dc[a][b] = fmaf(dv[a], sv[b], dc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const float e_i = i0 + r < sh.Q ? expf(ai[r]) : 0.f;
    float t = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      t = fmaf(ci[r * kLd + tx + 16 * b], dc[a][b], t);
      dc[a][b] *= e_i;
    }
    rowp[a] = (double)(e_i * t);
  }

  // the tile pairs (i, j <= i), in order
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();                   // the last pair's tiles consumed
    load_tile<T, kN>(bj, kLd, Bm, bs, bb, j0, k.qv - j0, nullptr, tid);
    load_tile<T, P>(xj, kLdP, x, xs, xb, j0, k.qv - j0, nullptr, tid);
    for (int r = tid; r < kTile; r += kThreads) {
      aj[r] = j0 + r < sh.Q ? acum[j0 + r] : 0.f;
      dtj[r] = j0 + r < k.qv ? dt[(k.row0 + j0 + r) * sh.H + k.h] : 0.f;
    }
    __syncthreads();
    float cb[4][4], dm[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) cb[a][b] = dm[a][b] = 0.f;
#pragma unroll 4
    for (int n = 0; n < kN; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = ci[(ty + 16 * a) * kLd + n];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = bj[(tx + 16 * b) * kLd + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) cb[a][b] = fmaf(cv[a], bv[b], cb[a][b]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float dv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = dyi[(ty + 16 * a) * kLdP + p];
#pragma unroll
      for (int b = 0; b < 4; ++b) xv[b] = xj[(tx + 16 * b) * kLdP + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) dm[a][b] = fmaf(dv[a], xv[b], dm[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int cc = tx + 16 * b, j = j0 + cc;
        const Pair pr(i >= j && i < sh.Q, ai[r], aj[cc], dtj[cc], cb[a][b],
                      dm[a][b]);
        rowp[a] += (double)pr.v;
        dcb[r * kLdT + cc] = dm[a][b] * (pr.l * dtj[cc]);
      }
    }
    __syncthreads();
    // dC += (dM F) B_j
#pragma unroll 4
    for (int cc = 0; cc < kTile; ++cc) {
      float dv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = dcb[(ty + 16 * a) * kLdT + cc];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = bj[cc * kLd + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) dc[a][b] = fmaf(dv[a], bv[b], dc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, i = i0 + r;
    const double rs = row_group_sum(rowp[a]);
    if (tx == 0 && i < sh.Q) w.drow[(size_t)ch * sh.Q + i] = rs;
    if (i < k.qv) {
      float* dst = w.dch + ((k.row0 + i) * sh.H + k.h) * kN;
#pragma unroll
      for (int b = 0; b < 4; ++b) dst[tx + 16 * b] = dc[a][b];
    }
  }
}

// ---------------------------------------------------------------------
// 4. column side: dx, dB, ddt's direct part, A_cum's gradient from the
//    columns, a's from the chunk state, dD's part
// ---------------------------------------------------------------------
template <int P>
constexpr int cols_smem() {
  constexpr int kU = 4 * kTile * kLdT > P * kLd ? 4 * kTile * kLdT
                                                : P * kLd;
  return (int)sizeof(float) *
         (2 * kTile * kLd + 2 * kTile * (P + 1) + kU + 4 * kTile +
          kThreads / 32);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cols(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ D, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const T* __restrict__ dy,
             T* __restrict__ dx, Shape sh, Work w) {
  constexpr int kLdP = P + 1, kPR = P / 16;
  constexpr int kU = 4 * kTile * kLdT > P * kLd ? 4 * kTile * kLdT
                                                : P * kLd;
  extern __shared__ float sm[];
  float* bj = sm;
  float* ci = bj + kTile * kLd;
  float* xj = ci + kTile * kLd;
  float* dyi = xj + kTile * kLdP;
  float* un = dyi + kTile * kLdP;     // G (P x N), then M, dM F,
  float* m_s = un;                    // dM C B^T L and the pairs' v
  float* dcb_s = un + kTile * kLdT;
  float* q_s = un + 2 * kTile * kLdT;
  float* v_s = un + 3 * kTile * kLdT;
  float* aj = un + kU;
  float* dtj = aj + kTile;
  float* ai = dtj + kTile;
  float* sj_s = ai + kTile;
  float* red = sj_s + kTile;          // kThreads / 32 floats
  const int jt = blockIdx.x % sh.nt, ch = blockIdx.x / sh.nt;
  const Chunk k(sh, ch);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int j0 = jt * kTile;
  const size_t xs = (size_t)sh.H * P, bs = (size_t)sh.G * kN;
  const size_t xb = (k.row0 * sh.H + k.h) * P;
  const size_t bb = (k.row0 * sh.G + k.g) * kN;
  const float* acum = w.acum + (size_t)ch * sh.Q;
  const float a_last = acum[sh.Q - 1];
  load_tile<T, kN>(bj, kLd, Bm, bs, bb, j0, k.qv - j0, nullptr, tid);
  load_tile<T, P>(xj, kLdP, x, xs, xb, j0, k.qv - j0, nullptr, tid);
  const float* gs = w.lg + (size_t)ch * P * kN;
  for (int e = tid; e < P * kN; e += kThreads)
    un[(e / kN) * kLd + e % kN] = gs[e];
  for (int r = tid; r < kTile; r += kThreads) {
    aj[r] = j0 + r < sh.Q ? acum[j0 + r] : 0.f;
    dtj[r] = j0 + r < k.qv ? dt[(k.row0 + j0 + r) * sh.H + k.h] : 0.f;
  }
  __syncthreads();

  // the chunk state's terms: G B_j (64 x P) and x_j G (64 x N)
  float dxa[4][kPR], dba[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < kPR; ++b) dxa[a][b] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) dba[a][b] = 0.f;
  }
#pragma unroll 4
  for (int n = 0; n < kN; ++n) {
    float bv[4], gv[kPR];
#pragma unroll
    for (int a = 0; a < 4; ++a) bv[a] = bj[(ty + 16 * a) * kLd + n];
#pragma unroll
    for (int b = 0; b < kPR; ++b) gv[b] = un[(tx + 16 * b) * kLd + n];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kPR; ++b) dxa[a][b] = fmaf(bv[a], gv[b], dxa[a][b]);
  }
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    float xv[4], gv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xv[a] = xj[(ty + 16 * a) * kLdP + p];
#pragma unroll
    for (int b = 0; b < 4; ++b) gv[b] = un[p * kLd + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dba[a][b] = fmaf(xv[a], gv[b], dba[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    float sp = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) sp = fmaf(bj[r * kLd + tx + 16 * b],
                                          dba[a][b], sp);
    const float s = row_group_sum(sp);
    if (tx == 0) sj_s[r] = s;
    const float wj = j0 + r < k.qv ? expf(a_last - aj[r]) * dtj[r] : 0.f;
#pragma unroll
    for (int b = 0; b < kPR; ++b) dxa[a][b] *= wj;
#pragma unroll
    for (int b = 0; b < 4; ++b) dba[a][b] *= wj;
  }

  // the tile pairs (i >= j, j), in order
  float qsum = 0.f;                    // threads 0..63: column tid
  double vsum = 0.0;
  for (int it = jt; it < sh.nt; ++it) {
    const int i0 = it * kTile;
    __syncthreads();                   // G / the last pair consumed
    load_tile<T, kN>(ci, kLd, Cm, bs, bb, i0, k.qv - i0, nullptr, tid);
    load_tile<T, P>(dyi, kLdP, dy, xs, xb, i0, k.qv - i0, nullptr, tid);
    for (int r = tid; r < kTile; r += kThreads)
      ai[r] = i0 + r < sh.Q ? acum[i0 + r] : 0.f;
    __syncthreads();
    float cb[4][4], dm[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) cb[a][b] = dm[a][b] = 0.f;
#pragma unroll 4
    for (int n = 0; n < kN; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = ci[(ty + 16 * a) * kLd + n];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = bj[(tx + 16 * b) * kLd + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) cb[a][b] = fmaf(cv[a], bv[b], cb[a][b]);
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float dv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = dyi[(ty + 16 * a) * kLdP + p];
#pragma unroll
      for (int b = 0; b < 4; ++b) xv[b] = xj[(tx + 16 * b) * kLdP + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) dm[a][b] = fmaf(dv[a], xv[b], dm[a][b]);
    }
    // tile rows are i, columns j
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int cc = tx + 16 * b, j = j0 + cc;
        const Pair pr(i >= j && i < sh.Q, ai[r], aj[cc], dtj[cc], cb[a][b],
                      dm[a][b]);
        m_s[r * kLdT + cc] = pr.m;
        dcb_s[r * kLdT + cc] = dm[a][b] * (pr.l * dtj[cc]);
        q_s[r * kLdT + cc] = dm[a][b] * cb[a][b] * pr.l;
        v_s[r * kLdT + cc] = pr.v;
      }
    }
    __syncthreads();
    if (tid < kTile)
      for (int i = 0; i < kTile; ++i) {
        qsum += q_s[i * kLdT + tid];
        vsum += (double)v_s[i * kLdT + tid];
      }
    // output rows are j: dx += M^T dy_i, dB += (dM F)^T C_i
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float mv[4], dv[4], yv[kPR], cv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        mv[a] = m_s[i * kLdT + ty + 16 * a];
        dv[a] = dcb_s[i * kLdT + ty + 16 * a];
      }
#pragma unroll
      for (int b = 0; b < kPR; ++b) yv[b] = dyi[i * kLdP + tx + 16 * b];
#pragma unroll
      for (int b = 0; b < 4; ++b) cv[b] = ci[i * kLd + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < kPR; ++b) dxa[a][b] = fmaf(mv[a], yv[b],
                                                       dxa[a][b]);
#pragma unroll
        for (int b = 0; b < 4; ++b) dba[a][b] = fmaf(dv[a], cv[b],
                                                     dba[a][b]);
      }
    }
  }

  // D dy, dD's part, and the outputs of the tile's rows
  const float dh = D != nullptr ? D[k.h] : 0.f;
  float dpart = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, j = j0 + r;
    if (j >= k.qv) continue;
    const size_t off = ((k.row0 + j) * sh.H + k.h) * P;
#pragma unroll
    for (int b = 0; b < kPR; ++b) {
      const int p = tx + 16 * b;
      const float g = to_f(dy[off + p]);
      dpart = fmaf(g, xj[r * kLdP + p], dpart);
      dx[off + p] = from_f<T>(fmaf(dh, g, dxa[a][b]));
    }
    float* dst = w.dbh + ((k.row0 + j) * sh.H + k.h) * kN;
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[tx + 16 * b] = dba[a][b];
  }
  if (tid < kTile) {
    const int j = j0 + tid;
    const float decay = j < k.qv ? expf(a_last - aj[tid]) : 0.f;
    const float wj = decay * dtj[tid], s = sj_s[tid];
    const float ws = wj * s;            // -ws here, +ws at the last row
    if (j < sh.Q) {
      w.ddtp[(size_t)ch * sh.Q + j] = fmaf(decay, s, qsum);
      w.dcol[(size_t)ch * sh.Q + j] = -vsum - (double)ws;
    }
    sj_s[tid] = ws;
  }
  const float dd = block_sum(dpart, red);
  if (tid == 0) {
    double last = 0.0;
    for (int r = 0; r < kTile; ++r) last += (double)sj_s[r];
    w.lastp[(size_t)ch * sh.nt + jt] = last;
    w.ddp[(size_t)ch * sh.nt + jt] = dd;
  }
}

// ---------------------------------------------------------------------
// 5. through the cumsum: ddt and dA's part
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt(const float* __restrict__ dt, const float* __restrict__ A,
           float* __restrict__ ddt, Shape sh, Work w) {
  __shared__ double d_s[kMaxQ];
  __shared__ float dt_s[kMaxQ];
  const int ch = blockIdx.x;
  const Chunk k(sh, ch);
  const int tid = threadIdx.x;
  const size_t q0 = (size_t)ch * sh.Q;
  for (int i = tid; i < sh.Q; i += kThreads) {
    d_s[i] = w.drow[q0 + i] + w.dcol[q0 + i];
    dt_s[i] = i < k.qv ? dt[(k.row0 + i) * sh.H + k.h] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    double extra = w.dlast[ch];
    for (int t = 0; t < sh.nt; ++t) extra += w.lastp[(size_t)ch * sh.nt + t];
    d_s[sh.Q - 1] += extra;
    double run = 0.0, da = 0.0;
    for (int i = sh.Q - 1; i >= 0; --i) {
      run += d_s[i];
      d_s[i] = run;
    }
    for (int i = 0; i < sh.Q; ++i) da = fma((double)dt_s[i], d_s[i], da);
    w.dapart[ch] = da;
  }
  __syncthreads();
  const float a_h = A[k.h];
  for (int i = tid; i < k.qv; i += kThreads)
    ddt[(k.row0 + i) * sh.H + k.h] =
        (float)fma((double)a_h, d_s[i], (double)w.ddtp[q0 + i]);
}

// ---------------------------------------------------------------------
// 6. dB and dC over a group's heads; dA and dD over their parts
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_final(T* __restrict__ dB, T* __restrict__ dC,
              float* __restrict__ dA, float* __restrict__ dD, Shape sh,
              Work w) {
  const int tid = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = tid; h < sh.H; h += kThreads) {
      double a = 0.0;
      float d = 0.f;
      for (int b = 0; b < sh.B; ++b)
        for (int c = 0; c < sh.nc; ++c) {
          const size_t ch = ((size_t)b * sh.H + h) * sh.nc + c;
          a += w.dapart[ch];
          for (int t = 0; t < sh.nt; ++t) d += w.ddp[ch * sh.nt + t];
        }
      dA[h] = (float)a;
      if (dD != nullptr) dD[h] = d;
    }
    return;
  }
  const size_t e = (size_t)blockIdx.x * kThreads + tid;
  const size_t total = (size_t)sh.B * sh.S * sh.G * kN;
  if (e >= total) return;
  const int n = (int)(e % kN);
  const size_t rest = e / kN;
  const int g = (int)(rest % sh.G);
  const size_t bs = rest / sh.G;                  // b * S + t
  const int rep = sh.H / sh.G;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    const size_t src = (bs * sh.H + (size_t)g * rep + r) * kN + n;
    sb += w.dbh[src];
    sc += w.dch[src];
  }
  dB[e] = from_f<T>(sb);
  dC[e] = from_f<T>(sc);
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* dy, void* dx,
           void* ddt, void* dA, void* dB, void* dC, void* dD, void* work,
           int B, int S, int H, int G, int Q, cudaStream_t s) {
  static bool set1[64] = {}, set3[64] = {}, set4[64] = {};
  Shape sh{B, S, H, P, G, Q, (S + Q - 1) / Q, (Q + kTile - 1) / kTile};
  const size_t chunks = (size_t)B * H * sh.nc;
  const size_t pn = (size_t)P * kN;
  const size_t rows = (size_t)B * S * H * kN;
  Work w;
  double* d = (double*)work;           // the fp64 parts first (aligned)
  w.drow = d; d += chunks * Q;
  w.dcol = d; d += chunks * Q;
  w.dlast = d; d += chunks;
  w.dapart = d; d += chunks;
  w.lastp = d; d += chunks * sh.nt;
  float* p = (float*)d;
  w.acum = p; p += chunks * Q;
  w.ddtp = p; p += chunks * Q;
  w.ss = p; p += chunks * pn;
  w.lg = p; p += chunks * pn;
  w.ddp = p; p += chunks * sh.nt;
  w.dbh = p; p += rows;
  w.dch = p;
  cudaError_t err = sm90::allow_smem(ssd_bwd_states<T, P>, states_smem<P>(),
                                     set1);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(ssd_bwd_rows<T, P>, rows_smem<P>(), set3);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(ssd_bwd_cols<T, P>, cols_smem<P>(), set4);
  if (err != cudaSuccess) return (int)err;
  const T* xt = (const T*)x;
  const T* bt = (const T*)Bm;
  const T* ct = (const T*)Cm;
  const T* gt = (const T*)dy;
  const float* dtf = (const float*)dt;
  const float* af = (const float*)A;
  ssd_bwd_states<T, P><<<(unsigned)chunks, kThreads, states_smem<P>(), s>>>(
      xt, dtf, af, bt, ct, gt, sh, w);
  ssd_bwd_pass<P><<<(unsigned)(B * H), kThreads, 0, s>>>(sh, w);
  const unsigned tiles = (unsigned)(chunks * sh.nt);
  ssd_bwd_rows<T, P><<<tiles, kThreads, rows_smem<P>(), s>>>(
      xt, dtf, bt, ct, gt, sh, w);
  ssd_bwd_cols<T, P><<<tiles, kThreads, cols_smem<P>(), s>>>(
      xt, dtf, (const float*)D, bt, ct, gt, (T*)dx, sh, w);
  ssd_bwd_dt<<<(unsigned)chunks, kThreads, 0, s>>>(dtf, af, (float*)ddt,
                                                   sh, w);
  const size_t total = (size_t)B * S * G * kN;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads) + 1;
  ssd_bwd_final<T><<<blocks, kThreads, 0, s>>>(
      (T*)dB, (T*)dC, (float*)dA, (float*)dD, sh, w);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int P, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, const void* D, const void* dy,
             void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD,
             void* work, int B, int S, int H, int G, int Q, cudaStream_t s) {
#define REPRO_SSD_BWD(PP)                                                  \
  if (P == PP)                                                             \
    return launch<T, PP>(x, dt, A, Bm, Cm, D, dy, dx, ddt, dA, dB, dC, dD, \
                         work, B, S, H, G, Q, s);
  REPRO_SSD_BWD(32)
  REPRO_SSD_BWD(64)
  REPRO_SSD_BWD(96)
  REPRO_SSD_BWD(128)
#undef REPRO_SSD_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC). work is the
// scratch, 8-byte aligned: B H nc (6 Q + 2 P N + 4 + 3 nt) + 2 B S H N
// floats, nc = ceil(S / Q), nt = ceil(Q / 64). D and dD may be null
// (together).
// Returns cudaGetLastError() after the six launches (0 = cudaSuccess);
// shapes are checked by the caller, other configurations return
// cudaErrorInvalidValue without launching.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            const void* dy, void* dx, void* ddt, void* dA,
                            void* dB, void* dC, void* dD, void* work, int B,
                            int S, int H, int P, int G, int N, int Q,
                            int dtype, void* stream) {
  if (N != kN || P <= 0 || P % 32 != 0 || P > kMaxP || Q <= 0 ||
      Q > kMaxQ || B <= 0 || S <= 0 || G <= 0 || H <= 0 || H % G != 0 ||
      work == nullptr || (D == nullptr) != (dD == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(P, x, dt, A, Bm, Cm, D, dy, dx, ddt, dA, dB, dC,
                           dD, work, B, S, H, G, Q, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, x, dt, A, Bm, Cm, D, dy, dx, ddt, dA,
                                   dB, dC, dD, work, B, S, H, G, Q, s);
  return (int)cudaErrorInvalidValue;
}
