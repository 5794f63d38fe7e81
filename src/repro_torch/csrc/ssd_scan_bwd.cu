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
// Two designs, by dtype (ssd_scan_bwd dispatches; there is no other
// switch, and nothing falls back from one to the other):
//
// bf16: the tensor cores (wgmma), four launches in order on one stream:
//   1. ssd_bwd_states_sm90, grid (chunks x P slices of 64, H, B), one
//      warpgroup: A_cum as a block scan (to the scratch), then S_c = x^T
//      (w B) and L_c = dy^T (e C), w = exp(a - A_cum) dt, e = exp(A_cum),
//      over the chunk's 64-row pieces through a 2-stage cp.async ring
//      (100 KB, two blocks an SM): x and dy exact, MN-major; the weighted
//      B and C made in fp32 and fed as bf16 pairs hi = bf16(v), lo =
//      bf16(v - hi), as the forward's chunk-state kernel does.
//   2. ssd_bwd_pass_sm90, grid (P N / 1024, H, B), the forward's kind of
//      state passing: forward (each S_c replaced by state_in[c]), then in
//      reverse (each L_c by G_c), 4 elements a thread, the loads of 4
//      chunks ahead of their updates; a_c's gradient exp(a_c) <state_in,
//      G_c> as fp64 parts, one a warp (P / 2 a chunk), summed in order
//      by the pair pass.
//   3. ssd_bwd_pairs_sm90<P>, a block a (batch row, chunk, group, head
//      slice), two warpgroups, 195 KB of shared memory at P <= 64 (228 KB
//      at P > 64): one block an SM, 218 registers at P <= 64 and 238
//      above, no spill. It walks the slice's heads in order; per head:
//      * the carried state's terms, two 64-row tiles at a time (one a
//        warpgroup): u = dy_i state_in with the state as a pair of
//        K-major tiles (over the ring's B / x parts), dC_i += exp(A_cum)
//        u, and exp(A_cum) C . u into A_cum's gradient (fp64);
//      * one pass over the causal 64-row tile pairs (i >= j), column tile
//        j by column tile, each pair once, its C_i, dy_i, B_j and x_j
//        through a 2-stage cp.async ring (the next pair's copies running
//        while this one is computed). Warpgroup w takes the columns i in
//        [32 w, 32 w + 32): S^T = B_j C_i^T and dM^T = x_j dy_i^T
//        (m64n32, exact bf16 operands, rows j); on the fp32 fragments l =
//        exp(A_i - A_j) (the argument zeroed above the diagonal before the
//        exponent), M^T = S^T l dt_j, (dM F)^T = dM^T l dt_j, v = dM M and
//        ddt's direct term dM S l. M^T and (dM F)^T go to shared memory as
//        pairs of swizzled tiles (rows j). Then dx_j += M^T dy_i (at P <=
//        64 each warpgroup over its columns i, all of P, the two parts
//        added at the end of the column tile; above, each over all the
//        columns i, its half of P), and warpgroup 0 takes dB_j += (dM F)^T
//        C_i over all 64 columns i, warpgroup 1 dC_i += (dM F) B_j over
//        all 64 rows j ((dM F)^T read K-major for dB, MN-major for dC). v's
//        row and column sums go into A_cum's gradient in fp64 from the same
//        fp32 values (the columns' by a butterfly over the fragment rows,
//        then the warps in order; the rows' a pair at a time through
//        shared memory), so a pair whose rows both lie at or after row k
//        cancels in the reverse cumsum at k. The chunk state's terms start
//        each column tile, G as a pair of K-major tiles: dx_j at w (B_j
//        G^T) + D dy_j (warpgroup 1 at P <= 64; above, each warpgroup on
//        its half of P), dB_j at w (x_j G) and s = B_j . x_j G (warpgroup
//        0);
//      * A_cum's gradient (with a's at the last row) summed in reverse in
//        fp64, a row a thread: ddt, dA's and dD's parts.
//      dx_j is written in bf16 at the end of its column tile; dB_j goes
//      into the slice's fp32 sum (the first head writes it, the others
//      add in head order); dC over the slice's heads stays in shared
//      memory (fp32, 256 x N) and is written once. The warpgroup index is
//      read from lane 0 (warp-uniform to the compiler, so the wgmma under
//      a branch on it stay asynchronous), and block constants, strides
//      and descriptors are made where they are used, not held in
//      registers through the loops.
//   4. ssd_bwd_group_sm90: dB and dC over the slices in order (bf16), dA
//      and dD over their parts in (b, chunk) order.
//   At zamba2's shape it reads 1.02-1.08 ms by CUDA events, device 0.87-
//   0.88 ms (chunk states 0.090, state passing 0.051, pair pass 0.711-
//   0.717, group sums 0.019; fresh_times.py, first thing in a fresh
//   process, NVIDIA H100 80GB HBM3, 700 W), ~17x its bound by device
//   time, against 5.35 ms for the CUDA-core design at the same shape.
//   The pair pass holds
//   most of it: a block an SM, with the barriers of each tile pair and
//   the fragment work between them (exponents, fp64 sums, the pairs'
//   rounding) on the path of every pair.
//   Head slices: the divisor d of H / G (at most 16) whose B nc G d
//   blocks, one an SM, take the fewest rounds times heads a block
//   (bwd_slices). At zamba2's shape (G = 1, H = 80, 20 (b, chunk) groups)
//   one slice of 80 heads leaves 20 blocks for 132 SMs; 16 slices of 5
//   heads give 320 blocks in 3 rounds. The scratch holds the states and
//   their gradients (2 P N fp32 a chunk, 52.4 MB there), dB and dC per
//   slice (2 x 16 x B S G N fp32, 41.9 MB), A_cum, a's and dA's parts:
//   96.4 MB at zamba2's shape, against 272.1 MB for the fp32 design
//   (whose dB and dC are per head: 105 MB each).
//
// fp32: the first, CUDA-core version (wgmma has no fp32 operands; the
//   zamba2 fp32 probe rests on it), six launches, every (Q, Q) tile pair
//   computed twice (for the row outputs and for the column outputs), fp32
//   scratch between the launches:
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
// Determinism (both designs): no float atomics. Every output element and
// every scratch part is written by one thread, every sum runs in a fixed
// order (the group sums of dB/dC and the sums of dA/dD over batch rows and
// chunks go through the scratch and a last pass), so two runs give equal
// bits.
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

// (the CUDA-core kernels are built for fp32 only: bf16 takes the
// tensor-core kernels below)
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
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

// =====================================================================
// bf16: the tensor-core design (wgmma), four launches
// =====================================================================

constexpr int kWg = 128;                 // one warpgroup a block
constexpr int kRowTile = 64;             // rows a tile of the pair pass
constexpr int kPTile = 64;               // P columns a chunk-state block
constexpr int kRTBytes = kRowTile * 128; // a 64-row tile of 64 bf16
constexpr int kSms = 132;                // the H100's SMs (the slice rule)
constexpr int kMaxSlices = 16;           // most head slices of a group

struct Sm90Shape {
  int B, S, H, P, G, Q, nc, nt, nsl;     // nsl: head slices of a group
};

// scratch, carved from one buffer (ssd_scan_bwd_cuda allocates it)
struct Sm90Work {
  float *ss, *lg;      // chunks x P x N: S_c, then state_in; L_c, then G_c
  float *dbp, *dcp;    // slices x B x S x G x N: dB and dC of a slice
  double *dlast;       // chunks x P / 2: a_c's gradient, a part a warp
  double *dapart;      // chunks: dA's part
  float *acum;         // chunks x Q
  float *ddp;          // chunks: dD's part
};

// Head slices of a group: the divisor d of H / G (at most kMaxSlices)
// whose blocks (B nc G d, one an SM) take the fewest rounds times heads a
// block; the fewer slices on a tie.
int bwd_slices(int B, int S, int H, int G, int Q) {
  const int rep = H / G, nc = (S + Q - 1) / Q;
  const long long groups = (long long)B * nc * G;
  int best = 1;
  long long best_cost = -1;
  for (int d = 1; d <= rep && d <= kMaxSlices; ++d) {
    if (rep % d != 0) continue;
    const long long rounds = (groups * d + kSms - 1) / kSms;
    const long long cost = rounds * (rep / d);
    if (best_cost < 0 || cost < best_cost) {
      best = d;
      best_cost = cost;
    }
  }
  return best;
}

__device__ __forceinline__ size_t bh_chunk(int b, int h, int H, int c,
                                           int nc) {
  return ((size_t)b * H + h) * nc + c;
}

// the sum over the 4 lanes of a quad (the lanes of a fragment row), the
// same bits in each
template <typename F>
__device__ __forceinline__ F quad_sum(F v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// a warpgroup's sum, the same bits in every thread: the lanes by
// butterfly, then the four warps in order (red: 4 values)
template <typename F>
__device__ __forceinline__ F wg_sum(F v, F* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                             // red's last readers done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return ((red[0] + red[1]) + red[2]) + red[3];
}

__device__ __forceinline__ float2 bf2(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------
// 1. A_cum, S_c = x^T (w B) and L_c = dy^T (e C) of a chunk's P slice
// ---------------------------------------------------------------------
constexpr int kStStage = 6 * kRTBytes;   // x, dy, B (then hi), lo, C, lo
// a 2-stage ring; A_cum, w, e; warp totals; 1 KB to align: 100 KB
constexpr int kStatesSmem = 2 * kStStage + 3 * kMaxQ * 4 + 16 + 1024;

__global__ void __launch_bounds__(kWg)
ssd_bwd_states_sm90(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const __nv_bfloat16* __restrict__ dy, Sm90Shape sh,
                    Sm90Work w) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* acum_s = reinterpret_cast<float*>(gbase + 2 * kStStage);
  float* w_s = acum_s + kMaxQ;                 // exp(a - A_cum) dt
  float* e_s = w_s + kMaxQ;                    // exp(A_cum)
  float* tot_s = e_s + kMaxQ;                  // the 4 warps' totals

  const int H = sh.H, P = sh.P, G = sh.G, Q = sh.Q;
  const int n_ps = (P + kPTile - 1) / kPTile;
  const int c = blockIdx.x / n_ps, ps = blockIdx.x % n_ps;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = c * Q, rows = min(Q, sh.S - t0);
  const int p0 = ps * kPTile, pc = min(kPTile, P - p0) / 8;
  const size_t row0 = (size_t)b * sh.S + t0;
  const size_t ch = bh_chunk(b, h, H, c, sh.nc);
  const int n_pc = (rows + kRowTile - 1) / kRowTile;   // live pieces

  // piece k's x, dy, B and C rows into stage k % 2 (zero past `rows`)
  auto load_piece = [&](int k) {
    const uint32_t st = base + (k & 1) * kStStage;
    const int r0 = k * kRowTile;
    const size_t xo = (row0 + r0) * H * P + (size_t)h * P + p0;
    const size_t bo = ((row0 + r0) * G + g) * kN;
    sm90::load_rows<kRowTile, 8, kWg>(st, x + xo, (size_t)H * P, rows - r0,
                                      pc, tid);
    sm90::load_rows<kRowTile, 8, kWg>(st + kRTBytes, dy + xo, (size_t)H * P,
                                      rows - r0, pc, tid);
    sm90::load_rows<kRowTile, 8, kWg>(st + 2 * kRTBytes, Bm + bo,
                                      (size_t)G * kN, rows - r0, 8, tid);
    sm90::load_rows<kRowTile, 8, kWg>(st + 4 * kRTBytes, Cm + bo,
                                      (size_t)G * kN, rows - r0, 8, tid);
  };
  load_piece(0);
  sm90::cp_async_commit();

  // A_cum, a block scan: thread t owns rows 2t, 2t + 1; rows past the
  // chunk or S have dt = 0
  const float a_h = A[h];
  const int r0 = 2 * tid;
  const float d0 = r0 < rows ? dt[(row0 + r0) * H + h] : 0.f;
  const float d1 = r0 + 1 < rows ? dt[(row0 + r0 + 1) * H + h] : 0.f;
  const float v0 = d0 * a_h, v1 = d1 * a_h;
  float incl = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) tot_s[warp] = incl;
  __syncthreads();
  float off = 0.f;
  for (int wi = 0; wi < warp; ++wi) off += tot_s[wi];
  const float a0 = (off + excl) + v0, a1 = a0 + v1;
  acum_s[r0] = a0;
  acum_s[r0 + 1] = a1;
  __syncthreads();
  const float a_last = acum_s[Q - 1];
  if (ps == 0) {
    float* ag = w.acum + ch * Q;
    if (r0 < Q) ag[r0] = a0;
    if (r0 + 1 < Q) ag[r0 + 1] = a1;
  }
  w_s[r0] = __expf(a_last - a0) * d0;
  w_s[r0 + 1] = __expf(a_last - a1) * d1;
  e_s[r0] = __expf(a0);
  e_s[r0 + 1] = __expf(a1);

  // S_c (P slice x N) += x^T (w B) and L_c += dy^T (e C), piece by piece:
  // every operand MN-major (rows are q), the weighted B and C as hi + lo
  float sacc[32], lacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = lacc[i] = 0.f;
  for (int k = 0; k < n_pc; ++k) {
    sm90::cp_async_wait<0>();                  // piece k landed
    __syncthreads();                           // ... for every thread; w,
                                               // e; stage k-1 is free
    if (k + 1 < n_pc) load_piece(k + 1);
    sm90::cp_async_commit();
    const uint32_t x_s = base + (k & 1) * kStStage, y_s = x_s + kRTBytes;
    const uint32_t bh_s = y_s + kRTBytes, ch_s = bh_s + 2 * kRTBytes;
    for (int i = tid; i < 2 * kRowTile * 8; i += kWg) {
      const int which = i / (kRowTile * 8), r = (i / 8) % kRowTile;
      const uint32_t hi_s = which ? ch_s : bh_s;
      const float sc = (which ? e_s : w_s)[k * kRowTile + r];
      const uint32_t o = sm90::tile_off(kRowTile, r, i % 8);
      const uint4 u = *reinterpret_cast<const uint4*>(gbase + (hi_s - base) +
                                                      o);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      float v[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(b2[e]);
        v[2 * e] = f.x * sc;
        v[2 * e + 1] = f.y * sc;
      }
      uint4 hi, lo;
      sm90::split8(v, hi, lo);
      *reinterpret_cast<uint4*>(gbase + (hi_s - base) + o) = hi;
      *reinterpret_cast<uint4*>(gbase + (hi_s + kRTBytes - base) + o) = lo;
    }
    sm90::fence_proxy_async();
    __syncthreads();
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = sm90::desc_sw128(x_s + ks * 2048, kRTBytes, 1024);
      sm90::wgmma_ss<64, 1, 1>(
          sacc, da, sm90::desc_sw128(bh_s + ks * 2048, kRTBytes, 1024), 1);
      sm90::wgmma_ss<64, 1, 1>(
          sacc, da,
          sm90::desc_sw128(bh_s + kRTBytes + ks * 2048, kRTBytes, 1024), 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = sm90::desc_sw128(y_s + ks * 2048, kRTBytes, 1024);
      sm90::wgmma_ss<64, 1, 1>(
          lacc, da, sm90::desc_sw128(ch_s + ks * 2048, kRTBytes, 1024), 1);
      sm90::wgmma_ss<64, 1, 1>(
          lacc, da,
          sm90::desc_sw128(ch_s + kRTBytes + ks * 2048, kRTBytes, 1024), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    sm90::fence_regs(lacc);
  }

  float* ssp = w.ss + ch * P * kN;
  float* lgp = w.lg + ch * P * kN;
  const int pr = p0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * (lane % 4);
    if (pr < P) {
      *reinterpret_cast<float2*>(ssp + (size_t)pr * kN + n) =
          make_float2(sacc[4 * j], sacc[4 * j + 1]);
      *reinterpret_cast<float2*>(lgp + (size_t)pr * kN + n) =
          make_float2(lacc[4 * j], lacc[4 * j + 1]);
    }
    if (pr + 8 < P) {
      *reinterpret_cast<float2*>(ssp + (size_t)(pr + 8) * kN + n) =
          make_float2(sacc[4 * j + 2], sacc[4 * j + 3]);
      *reinterpret_cast<float2*>(lgp + (size_t)(pr + 8) * kN + n) =
          make_float2(lacc[4 * j + 2], lacc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------
// 2. the state passing: forward (each S_c replaced by state_in[c]), then
//    in reverse (each L_c by G_c); a_c's gradient exp(a_c) <state_in[c],
//    G_c> as fp64 parts, one a warp. A thread owns 4 elements of (P, N);
//    the loads of 4 chunks are issued before their dependent updates.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ssd_bwd_pass_sm90(Sm90Shape sh, Sm90Work w) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = sh.H, nc = sh.nc, Q = sh.Q;
  const size_t pn = (size_t)sh.P * kN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 st = z;
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 sc[4];
    float dec[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= nc) break;
      const size_t bc = bh_chunk(b, h, H, c0 + k, nc);
      sc[k] = *reinterpret_cast<const float4*>(w.ss + bc * pn + e);
      dec[k] = w.acum[bc * Q + Q - 1];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= nc) break;
      const size_t bc = bh_chunk(b, h, H, c0 + k, nc);
      *reinterpret_cast<float4*>(w.ss + bc * pn + e) = st;
      const float d = __expf(dec[k]);
      st.x = fmaf(d, st.x, sc[k].x);
      st.y = fmaf(d, st.y, sc[k].y);
      st.z = fmaf(d, st.z, sc[k].z);
      st.w = fmaf(d, st.w, sc[k].w);
    }
  }
  float4 gn = z;
  for (int c1 = nc - 1; c1 >= 0; c1 -= 4) {
    float4 lc[4], si[4];
    float dec[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c1 - k < 0) break;
      const size_t bc = bh_chunk(b, h, H, c1 - k, nc);
      lc[k] = *reinterpret_cast<const float4*>(w.lg + bc * pn + e);
      si[k] = *reinterpret_cast<const float4*>(w.ss + bc * pn + e);
      dec[k] = w.acum[bc * Q + Q - 1];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c1 - k < 0) break;
      const size_t bc = bh_chunk(b, h, H, c1 - k, nc);
      *reinterpret_cast<float4*>(w.lg + bc * pn + e) = gn;
      double part = (double)si[k].x * (double)gn.x;
      part = fma((double)si[k].y, (double)gn.y, part);
      part = fma((double)si[k].z, (double)gn.z, part);
      part = fma((double)si[k].w, (double)gn.w, part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      const float d = __expf(dec[k]);
      if (lane == 0)
        w.dlast[bc * (sh.P / 2) + blockIdx.x * 8 + warp] = (double)d * part;
      gn.x = fmaf(d, gn.x, lc[k].x);
      gn.y = fmaf(d, gn.y, lc[k].y);
      gn.z = fmaf(d, gn.z, lc[k].z);
      gn.w = fmaf(d, gn.w, lc[k].w);
    }
  }
}

// ---------------------------------------------------------------------
// 3. the pair pass: a block a (batch row, chunk, group, head slice), two
//    warpgroups walking the slice's heads in order; per head the carried
//    state's terms, then the causal tile pairs (i >= j) column tile by
//    column tile, each pair once (warpgroup w takes its columns i in [32
//    w, 32 w + 32)), then A_cum's gradient through the reversed cumsum
// ---------------------------------------------------------------------
constexpr int kPairWgs = 2;
constexpr int kPairThreads = kPairWgs * kWg;
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kHalf = kRowTile / kPairWgs;    // columns i a warpgroup

template <int P>
struct PairCfg {
  static constexpr int kPW = P <= 64 ? 64 : 128;  // x / dy tile columns
  static constexpr int kKP = P / 16;              // k16 steps over P
  static constexpr int kXB = kPW * 128;           // an x / dy / G tile
  static constexpr int kStage = 2 * kRTBytes + 2 * kXB;  // C, dy, B, x
  // dx_j's accumulator is 64 columns a warpgroup: at P <= 64 all of P on
  // its half of the columns i (the K), at P > 64 its half of P on all the
  // columns i. M^T's pair of tiles lies over the pair's x_j tile where
  // that holds two tiles (P > 64; x_j's last reader is dM^T), else in a
  // region of its own.
  static constexpr bool kNSplit = kPW == 128;
  static constexpr bool kMtOwn = kXB < 2 * kRTBytes;
  // a 2-stage ring; dMF^T's hi and lo; G's hi and lo; M^T's hi and lo
  // (P <= 64); dC over the slice
  // (fp32, 256 x N); A_cum, dt, ddt's direct part (fp32); A_cum's
  // gradient from the rows and the columns and w s (fp64); the warps'
  // column sums (fp64); each warpgroup's row sums of a column tile, of v
  // (fp64) and of ddt's term (fp32); a sum's parts (fp64); each thread's
  // part of dD (fp32); the chunk's first row; 1 KB to align
  static constexpr int kSmem = 2 * kStage + 2 * kRTBytes + 2 * kXB +
                               (kMtOwn ? 2 * kRTBytes : 0) +
                               kMaxQ * kN * 4 + 3 * kMaxQ * 4 +
                               3 * kMaxQ * 8 + kPairWarps * kHalf * 8 +
                               kPairWgs * kRowTile * (8 + 4) +
                               kPairWarps * 8 + kPairThreads * 4 + 8 +
                               1024;
  static_assert(kRowTile * 64 * 4 <= kStage,
                "the last pair's stage holds warpgroup 0's part of dx");
};

// An opaque copy of a value (a shared-memory address, a thread index):
// what is made from it is built where it is used, not hoisted out of the
// loops and held in registers (the wgmma descriptors of a batch of
// products, the indices of code that runs once a head)
__device__ __forceinline__ uint32_t opq(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// a block's sum over kPairWarps warps, the same bits in every thread
template <typename F>
__device__ __forceinline__ F pair_sum(F v, F* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                             // red's last readers done
  const uint32_t t = opq(threadIdx.x);
  if (t % 32 == 0) red[t / 32] = v;
  __syncthreads();
  F s = red[0];
#pragma unroll
  for (int i = 1; i < kPairWarps; ++i) s += red[i];
  return s;
}

// A thread's fragment row lr (and lr + 8) and column offset lc within
// its warpgroup's 64 x N accumulator, made from an opaque copy of the
// thread index: the addresses built from them are recomputed where they
// are used, not held in registers across the loops.
struct Frag {
  int lr, lc;
};
__device__ __forceinline__ Frag frag() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return {((t / 32) % 4) * 16 + (t % 32) / 4, 2 * (t % 4)};
}

// element (r, c) of a 64-row fp32 tile of `ld` columns, 8-float groups
// swizzled by row (conflict-free float2 access from the fragments)
__device__ __forceinline__ int sw8(int r, int c, int ld) {
  return r * ld + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

template <int P>
__global__ void __launch_bounds__(kPairThreads, 1)
ssd_bwd_pairs_sm90(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm,
                   const float* __restrict__ D,
                   const __nv_bfloat16* __restrict__ dy,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                   Sm90Shape sh, Sm90Work w) {
  using Cfg = PairCfg<P>;
  constexpr int kPW = Cfg::kPW, kKP = Cfg::kKP, kXB = Cfg::kXB;
  constexpr int kStage = Cfg::kStage;
  constexpr bool kNSplit = Cfg::kNSplit, kMtOwn = Cfg::kMtOwn;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  auto gen = [&](uint32_t a) { return gbase + (a - base); };
  // stage layout: C_i, dy_i, B_j, x_j; the pre-pass reads only C_i and
  // dy_i, so state_in's pair lies over the B_j / x_j parts of the stages
  const uint32_t fh_s = base + 2 * kStage, fl_s = fh_s + kRTBytes;
  const uint32_t gh_s = fl_s + kRTBytes, gl_s = gh_s + kXB;
  const uint32_t sth_s = base + kRTBytes + kXB, stl_s = sth_s + kStage;
  const uint32_t mto_s = gl_s + kXB;           // M^T's own tiles (P <= 64)
  float* dc_s =
      reinterpret_cast<float*>(gen(mto_s + (kMtOwn ? 2 * kRTBytes : 0)));
  float* acum_s = dc_s + kMaxQ * kN;
  float* dt_s = acum_s + kMaxQ;
  float* ddtd_s = dt_s + kMaxQ;
  double* drow_s = reinterpret_cast<double*>(ddtd_s + kMaxQ);
  double* dcol_s = drow_s + kMaxQ;
  double* ws_s = dcol_s + kMaxQ;
  double* cp_s = ws_s + kMaxQ;                 // warps x 32 columns
  double* vr_s = cp_s + kPairWarps * kHalf;    // warpgroups x 64 rows
  double* red_s = vr_s + kPairWgs * kRowTile;  // kPairWarps
  float* qr_s = reinterpret_cast<float*>(red_s + kPairWarps);  // wgs x 64
  float* dd_s = qr_s + kPairWgs * kRowTile;    // a part a thread
  // the chunk's first row (b S + c Q), read from shared memory where it is
  // used rather than held in registers through the loops
  size_t* row0_s = reinterpret_cast<size_t*>(dd_s + kPairThreads);
  auto pair_row0 = [&](const Sm90Shape&) -> size_t {
    return *reinterpret_cast<const volatile size_t*>(row0_s);
  };

  const int H = sh.H, G = sh.G, Q = sh.Q, nc = sh.nc, nt = sh.nt;
  const int rep = H / G, hs = rep / sh.nsl;
  int bid = blockIdx.x;
  const int sl = bid % sh.nsl;
  bid /= sh.nsl;
  const int g = bid % G;
  bid /= G;
  const int c = bid % nc, b = bid / nc;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the warpgroup, warp-uniform to the compiler (read from lane 0): a
  // branch on it is not divergent, so the wgmma under it stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, tid / kWg, 0);
  const uint32_t co = (uint32_t)(wg * kHalf * 128);  // its columns' rows
  const int qv = min(Q, sh.S - c * Q);
  if (tid == 0) *row0_s = (size_t)b * sh.S + (size_t)c * Q;
  // row strides of x / dy and of B / C, made where they are used
  auto xs = [&]() { return (size_t)opq(H * P); };
  auto bs = [&]() { return (size_t)opq(G * kN); };
  // the slice's dB or dC sum (B S G N fp32 a slice)
  auto slice_of = [&](float* sum) {
    return sum + (size_t)sl * ((size_t)sh.B * sh.S * G * kN);
  };

  // tile it's C and dy rows, and tile jt's B and x rows, of head h into
  // stage st (zero past qv)
  auto load_i = [&](int it, uint32_t st, int h) {
    const int i0 = it * kRowTile, nv = qv - i0;
    const size_t r = pair_row0(sh) + (nv > 0 ? i0 : 0);
    sm90::load_rows<kRowTile, 8, kPairThreads>(st, Cm + (r * G + g) * kN, bs(),
                                               nv, 8, tid);
    sm90::load_rows<kRowTile, kPW / 8, kPairThreads>(
        st + kRTBytes, dy + r * xs() + (size_t)h * P, xs(), nv, P / 8, tid);
  };
  auto load_j = [&](int jt, uint32_t st, int h) {
    const int j0 = jt * kRowTile, nv = qv - j0;
    const size_t r = pair_row0(sh) + (nv > 0 ? j0 : 0);
    sm90::load_rows<kRowTile, 8, kPairThreads>(
        st + kRTBytes + kXB, Bm + (r * G + g) * kN, bs(), nv, 8, tid);
    sm90::load_rows<kRowTile, kPW / 8, kPairThreads>(
        st + 2 * kRTBytes + kXB, x + r * xs() + (size_t)h * P, xs(), nv, P / 8,
        tid);
  };

  for (int e = tid; e < nt * kRowTile * kN / 4; e += kPairThreads)
    reinterpret_cast<float4*>(dc_s)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int hl = 0; hl < hs; ++hl) {
    const int h = g * rep + sl * hs + hl;
    const size_t ch = bh_chunk(b, h, H, c, nc);
    __syncthreads();                           // the last head is done
    load_i(0, base, h);                        // the pre-pass's first tiles
    if (nt > 1) load_i(1, base + kStage, h);
    sm90::cp_async_commit();
    // A_cum (flat past Q), dt (0 past qv), and state_in and G (P x N,
    // fp32) as bf16 pairs of tiles of P rows: the loads of a round (up to
    // 16 values of each a thread) issued before their conversion
    {
      constexpr int kRows = kMaxQ / kPairThreads;      // A_cum, dt rows
      constexpr int kPieces = kPW * 8 / kPairThreads;  // 8-value pieces
      constexpr int kRound = kPieces < 2 ? kPieces : 2;
      const float* si = w.ss + ch * P * kN;
      const float* gg = w.lg + ch * P * kN;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = tid + k * kPairThreads;
        const float av = w.acum[ch * Q + min(r, Q - 1)];
        const float dv = r < qv ? dt[(pair_row0(sh) + r) * H + h] : 0.f;
        if (r < nt * kRowTile) {
          acum_s[r] = av;
          dt_s[r] = dv;
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < kPieces; k0 += kRound) {
        float4 sq[kRound][2], gq[kRound][2];
#pragma unroll
        for (int k = 0; k < kRound; ++k) {
          const int i = tid + (k0 + k) * kPairThreads, pr = min(i / 8, P - 1);
          const float* sp = si + pr * kN + (i % 8) * 8;
          const float* gp = gg + pr * kN + (i % 8) * 8;
          sq[k][0] = *reinterpret_cast<const float4*>(sp);
          sq[k][1] = *reinterpret_cast<const float4*>(sp + 4);
          gq[k][0] = *reinterpret_cast<const float4*>(gp);
          gq[k][1] = *reinterpret_cast<const float4*>(gp + 4);
        }
#pragma unroll
        for (int k = 0; k < kRound; ++k) {
          const int i = tid + (k0 + k) * kPairThreads, pr = i / 8;
          const float z = pr < P ? 1.f : 0.f;   // rows past P: zero
          const float sv[8] = {z * sq[k][0].x, z * sq[k][0].y, z * sq[k][0].z,
                               z * sq[k][0].w, z * sq[k][1].x, z * sq[k][1].y,
                               z * sq[k][1].z, z * sq[k][1].w};
          const float gv[8] = {z * gq[k][0].x, z * gq[k][0].y, z * gq[k][0].z,
                               z * gq[k][0].w, z * gq[k][1].x, z * gq[k][1].y,
                               z * gq[k][1].z, z * gq[k][1].w};
          const uint32_t o = sm90::tile_off(kPW, pr, i % 8);
          uint4 hi, lo;
          sm90::split8(sv, hi, lo);
          *reinterpret_cast<uint4*>(gen(sth_s + o)) = hi;
          *reinterpret_cast<uint4*>(gen(stl_s + o)) = lo;
          sm90::split8(gv, hi, lo);
          *reinterpret_cast<uint4*>(gen(gh_s + o)) = hi;
          *reinterpret_cast<uint4*>(gen(gl_s + o)) = lo;
        }
      }
    }
    // each warpgroup's row sums over a column tile's pairs start at 0 (the
    // column tile's end reads them and sets them back to 0)
    if (tid < kPairWgs * kRowTile) {
      qr_s[tid] = 0.f;
      vr_s[tid] = 0.0;
    }

    // pre-pass, two tiles at a time (warpgroup w takes tile m + w): u =
    // dy_i state_in (the state as hi + lo), dC_i += exp(A_cum) u, and
    // A_cum's gradient from the carried state, exp(A_cum) C . u
    for (int m = 0; m < nt; m += kPairWgs) {
      if (m > 0) {
        __syncthreads();                       // the stages' readers done
        load_i(m, base, h);
        if (m + 1 < nt) load_i(m + 1, base + kStage, h);
        sm90::cp_async_commit();
      }
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      __syncthreads();                         // the tiles and pairs in place
      const int it = m + wg;
      if (it >= nt) continue;
      const Frag f = frag();
      const int lr = f.lr, lc = f.lc;
      const uint32_t c_s = base + wg * kStage;
      float u[32];
      {
        const uint32_t y_s = opq(c_s + kRTBytes), sth = opq(sth_s),
                       stl = opq(stl_s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKP; ++kk) {
        const uint64_t da = sm90::desc_sw128(
            y_s + (kk >> 2) * kRTBytes + (kk & 3) * 32, 16, 1024);
        sm90::wgmma_ss<64, 1>(u, da,
                              sm90::desc_sw128(sth + kk * 2048, kXB, 1024),
                              kk > 0);
        sm90::wgmma_ss<64, 1>(u, da,
                              sm90::desc_sw128(stl + kk * 2048, kXB, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(u);
      }
      const int i0 = it * kRowTile;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = lr + 8 * half;
        const float e = __expf(acum_s[i0 + r]);
        float* dcr = dc_s + (size_t)i0 * kN;
        float t = 0.f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 cv =
              bf2(gen(c_s + sm90::tile_off(kRowTile, r, jj) + lc * 2));
          const float u0 = u[4 * jj + 2 * half], u1 = u[4 * jj + 2 * half + 1];
          t = fmaf(cv.x, u0, t);
          t = fmaf(cv.y, u1, t);
          float2* d2 = reinterpret_cast<float2*>(dcr + sw8(r, 8 * jj + lc, kN));
          float2 dv = *d2;
          dv.x = fmaf(e, u0, dv.x);
          dv.y = fmaf(e, u1, dv.y);
          *d2 = dv;
        }
        t = quad_sum(t);
        if (lane % 4 == 0) drow_s[i0 + r] = (double)(e * t);
      }
    }
    __syncthreads();                           // the state's pair is free

    // the causal tile pairs, column tile jt by column tile, each pair
    // once: S^T = B_j C_i^T and dM^T = x_j dy_i^T (rows j, columns i)
    auto load_pair = [&](int it, int jt, int k) {
      const uint32_t st = base + (k & 1) * kStage;
      load_i(it, st, h);
      load_j(jt, st, h);
    };
    load_pair(0, 0, 0);
    sm90::cp_async_commit();
    int k = 0;
    dd_s[tid] = 0.f;                           // dD's part, this thread's
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kRowTile;
      float dxa[32], dba[32];                  // dx_j's part, dB_j (wg 0)
      uint32_t stg = base;                     // the pair's stage: C_i, dy_i,
                                               // B_j, x_j
      for (int it = jt; it < nt; ++it, ++k) {
        sm90::cp_async_wait<0>();
        sm90::fence_proxy_async();
        __syncthreads();                       // pair k in place; stage
                                               // k-1 and dMF^T free
        {
          int ni = it + 1, nj = jt;
          if (ni == nt) ni = ++nj;
          if (nj < nt) load_pair(ni, nj, k + 1);
        }
        sm90::cp_async_commit();
        const Frag f = frag();
        const int lr = f.lr, lc = f.lc;
        stg = base + (k & 1) * kStage;
        const int i0 = it * kRowTile;
        if (it == jt) {
          // the chunk state's terms, G as hi + lo: dx_j's part starts at
          // w (B_j G^T) + D dy_j over its columns p (at P <= 64 warpgroup
          // 1's holds all of them and warpgroup 0's starts at 0), and
          // warpgroup 0 starts dB_j at w (x_j G) and takes s = B_j . (x_j G)
          // (A_cum is flat past Q: its last row loaded is the chunk's)
          float wr[2], decay[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int jr = j0 + lr + 8 * half;
            decay[half] =
                jr < qv ? __expf(acum_s[nt * kRowTile - 1] - acum_s[jr]) : 0.f;
            wr[half] = decay[half] * dt_s[jr];
          }
          const int pw0 = kNSplit ? 64 * wg : 0;  // dx_j's first column p
          if (kNSplit || wg == 1) {
            const uint32_t b1 = opq((stg + kRTBytes + kXB)), gh = opq(gh_s + pw0 * 128),
                           gl = opq(gl_s + pw0 * 128);
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t da = sm90::desc_sw128(b1 + kk * 32, 16, 1024);
              sm90::wgmma_ss<64, 0>(
                  dxa, da, sm90::desc_sw128(gh + kk * 32, 16, 1024), kk > 0);
              sm90::wgmma_ss<64, 0>(
                  dxa, da, sm90::desc_sw128(gl + kk * 32, 16, 1024), 1);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(dxa);
            const float dh = D != nullptr ? D[h] : 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = lr + 8 * half;
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) {
                const float2 yv = bf2(gen(
                    (stg + kRTBytes) + sm90::tile_off(kRowTile, r, pw0 / 8 + jj) + lc * 2));
                float& d0 = dxa[4 * jj + 2 * half];
                float& d1 = dxa[4 * jj + 2 * half + 1];
                d0 = fmaf(dh, yv.x, wr[half] * d0);
                d1 = fmaf(dh, yv.y, wr[half] * d1);
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < 32; ++i) dxa[i] = 0.f;
          }
          if (wg == 0) {
            const uint32_t x1 = opq((stg + 2 * kRTBytes + kXB)), gh = opq(gh_s), gl = opq(gl_s);
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kKP; ++kk) {
              const uint64_t da = sm90::desc_sw128(
                  x1 + (kk >> 2) * kRTBytes + (kk & 3) * 32, 16, 1024);
              sm90::wgmma_ss<64, 1>(
                  dba, da, sm90::desc_sw128(gh + kk * 2048, kXB, 1024),
                  kk > 0);
              sm90::wgmma_ss<64, 1>(
                  dba, da, sm90::desc_sw128(gl + kk * 2048, kXB, 1024), 1);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(dba);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = lr + 8 * half, jr = j0 + r;
              float sp = 0.f;
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) {
                const float2 bv =
                    bf2(gen((stg + kRTBytes + kXB) + sm90::tile_off(kRowTile, r, jj) + lc * 2));
                sp = fmaf(bv.x, dba[4 * jj + 2 * half], sp);
                sp = fmaf(bv.y, dba[4 * jj + 2 * half + 1], sp);
                dba[4 * jj + 2 * half] *= wr[half];
                dba[4 * jj + 2 * half + 1] *= wr[half];
              }
              const float sj = quad_sum(sp);
              if (lane % 4 == 0) {
                ddtd_s[jr] = decay[half] * sj;
                ws_s[jr] = (double)(wr[half] * sj);
              }
            }
          }
          // dD's part: dy_j . x_j over this thread's 16-byte chunks (the
          // tiles are 0 past P)
          float dsum = dd_s[tid];
          for (int i = opq(threadIdx.x); i < kRowTile * (kPW / 8);
               i += kPairThreads) {
            const uint32_t o = sm90::tile_off(kRowTile, i / (kPW / 8),
                                              i % (kPW / 8));
            const uint4 yv = *reinterpret_cast<const uint4*>(gen((stg + kRTBytes) + o));
            const uint4 xv = *reinterpret_cast<const uint4*>(gen((stg + 2 * kRTBytes + kXB) + o));
            const __nv_bfloat162* y2 =
                reinterpret_cast<const __nv_bfloat162*>(&yv);
            const __nv_bfloat162* x2 =
                reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 a = __bfloat1622float2(y2[e]);
              const float2 bb = __bfloat1622float2(x2[e]);
              dsum = fmaf(a.x, bb.x, dsum);
              dsum = fmaf(a.y, bb.y, dsum);
            }
          }
          dd_s[tid] = dsum;
        }

        // this warpgroup's 32 columns i: rows co / 128 .. + 31 of C_i, dy_i
        float sT[16], dmT[16];
        {                                      // (descriptors made per step)
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_ss<32, 0>(
                sT, sm90::desc_sw128(opq((stg + kRTBytes + kXB) + kk * 32), 16, 1024),
                sm90::desc_sw128(opq(stg + co + kk * 32), 16, 1024), kk > 0);
#pragma unroll
          for (int kk = 0; kk < kKP; ++kk) {
            const uint32_t ko = (kk >> 2) * kRTBytes + (kk & 3) * 32;
            sm90::wgmma_ss<32, 0>(
                dmT, sm90::desc_sw128(opq((stg + 2 * kRTBytes + kXB) + ko), 16, 1024),
                sm90::desc_sw128(opq((stg + kRTBytes) + co + ko), 16, 1024), kk > 0);
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sT);
        sm90::fence_regs(dmT);
        // M^T's pair of tiles: over x_j (P > 64) once every product that
        // reads x_j is done
        const uint32_t mth = kMtOwn ? mto_s : (stg + 2 * kRTBytes + kXB), mtl = mth + kRTBytes;
        if (!kMtOwn) __syncthreads();

        // on the fragments: l = exp(A_i - A_j) (0 above the diagonal, the
        // argument zeroed before the exponent), M^T = S^T l dt_j and
        // (dM F)^T = dM^T l dt_j, each as a pair of swizzled tiles (rows
        // j), v = dM M, ddt's direct term dM S l
        float ajr[2], dtr[2], qacc[2] = {0.f, 0.f};
        double vacc[2] = {0.0, 0.0};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          ajr[half] = acum_s[j0 + lr + 8 * half];
          dtr[half] = dt_s[j0 + lr + 8 * half];
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          double colv[4];                      // its columns 8 (t / 2) +
#pragma unroll                                 // lc + t % 2 of the slice
          for (int qq = 0; qq < 4; ++qq) {
            const int a = 8 * ks + 2 * qq, half = qq & 1;
            const int cc = wg * kHalf + 16 * ks + 8 * (qq >> 1) + lc;
            const int jr = j0 + lr + 8 * half;
            float m2[2], f2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ir = i0 + cc + e;
              const bool live = ir >= jr && ir < Q;
              const float arg = live ? acum_s[ir] - ajr[half] : 0.f;
              const float l = live ? __expf(arg) : 0.f;
              const float ldt = l * dtr[half];
              const float s = sT[a + e], dm = dmT[a + e];
              m2[e] = s * ldt;
              f2[e] = dm * ldt;
              qacc[half] += dm * s * l;
              const double dv = (double)(dm * m2[e]);
              vacc[half] += dv;
              double& cv = colv[2 * (qq >> 1) + e];
              cv = half == 0 ? dv : cv + dv;
            }
            const uint32_t o =
                sm90::tile_off(kRowTile, lr + 8 * half, cc >> 3) + lc * 2;
            uint32_t hi, lo;
            sm90::split2(m2[0], m2[1], hi, lo);
            *reinterpret_cast<uint32_t*>(gen(mth + o)) = hi;
            *reinterpret_cast<uint32_t*>(gen(mtl + o)) = lo;
            sm90::split2(f2[0], f2[1], hi, lo);
            *reinterpret_cast<uint32_t*>(gen(fh_s + o)) = hi;
            *reinterpret_cast<uint32_t*>(gen(fl_s + o)) = lo;
          }
          // v's sums over the rows j of these columns: the warp's 16 rows
          // by butterfly, then the warpgroup's four warps in order (below)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            double v = colv[t];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4)
              cp_s[warp * kHalf + 16 * ks + 8 * (t >> 1) + lc + (t & 1)] = v;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float q = quad_sum(qacc[half]);
          const double v = quad_sum(vacc[half]);
          if (lane % 4 == 0) {
            qr_s[wg * kRowTile + lr + 8 * half] += q;
            vr_s[wg * kRowTile + lr + 8 * half] += v;
          }
        }
        sm90::fence_proxy_async();
        __syncthreads();                       // M^T, dMF^T, column sums

        // dx_j += M^T dy_i (M^T's tiles K-major; at P <= 64 on this
        // warpgroup's columns i, all of P; above, on all the columns i,
        // its half of P); warpgroup 0: dB_j += (dM F)^T C_i over all 64
        // columns i; warpgroup 1: dC_i += (dM F) B_j over all 64 rows j
        // (dMF^T's tiles read K-major for dB, MN-major for dC)
        {
          const uint32_t fh = opq(fh_s), fl = opq(fl_s);
          sm90::wgmma_fence();
          if (kNSplit) {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {    // (descriptors made per step)
              const uint64_t db = sm90::desc_sw128(
                  opq((stg + kRTBytes) + wg * kRTBytes + ks * 2048), kRTBytes, 1024);
              sm90::wgmma_ss<64, 1>(
                  dxa, sm90::desc_sw128(opq(mth + ks * 32), 16, 1024), db, 1);
              sm90::wgmma_ss<64, 1>(
                  dxa, sm90::desc_sw128(opq(mtl + ks * 32), 16, 1024), db, 1);
            }
          } else {
            const uint32_t y1 = opq((stg + kRTBytes) + co), m1 = opq(mth + wg * kHalf * 2),
                           m2 = opq(mtl + wg * kHalf * 2);
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              const uint64_t db =
                  sm90::desc_sw128(y1 + ks * 2048, kRTBytes, 1024);
              sm90::wgmma_ss<64, 1>(
                  dxa, sm90::desc_sw128(m1 + ks * 32, 16, 1024), db, 1);
              sm90::wgmma_ss<64, 1>(
                  dxa, sm90::desc_sw128(m2 + ks * 32, 16, 1024), db, 1);
            }
          }
          if (wg == 0) {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {    // (descriptors made per step)
              const uint64_t db = sm90::desc_sw128(opq(stg + ks * 2048),
                                                   kRTBytes, 1024);
              sm90::wgmma_ss<64, 1>(
                  dba, sm90::desc_sw128(opq(fh_s + ks * 32), 16, 1024), db, 1);
              sm90::wgmma_ss<64, 1>(
                  dba, sm90::desc_sw128(opq(fl_s + ks * 32), 16, 1024), db, 1);
            }
          }
          sm90::wgmma_commit();
        }
        // A_cum's gradient from the rows of tile i: column c's sums of the
        // four warps of the warpgroup that owns it, in order
        if (tid < kRowTile) {
          const double* cq = cp_s + (tid / kHalf) * 4 * kHalf + tid % kHalf;
          drow_s[i0 + tid] += ((cq[0] + cq[kHalf]) + cq[2 * kHalf]) +
                              cq[3 * kHalf];
        }
        if (wg == 1) {
          // warpgroup 1 holds no dB_j: its dB registers take dC_i's part
          float (&dcq)[32] = dba;
          {
            const uint32_t b1 = opq((stg + kRTBytes + kXB)), fh = opq(fh_s), fl = opq(fl_s);
            sm90::wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              const uint64_t db =
                  sm90::desc_sw128(b1 + ks * 2048, kRTBytes, 1024);
              sm90::wgmma_ss<64, 1, 1>(
                  dcq, sm90::desc_sw128(fh + ks * 2048, kRTBytes, 1024), db,
                  ks > 0);
              sm90::wgmma_ss<64, 1, 1>(
                  dcq, sm90::desc_sw128(fl + ks * 2048, kRTBytes, 1024), db,
                  1);
            }
            sm90::wgmma_commit();
          }
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dcq);
          float* dcr = dc_s + (size_t)i0 * kN;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = lr + 8 * half;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              float2* d2 = reinterpret_cast<float2*>(dcr + sw8(r, 8 * jj + lc, kN));
              float2 dv = *d2;
              dv.x += dcq[4 * jj + 2 * half];
              dv.y += dcq[4 * jj + 2 * half + 1];
              *d2 = dv;
            }
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dxa);
        sm90::fence_regs(dba);
      }

      // rows j of the tile: ddt's direct part and A_cum's gradient from
      // the columns (the two warpgroups' row sums in order); dx_j in bf16
      // (at P <= 64 warpgroup 0's part is staged over the last pair's
      // stage and warpgroup 1 adds its own to it; above, each writes its
      // half of P); warpgroup 0 adds dB_j into the slice's sum (the first
      // head writes it, the others add in order)
      const Frag f = frag();
      const int lr = f.lr, lc = f.lc;
      __syncthreads();                         // the last pair's stage free
      float* sx = reinterpret_cast<float*>(gen(stg));   // 64 x 64
      if (!kNSplit) {
        if (wg == 0) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = lr + 8 * half;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              *reinterpret_cast<float2*>(sx + sw8(r, 8 * jj + lc, 64)) =
                  make_float2(dxa[4 * jj + 2 * half],
                              dxa[4 * jj + 2 * half + 1]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = lr + 8 * half, jr = j0 + r;
        if (wg == 1 && lane % 4 == 0) {
          ddtd_s[jr] += qr_s[r] + qr_s[kRowTile + r];
          dcol_s[jr] = -(vr_s[r] + vr_s[kRowTile + r]) - ws_s[jr];
          qr_s[r] = qr_s[kRowTile + r] = 0.f;
          vr_s[r] = vr_s[kRowTile + r] = 0.0;
        }
        if (jr >= qv) continue;
        const int pw0 = kNSplit ? 64 * wg : 0;
        if (kNSplit || wg == 1) {
          __nv_bfloat16* dst =
              dx + (pair_row0(sh) + jr) * xs() + (size_t)h * P + pw0;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = 8 * jj + lc;
            float2 v = make_float2(dxa[4 * jj + 2 * half],
                                   dxa[4 * jj + 2 * half + 1]);
            if (!kNSplit) {
              const float2 o =
                  *reinterpret_cast<const float2*>(sx + sw8(r, c, 64));
              v.x = o.x + v.x;
              v.y = o.y + v.y;
            }
            if (pw0 + c < P)
              *reinterpret_cast<__nv_bfloat162*>(dst + c) =
                  __floats2bfloat162_rn(v.x, v.y);
          }
        }
      }
      if (wg == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jr = j0 + lr + 8 * half;
          if (jr >= qv) continue;
          float* bd = slice_of(w.dbp) + ((pair_row0(sh) + jr) * G + g) * kN;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            float2* d2 = reinterpret_cast<float2*>(bd + 8 * jj + lc);
            float2 o = make_float2(dba[4 * jj + 2 * half],
                                   dba[4 * jj + 2 * half + 1]);
            if (hl > 0) {
              const float2 prev = *d2;
              o.x = prev.x + o.x;
              o.y = prev.y + o.y;
            }
            *d2 = o;
          }
        }
      }
    }

    // A_cum's gradient (rows plus columns; a's at the last row: the state
    // passing's parts, then the chunk states' sum of w s) summed in
    // reverse over the chunk in fp64, a row a thread: ddt, dA's and dD's
    // parts (thread indices made anew: this runs once a head)
    __syncthreads();
    const int tid = opq(threadIdx.x), lane = tid % 32, warp = tid / 32;
    double dl = 0.0;
    if (warp == 0) {
      const double* pp = w.dlast + ch * (P / 2);
      double v = lane < P / 2 ? pp[lane] : 0.0;
      if (lane + 32 < P / 2) v += pp[lane + 32];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      dl = v;
    }
    const double wsum = pair_sum(tid < nt * kRowTile ? ws_s[tid] : 0.0,
                                 red_s);
    const int r = Q - 1 - tid;
    double d = r >= 0 ? drow_s[r] + dcol_s[r] : 0.0;
    if (tid == 0) d += dl + wsum;
    double incl = d;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    __syncthreads();                           // red's last readers done
    if (lane == 31) red_s[warp] = incl;
    __syncthreads();
    double off = 0.0;
    for (int wi = 0; wi < warp; ++wi) off += red_s[wi];
    const double sacc = off + incl;
    double da = 0.0;
    if (r >= 0) {
      if (r < qv)
        ddt[(pair_row0(sh) + r) * H + h] =
            (float)fma((double)A[h], sacc, (double)ddtd_s[r]);
      da = (double)dt_s[r] * sacc;
    }
    da = pair_sum(da, red_s);
    const float dd = pair_sum(dd_s[tid], reinterpret_cast<float*>(red_s));
    if (tid == 0) {
      w.dapart[ch] = da;
      w.ddp[ch] = dd;
    }
  }

  // dC over the slice's heads, rows inside S
  __syncthreads();
  for (int e = opq(threadIdx.x); e < qv * (kN / 4); e += kPairThreads) {
    const int R = e / (kN / 4), c4 = (e % (kN / 4)) * 4;
    *reinterpret_cast<float4*>(slice_of(w.dcp) +
                               ((pair_row0(sh) + R) * G + g) * kN + c4) =
        *reinterpret_cast<const float4*>(dc_s + sw8(R, c4, kN));
  }
}

// ---------------------------------------------------------------------
// 4. dB and dC over a group's head slices, in slice order; dA and dD
//    over their parts in (b, chunk) order
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ssd_bwd_group_sm90(__nv_bfloat16* __restrict__ dB,
                   __nv_bfloat16* __restrict__ dC, float* __restrict__ dA,
                   float* __restrict__ dD, Sm90Shape sh, Sm90Work w) {
  const int tid = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = tid; h < sh.H; h += 256) {
      double a = 0.0;
      float d = 0.f;
      for (int b = 0; b < sh.B; ++b)
        for (int c = 0; c < sh.nc; ++c) {
          const size_t ch = bh_chunk(b, h, sh.H, c, sh.nc);
          a += w.dapart[ch];
          d += w.ddp[ch];
        }
      dA[h] = (float)a;
      if (dD != nullptr) dD[h] = d;
    }
    return;
  }
  const size_t total = (size_t)sh.B * sh.S * sh.G * kN;
  const size_t e = ((size_t)blockIdx.x * 256 + tid) * 4;
  if (e >= total) return;
  float4 sb = *reinterpret_cast<const float4*>(w.dbp + e);
  float4 sc = *reinterpret_cast<const float4*>(w.dcp + e);
  for (int s = 1; s < sh.nsl; ++s) {
    const float4 vb = *reinterpret_cast<const float4*>(w.dbp + s * total + e);
    const float4 vc = *reinterpret_cast<const float4*>(w.dcp + s * total + e);
    sb.x += vb.x; sb.y += vb.y; sb.z += vb.z; sb.w += vb.w;
    sc.x += vc.x; sc.y += vc.y; sc.z += vc.z; sc.w += vc.w;
  }
  __nv_bfloat162* b2 = reinterpret_cast<__nv_bfloat162*>(dB + e);
  __nv_bfloat162* c2 = reinterpret_cast<__nv_bfloat162*>(dC + e);
  b2[0] = __floats2bfloat162_rn(sb.x, sb.y);
  b2[1] = __floats2bfloat162_rn(sb.z, sb.w);
  c2[0] = __floats2bfloat162_rn(sc.x, sc.y);
  c2[1] = __floats2bfloat162_rn(sc.z, sc.w);
}

template <int P>
int launch_sm90(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* D, const void* dy, void* dx,
                void* ddt, void* dA, void* dB, void* dC, void* dD,
                void* work, int B, int S, int H, int G, int Q,
                cudaStream_t s) {
  static bool set1[64] = {}, set3[64] = {};
  const int nc = (S + Q - 1) / Q;
  Sm90Shape sh{B, S, H, P, G, Q, nc, (Q + kRowTile - 1) / kRowTile,
               bwd_slices(B, S, H, G, Q)};
  const size_t chunks = (size_t)B * H * nc, pn = (size_t)P * kN;
  const size_t bsgn = (size_t)B * S * G * kN;
  Sm90Work w;
  float* p = (float*)work;
  w.ss = p; p += chunks * pn;
  w.lg = p; p += chunks * pn;
  w.dbp = p; p += sh.nsl * bsgn;
  w.dcp = p; p += sh.nsl * bsgn;
  double* d = (double*)p;
  w.dlast = d; d += chunks * (P / 2);
  w.dapart = d; d += chunks;
  p = (float*)d;
  w.acum = p; p += chunks * Q;
  w.ddp = p;
  cudaError_t err = sm90::allow_smem(ssd_bwd_states_sm90, kStatesSmem, set1);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(ssd_bwd_pairs_sm90<P>, PairCfg<P>::kSmem, set3);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const int n_ps = (P + kPTile - 1) / kPTile;
  ssd_bwd_states_sm90<<<dim3(nc * n_ps, H, B), kWg, kStatesSmem, s>>>(
      (const bf*)x, (const float*)dt, (const float*)A, (const bf*)Bm,
      (const bf*)Cm, (const bf*)dy, sh, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_pass_sm90<<<dim3(P * kN / 1024, H, B), 256, 0, s>>>(sh, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_pairs_sm90<P><<<(unsigned)((size_t)B * nc * G * sh.nsl),
                          kPairThreads, PairCfg<P>::kSmem, s>>>(
      (const bf*)x, (const float*)dt, (const float*)A, (const bf*)Bm,
      (const bf*)Cm, (const float*)D, (const bf*)dy, (bf*)dx, (float*)ddt,
      sh, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((bsgn / 4 + 255) / 256) + 1;
  ssd_bwd_group_sm90<<<blocks, 256, 0, s>>>(
      (bf*)dB, (bf*)dC, (float*)dA, (float*)dD, sh, w);
  return (int)cudaGetLastError();
}

int dispatch_sm90(int P, const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* D,
                  const void* dy, void* dx, void* ddt, void* dA, void* dB,
                  void* dC, void* dD, void* work, int B, int S, int H, int G,
                  int Q, cudaStream_t s) {
#define REPRO_SSD_BWD_SM90(PP)                                              \
  if (P == PP)                                                              \
    return launch_sm90<PP>(x, dt, A, Bm, Cm, D, dy, dx, ddt, dA, dB, dC, dD, \
                           work, B, S, H, G, Q, s);
  REPRO_SSD_BWD_SM90(32)
  REPRO_SSD_BWD_SM90(64)
  REPRO_SSD_BWD_SM90(96)
  REPRO_SSD_BWD_SM90(128)
#undef REPRO_SSD_BWD_SM90
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC). work is the
// scratch, 8-byte aligned (and 16-byte in bf16): in fp32 B H nc (6 Q + 2 P
// N + 4 + 3 nt) + 2 B S H N floats, nt = ceil(Q / 64); in bf16 B H nc (2
// P N + P + Q + 3) + 2 nsl B S G N floats, nsl =
// ssd_scan_bwd_sm90_slices(B, S, H, G, Q); nc = ceil(S / Q). D and dD may
// be null (together). bf16 x, B, C and dy must be 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 = cudaSuccess); shapes
// are checked by the caller, other configurations return
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
  if (dtype == 1) {
    if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    return dispatch_sm90(P, x, dt, A, Bm, Cm, D, dy, dx, ddt, dA, dB, dC, dD,
                         work, B, S, H, G, Q, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Rows a tile of the bf16 pair pass: what ssd_scan_bwd_tiled_plain
// models (BWD_ROW_TILE in kernels/ssd_scan/ssd_scan.py).
extern "C" int ssd_scan_bwd_sm90_tile() { return kRowTile; }
// Head slices of a group in the bf16 pair pass (the scratch holds dB and
// dC per slice).
extern "C" int ssd_scan_bwd_sm90_slices(int B, int S, int H, int G, int Q) {
  if (B <= 0 || S <= 0 || G <= 0 || H <= 0 || H % G != 0 || Q <= 0)
    return -1;
  return bwd_slices(B, S, H, G, Q < S ? Q : S);
}
// Dynamic shared memory (bytes) of the bf16 chunk-state kernel (0) and
// pair kernel (1) at head dim P; -1 otherwise.
extern "C" int ssd_scan_bwd_sm90_smem(int kernel, int P) {
  if (kernel == 0) return kStatesSmem;
  if (kernel != 1) return -1;
  return P == 32    ? PairCfg<32>::kSmem
         : P == 64  ? PairCfg<64>::kSmem
         : P == 96  ? PairCfg<96>::kSmem
         : P == 128 ? PairCfg<128>::kSmem
                    : -1;
}
