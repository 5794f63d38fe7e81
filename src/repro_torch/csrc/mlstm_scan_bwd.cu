// Backward of the xLSTM mLSTM chunkwise-parallel scan (csrc/mlstm_scan.cu),
// written for sm_90a.
//
// Replaces no TPU kernel. The JAX package trains xLSTM stacks by
// differentiating ref.py::mlstm_chunked (src/repro/models/xlstm.py pins the
// scan to "reference"), so its backward is whatever XLA makes of that
// program. A GPU training step needs a backward for kernel 9, and this is
// it. Held against kernels/mlstm_scan/mlstm_scan.py::mlstm_scan_bwd_plain,
// which writes the same arithmetic out step by step (and which the CPU
// tests hold against jax.vjp of ref.py::mlstm_chunked).
//
// Computes, for the forward's q/k (B, S, H, dk), v (B, S, H, dv) and dh
// (B, S, H, dv) in T (fp32 or bf16) and the gate pre-activations i~/f~
// (B, S, H) in fp32, chunks of Q = min(chunk_size, S) rows, scale =
// dk^-1/2, the final state's cotangent taken as 0 (training drops the
// state): dq, dk, dv in T and di~, df~ in fp32. It works in the forward's
// stabilised units with every stabiliser held constant: in true units h_i
// = num_i / max(|den_i|, 1) depends on none of them, so nothing is
// differentiated through a max. Per chunk, with b the inclusive cumsum of
// logsigmoid(f~), g = b_last, u_j = i~_j - b_j and m the incoming
// stabiliser:
//   m_i = max(b_i + max_{j<=i} u_j, b_i + m), m' = max(g + m, max_j (g +
//   u_j)), w_i = exp(b_i + m - m_i), kw_j = exp(g - b_j + i~_j - m'),
//   carry = exp(g + m - m'); E_ij = exp(b_i - b_j + i~_j - m_i) (j <= i),
//   each log weight summed in the reference's order (the difference of
//   two b first: b is a running sum of negative terms, so b_i - b_j is
//   exact where (b_i - m_i) + u_j rounds at b's magnitude, which a
//   cancelling denominator turns into ~1e-4 relative errors at large
//   gates); W = E (q k^T scale), P = dh v^T, den_i = sum_j W_ij + w_i
//   scale q_i.n_in, X_i = C_in dh_i, dh_i.num_i = sum_j W_ij P_ij + w_i
//   scale q_i.X_i, lim_i = max(|den_i|, exp(-m_i)), dden_i = -sign(den_i)
//   dh_i.num_i / lim_i^2 where |den_i| > exp(-m_i) (else 0), dW = P / lim
//   + dden;
//   dq_i = scale sum_j dW_ij E_ij k_j + w_i scale (X_i / lim_i + dden_i n_in);
//   G_c, the gradient of chunk c's outgoing state: 0 for the last chunk,
//   else L_{c+1} + carry_{c+1} G_{c+1} with L_c = sum_i w_i scale q_i
//   (dh_i / lim_i)^T (for n: sum_i w_i scale dden_i q_i);
//   dk_j = scale sum_i dW_ij E_ij q_i + kw_j (G_c v_j + G^n_c);
//   dv_j = sum_i W_ij dh_i / lim_i + kw_j G_c^T k_j;
//   the log weights' gradient dW W goes to b (rows +, columns -) and i~
//   (columns), w_i's and kw_j's log-gradients to b_i (+) and b_j, i~_j,
//   the carry's and every kw_j's to g (b's last row); b's gradient summed
//   in reverse over the chunk is logsigmoid(f~)'s, df~ = that
//   sigmoid(-f~). Rows past S read as the forward's padding (q = k = v =
//   dh = 0, i~ = -1e30, f~ = 30); their gradients are not written.
// dk and dv multiples of 64, dk <= 512, Q <= 256.
//
// What bounds it on the H100, at xlstm-125m's training microbatch (B=5,
//   S=1024, H=4, dk = dv = 384, Q=256, bf16): bytes read once and written
//   once are q, k, v, dh, dq, dk, dv (15.7 MB each) and the gates (~0.1
//   MB): ~110 MB, 33 us at 3.35 TB/s. The operations of the function,
//   counted on the causal half of each chunk (Q (Q + 1) / 2 pairs): q k^T
//   and dh v^T (dk and dv multiply-adds a pair), dS k, dS^T q (dk each) and
//   W^T dnum (dv), and six (Q, dk, dv) products for the states (the chunk
//   states, C_in dh, L, G v, G^T k, and q C_in's dot with dh folded into
//   X): ~51 GFLOP, 52 us on the tensor cores' 989 TFLOP/s. So its bound is
//   about 0.05 ms, by operations.
//
// This first version runs on the CUDA cores in fp32 for both dtypes (bf16
// inputs are widened as they are read): six launches in order on one
// stream, fp32 scratch between them, 256 threads a block, each owning a 4 x
// 4 micro-tile of a 64 x 64 product whose operands sit in shared memory in
// 32-deep slabs (read as float4 rows):
//   1. mlstm_bwd_gates, a block a (b, h): the chunks in order, a thread a
//      row: b and the prefix max of u as block scans, the stabilisers, w_i,
//      kw_j and the carry (a record a chunk).
//   2. mlstm_bwd_fstate, a block a (64 x 64 tile of the state, b, h): the
//      incoming states C_in, n_in of every chunk, the tile carried in
//      registers through the chunks in order (C = carry C + (kw k)^T v).
//      One head's fp32 state (576 KB at dk = dv = 384) is more than an SM's
//      shared memory; a 64 x 64 tile a block gives B H 36 blocks at the
//      path's shape.
//   3. mlstm_bwd_rows, a block a (64-row tile i, chunk): X = dh C_in^T (to
//      the scratch) with q.X and q.n_in; then the pairs (i, j <= i): S = q
//      k^T and P = dh v^T, W and P kept as the tile's rows in shared memory
//      (64 x Q each); the row scalars lim, dden; dS = dW E scale in place of
//      P, dW W's row sums; dq = dS k + the carried state's term.
//   4. mlstm_bwd_rstate, a block a (state tile, b, h): the chunks in
//      reverse, G_c to the scratch, G = L_c + carry G with L_c's tile from
//      the rows' (q w scale / lim)^T dh, and the carry's log-gradient
//      <C_in, G_c> (+ n) as one part a tile (summed in tile order by 6).
//   5. mlstm_bwd_cols, a block a (64-row tile j, chunk): the pairs (i >= j,
//      j) again, rows j: dS^T and (W / lim)^T kept in shared memory, dW W's
//      column sums; dk = dS^T q + kw (v G^T + G^n) and dv = (W / lim)^T dh +
//      kw k G, kw_j's log-gradient.
//   6. mlstm_bwd_gate_grads, a block a chunk: b's gradient, its reverse sum
//      (thread 0, in order), di~ and df~.
// What it computes again: the pairs' q k^T and dh v^T in kernels 3 and 5
// (twice the function's own), and the forward's states. Scratch: per chunk
// the incoming state and its gradient (2 dk dv fp32), X (Q dk), eleven
// records of Q rows, the carry and a part a state tile: 126.3 MB at the
// path's shape.
//
// Determinism: no float atomics. Every output element and every scratch
// part is written by one thread, every sum runs in a fixed order, so two
// runs give equal bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads; one gate row a thread
constexpr int kMaxQ = kThreads;
constexpr int kT = 64;           // row / column tile, state tile
constexpr int kDS = 32;          // slab depth
constexpr int kLd = kT + 4;      // padded slab row (keeps float4 aligned)
constexpr int kMaxDK = 512;
constexpr float kNegBig = -1e30f;
constexpr float kPadF = 30.f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Shape {
  int B, S, H, DK, DV, Q, nc, nt;
  float scale;
};

// scratch, carved from one buffer (mlstm_scan_bwd_cuda allocates it;
// kernels/mlstm_scan/mlstm_scan.py::bwd_scratch_floats counts it)
struct Work {
  float *bcs, *ii, *mrow, *wrow, *kw; // chunks x Q: the forward's gates
  float *inv, *dden, *drw, *rows;     // chunks x Q: kernel 3's
  float *cols, *dkw;                  // chunks x Q: kernel 5's
  float *carry;                       // chunks
  float *dcar;                        // chunks x state tiles
  float *cin, *gout;                  // chunks x DK x DV
  float *nin, *gnout;                 // chunks x DK
  float *x;                           // chunks x Q x DK: C_in dh
};

// chunk-major index of (b, h, c)
struct Chunk {
  int b, h, c, qv;                    // qv: rows of the chunk inside S
  size_t row0;                        // b * S + c * Q
  size_t qk0, v0;                     // offsets of the chunk's row 0
  __device__ Chunk(const Shape& sh, int ch) {
    c = ch % sh.nc;
    const int bh = ch / sh.nc;
    h = bh % sh.H;
    b = bh / sh.H;
    qv = min(sh.Q, sh.S - c * sh.Q);
    row0 = (size_t)b * sh.S + (size_t)c * sh.Q;
    qk0 = (row0 * sh.H + h) * sh.DK;
    v0 = (row0 * sh.H + h) * sh.DV;
  }
};

// min(x, 0) - log1p(exp(-|x|)): logsigmoid as torch computes it
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// inclusive scan (sum, or max with kMax) over the block's threads
template <bool kMax>
__device__ __forceinline__ float block_scan(float v, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = kMax ? fmaxf(v, u) : v + u;
  }
  if (lane == 31) buf[warp] = v;
  __syncthreads();
  float off = kMax ? -INFINITY : 0.f;
  for (int w = 0; w < warp; ++w) off = kMax ? fmaxf(off, buf[w]) : off + buf[w];
  __syncthreads();                       // buf is free again
  return kMax ? fmaxf(v, off) : v + off;
}

// the sum over the 16 lanes tx of a row group (lanes of one half-warp)
__device__ __forceinline__ float row_group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a block's sum in a fixed order; the result in every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int tid = threadIdx.x;
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

// 64 rows x 32 columns, transposed: dst[c][r] = src[base + (r0 + r) *
// stride + c0 + c] (times rs[r0 + r] if given); rows at or past nv read 0
template <typename T>
__device__ __forceinline__ void load_slab(float (*dst)[kLd],
                                          const T* __restrict__ src,
                                          size_t base, size_t stride, int r0,
                                          int nv, int c0, const float* rs) {
  for (int e = threadIdx.x; e < kT * kDS; e += kThreads) {
    const int r = e / kDS, c = e % kDS;
    float x = 0.f;
    if (r0 + r < nv) {
      x = to_f(src[base + (size_t)(r0 + r) * stride + c0 + c]);
      if (rs != nullptr) x *= rs[r0 + r];
    }
    dst[c][r] = x;
  }
}

// 32 rows x 64 columns: dst[r][c] = src[base + (r0 + r) * stride + c0 + c]
// (times rs[r0 + r] if given); rows at or past nv read 0
template <typename T>
__device__ __forceinline__ void load_rows(float (*dst)[kLd],
                                          const T* __restrict__ src,
                                          size_t base, size_t stride, int r0,
                                          int nv, int c0, const float* rs) {
  for (int e = threadIdx.x; e < kDS * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    float x = 0.f;
    if (r0 + r < nv) {
      x = to_f(src[base + (size_t)(r0 + r) * stride + c0 + c]);
      if (rs != nullptr) x *= rs[r0 + r];
    }
    dst[r][c] = x;
  }
}

// acc[i][j] += sum_x a[x][4 ty + i] b[x][4 tx + j] over one slab
__device__ __forceinline__ void mma_slab(float (&acc)[4][4],
                                         const float (*a)[kLd],
                                         const float (*b)[kLd], int tx,
                                         int ty) {
#pragma unroll 8
  for (int x = 0; x < kDS; ++x) {
    const float4 av = *reinterpret_cast<const float4*>(&a[x][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[x][tx * 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// acc[i][j] += sum_x strip[4 ty + i][x0 + x] b[x][4 tx + j] over one slab
// (the strip row-major, ld floats a row)
__device__ __forceinline__ void mma_strip(float (&acc)[4][4],
                                          const float* strip, int ld, int x0,
                                          const float (*b)[kLd], int tx,
                                          int ty) {
#pragma unroll 8
  for (int x = 0; x < kDS; ++x) {
    const float4 bv = *reinterpret_cast<const float4*>(&b[x][tx * 4]);
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = strip[(ty * 4 + i) * ld + x0 + x];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, br[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------------
// 1. the forward's gates and stabilisers, chunk by chunk
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_gates(const float* __restrict__ ig, const float* __restrict__ fg,
                Shape sh, Work w) {
  __shared__ float red[34];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int h = bh % sh.H, b = bh / sh.H;
  float m = kNegBig;
  for (int c = 0; c < sh.nc; ++c) {
    const size_t ch = (size_t)bh * sh.nc + c;
    const int t0 = c * sh.Q, qv = min(sh.Q, sh.S - t0);
    const bool row = tid < sh.Q;
    float iv = kNegBig, fv = kPadF;
    if (tid < qv) {
      const size_t gi = ((size_t)b * sh.S + t0 + tid) * sh.H + h;
      iv = ig[gi];
      fv = fg[gi];
    }
    const float bcs = block_scan<false>(row ? log_sigmoid(fv) : 0.f, red);
    if (tid == sh.Q - 1) red[32] = bcs;
    const float u = iv - bcs;
    const float pmax = block_scan<true>(row ? u : -INFINITY, red);
    const float g = red[32];
    const float wmax = block_scan<true>(row ? g + u : -INFINITY, red);
    if (tid == kThreads - 1) red[33] = wmax;
    __syncthreads();
    const float m_next = fmaxf(g + m, red[33]);
    if (row) {
      const float mrow = fmaxf(bcs + pmax, bcs + m);
      const size_t r = ch * sh.Q + tid;
      w.bcs[r] = bcs;
      w.ii[r] = iv;
      w.mrow[r] = mrow;
      w.wrow[r] = expf(bcs + m - mrow);
      w.kw[r] = expf(g - bcs + iv - m_next);
    }
    if (tid == 0) w.carry[ch] = expf(g + m - m_next);
    m = m_next;
    __syncthreads();                     // red is read before it is reused
  }
}

// ---------------------------------------------------------------------
// 2. the incoming states, a 64 x 64 tile a block, chunks in order
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_fstate(const T* __restrict__ k, const T* __restrict__ v, Shape sh,
                 Work w) {
  __shared__ __align__(16) float a_s[kDS][kLd];
  __shared__ __align__(16) float b_s[kDS][kLd];
  __shared__ float kw_s[kMaxQ];
  const int tiles_v = sh.DV / kT;
  const int a0 = (blockIdx.x / tiles_v) * kT, e0 = (blockIdx.x % tiles_v) * kT;
  const bool with_n = e0 == 0;
  const int bh = blockIdx.y, tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t qs = (size_t)sh.H * sh.DK, vs = (size_t)sh.H * sh.DV;
  float c_r[4][4];
  zero(c_r);
  float n_r = 0.f;                       // n[a0 + tid] (tid < 64, e0 == 0)
  for (int c = 0; c < sh.nc; ++c) {
    const int ch = bh * sh.nc + c;
    const Chunk ck(sh, ch);
    float* cin = w.cin + (size_t)ch * sh.DK * sh.DV;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cin[(size_t)(a0 + ty * 4 + i) * sh.DV + e0 + tx * 4 + j] = c_r[i][j];
    if (with_n && tid < kT) w.nin[(size_t)ch * sh.DK + a0 + tid] = n_r;
    if (c == sh.nc - 1) break;           // the final state is not needed
    __syncthreads();                     // the last chunk's kw_s consumed
    for (int j = tid; j < sh.Q; j += kThreads)
      kw_s[j] = w.kw[(size_t)ch * sh.Q + j];
    float s_r[4][4];
    zero(s_r);
    float n_part = 0.f;
    for (int j0 = 0; j0 < sh.Q; j0 += kDS) {
      __syncthreads();
      load_rows(a_s, k, ck.qk0, qs, j0, ck.qv, a0, kw_s);
      load_rows(b_s, v, ck.v0, vs, j0, ck.qv, e0, nullptr);
      __syncthreads();
      mma_slab(s_r, a_s, b_s, tx, ty);
      if (with_n && tid < kT)
        for (int x = 0; x < kDS; ++x) n_part += a_s[x][tid];
    }
    const float carry = w.carry[ch];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c_r[i][j] = fmaf(carry, c_r[i][j], s_r[i][j]);
    n_r = fmaf(carry, n_r, n_part);
  }
}

// ---------------------------------------------------------------------
// 3. rows: dq, the row scalars, dW W's row sums
// ---------------------------------------------------------------------
__host__ __device__ constexpr int strip_ld(int nt) { return nt * kT + 4; }

__host__ __device__ constexpr int rows_smem_floats(int nt) {
  return 2 * kT * strip_ld(nt) + 2 * kDS * kLd + 2 * kMaxQ + 3 * kT + kMaxDK;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_rows(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dh,
               T* __restrict__ dq, Shape sh, Work w) {
  extern __shared__ float4 smem4[];
  const int ld = strip_ld(sh.nt);
  float* ws = reinterpret_cast<float*>(smem4);  // [64][ld]: W
  float* ps = ws + kT * ld;                     // [64][ld]: P, then dS
  float (*a_s)[kLd] = reinterpret_cast<float (*)[kLd]>(ps + kT * ld);
  float (*b_s)[kLd] = a_s + kDS;
  float* bcs_s = reinterpret_cast<float*>(b_s + kDS);  // [kMaxQ] b
  float* ii_s = bcs_s + kMaxQ;                         // [kMaxQ] i~
  float* mr_s = ii_s + kMaxQ;                          // [kT] m_i
  float* inv_s = mr_s + kT;                            // [kT] 1 / lim_i
  float* dd_s = inv_s + kT;                            // [kT] dden_i
  float* nin_s = dd_s + kT;                            // [kMaxDK] n_in

  const int it = blockIdx.x, ch = blockIdx.y;
  const Chunk ck(sh, ch);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = it * kT;
  const size_t qs = (size_t)sh.H * sh.DK, vs = (size_t)sh.H * sh.DV;
  const size_t rec = (size_t)ch * sh.Q;
  const bool inter = ck.c > 0;           // chunk 0's incoming state is 0
  for (int j = tid; j < sh.Q; j += kThreads) {
    bcs_s[j] = w.bcs[rec + j];
    ii_s[j] = w.ii[rec + j];
  }
  for (int r = tid; r < kT; r += kThreads)
    mr_s[r] = i0 + r < sh.Q ? w.mrow[rec + i0 + r] : 0.f;
  if (inter)
    for (int d = tid; d < sh.DK; d += kThreads)
      nin_s[d] = w.nin[(size_t)ch * sh.DK + d];
  __syncthreads();

  // the carried state's terms: X = dh C_in^T (to the scratch), q.X, q.n_in
  float qx[4] = {0.f, 0.f, 0.f, 0.f}, qn[4] = {0.f, 0.f, 0.f, 0.f};
  float* xg = w.x + (rec + i0) * sh.DK;
  if (inter) {
    const float* cin = w.cin + (size_t)ch * sh.DK * sh.DV;
    float (*qt)[kLd] = reinterpret_cast<float (*)[kLd]>(ws);  // the q tile
    for (int a0 = 0; a0 < sh.DK; a0 += kT) {
      float acc[4][4];
      zero(acc);
      for (int e0 = 0; e0 < sh.DV; e0 += kDS) {
        __syncthreads();
        load_slab(a_s, dh, ck.v0, vs, i0, ck.qv, e0, nullptr);
        load_slab(b_s, cin, (size_t)a0 * sh.DV, sh.DV, 0, kT, e0, nullptr);
        __syncthreads();
        mma_slab(acc, a_s, b_s, tx, ty);
      }
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e / kT, d = e % kT;
        qt[r][d] = i0 + r < ck.qv
                       ? to_f(q[ck.qk0 + (size_t)(i0 + r) * qs + a0 + d])
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = tx * 4 + j;
          if (i0 + r < sh.Q) xg[(size_t)r * sh.DK + a0 + d] = acc[i][j];
          qx[i] = fmaf(qt[r][d], acc[i][j], qx[i]);
          qn[i] = fmaf(qt[r][d], nin_s[a0 + d], qn[i]);
        }
      }
    }
  }

  // the pairs (i, j <= i): W and P into the strips, their row sums
  float den[4] = {0.f, 0.f, 0.f, 0.f}, dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    float sc[4][4], pc[4][4];
    zero(sc);
    zero(pc);
    for (int d0 = 0; d0 < sh.DK; d0 += kDS) {
      __syncthreads();
      load_slab(a_s, q, ck.qk0, qs, i0, ck.qv, d0, nullptr);
      load_slab(b_s, k, ck.qk0, qs, j0, ck.qv, d0, nullptr);
      __syncthreads();
      mma_slab(sc, a_s, b_s, tx, ty);
    }
    for (int e0 = 0; e0 < sh.DV; e0 += kDS) {
      __syncthreads();
      load_slab(a_s, dh, ck.v0, vs, i0, ck.qv, e0, nullptr);
      load_slab(b_s, v, ck.v0, vs, j0, ck.qv, e0, nullptr);
      __syncthreads();
      mma_slab(pc, a_s, b_s, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, gi = i0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gj = j0 + tx * 4 + j;
        float wv = 0.f;
        if (gj <= gi && gi < sh.Q)
          wv = sc[i][j] * sh.scale *
               expf(bcs_s[gi] - bcs_s[gj] + ii_s[gj] - mr_s[r]);
        ws[r * ld + gj] = wv;
        ps[r * ld + gj] = pc[i][j];
        den[i] += wv;
        dot[i] = fmaf(wv, pc[i][j], dot[i]);
      }
    }
  }

  // the row scalars
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, gi = i0 + r;
    const float den_t = row_group_sum(den[i]), dot_t = row_group_sum(dot[i]);
    const float qx_t = row_group_sum(qx[i]), qn_t = row_group_sum(qn[i]);
    if (tx == 0) {
      float iv = 0.f, dd = 0.f;
      if (gi < sh.Q) {
        const float rw = w.wrow[rec + gi] * sh.scale;
        const float dn = den_t + rw * qn_t, dt = dot_t + rw * qx_t;
        const float floor = expf(-mr_s[r]);
        iv = 1.f / fmaxf(fabsf(dn), floor);
        if (fabsf(dn) > floor) dd = -copysignf(1.f, dn) * dt * iv * iv;
        w.inv[rec + gi] = iv;
        w.dden[rec + gi] = dd;
        w.drw[rec + gi] = rw * (qx_t * iv + qn_t * dd);
      }
      inv_s[r] = iv;
      dd_s[r] = dd;
    }
  }
  __syncthreads();

  // dS = dW E scale in place of P; dW W's row sums
  float rsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int jt = 0; jt <= it; ++jt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, gi = i0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gj = jt * kT + tx * 4 + j;
        float dsv = 0.f;
        if (gj <= gi && gi < sh.Q) {
          const float dw = ps[r * ld + gj] * inv_s[r] + dd_s[r];
          const float e = expf(bcs_s[gi] - bcs_s[gj] + ii_s[gj] - mr_s[r]);
          dsv = dw * e * sh.scale;
          rsum[i] = fmaf(dw, ws[r * ld + gj], rsum[i]);
        }
        ps[r * ld + gj] = dsv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty * 4 + i;
    const float s = row_group_sum(rsum[i]);
    if (tx == 0 && gi < sh.Q) w.rows[rec + gi] = s;
  }

  // dq = dS k + w scale (X / lim + dden n_in), 64 columns of dk at a time
  for (int a0 = 0; a0 < sh.DK; a0 += kT) {
    float acc[4][4];
    zero(acc);
    for (int x0 = 0; x0 <= i0 + kT - kDS; x0 += kDS) {
      __syncthreads();
      load_rows(b_s, k, ck.qk0, qs, x0, ck.qv, a0, nullptr);
      __syncthreads();
      mma_strip(acc, ps, ld, x0, b_s, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, gi = i0 + r;
      if (gi >= ck.qv) continue;
      const float rw = inter ? w.wrow[rec + gi] * sh.scale : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = a0 + tx * 4 + j;
        float val = acc[i][j];
        if (inter)
          val += rw * (xg[(size_t)r * sh.DK + d] * inv_s[r] +
                       dd_s[r] * nin_s[d]);
        dq[ck.qk0 + (size_t)gi * qs + d] = from_f<T>(val);
      }
    }
  }
}

// ---------------------------------------------------------------------
// 4. the outgoing states' gradients, a 64 x 64 tile a block, in reverse
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_rstate(const T* __restrict__ q, const T* __restrict__ dh, Shape sh,
                 Work w) {
  __shared__ __align__(16) float a_s[kDS][kLd];
  __shared__ __align__(16) float b_s[kDS][kLd];
  __shared__ float co_s[kMaxQ];          // w_i scale / lim_i
  __shared__ float cn_s[kMaxQ];          // w_i scale dden_i
  __shared__ float red[kThreads / 32];
  const int tiles_v = sh.DV / kT;
  const int a0 = (blockIdx.x / tiles_v) * kT, e0 = (blockIdx.x % tiles_v) * kT;
  const bool with_n = e0 == 0;
  const int ntile = (sh.DK / kT) * tiles_v;
  const int bh = blockIdx.y, tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t qs = (size_t)sh.H * sh.DK, vs = (size_t)sh.H * sh.DV;
  float g_r[4][4];
  zero(g_r);
  float gn = 0.f;                        // G^n[a0 + tid] (tid < 64, e0 == 0)
  for (int c = sh.nc - 1; c >= 0; --c) {
    const int ch = bh * sh.nc + c;
    const Chunk ck(sh, ch);
    const size_t st = (size_t)ch * sh.DK * sh.DV;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t idx = st + (size_t)(a0 + ty * 4 + i) * sh.DV + e0 +
                           tx * 4 + j;
        w.gout[idx] = g_r[i][j];
        part = fmaf(w.cin[idx], g_r[i][j], part);
      }
    if (with_n && tid < kT) {
      const size_t idx = (size_t)ch * sh.DK + a0 + tid;
      w.gnout[idx] = gn;
      part = fmaf(w.nin[idx], gn, part);
    }
    part = block_sum(part, red);
    if (tid == 0) w.dcar[(size_t)ch * ntile + blockIdx.x] = part;
    if (c == 0) break;                   // chunk 0's incoming state is 0
    const size_t rec = (size_t)ch * sh.Q;
    for (int i = tid; i < sh.Q; i += kThreads) {
      const float rw = w.wrow[rec + i] * sh.scale;
      co_s[i] = rw * w.inv[rec + i];
      cn_s[i] = rw * w.dden[rec + i];
    }
    float l_r[4][4];
    zero(l_r);
    for (int i0 = 0; i0 < sh.Q; i0 += kDS) {
      __syncthreads();
      load_rows(a_s, q, ck.qk0, qs, i0, ck.qv, a0, co_s);
      load_rows(b_s, dh, ck.v0, vs, i0, ck.qv, e0, nullptr);
      __syncthreads();
      mma_slab(l_r, a_s, b_s, tx, ty);
    }
    const float carry = w.carry[ch];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g_r[i][j] = fmaf(carry, g_r[i][j], l_r[i][j]);
    if (with_n && tid < kT) {
      float ln = 0.f;
      for (int i = 0; i < ck.qv; ++i)
        ln = fmaf(cn_s[i], to_f(q[ck.qk0 + (size_t)i * qs + a0 + tid]), ln);
      gn = fmaf(carry, gn, ln);
    }
    __syncthreads();                     // co_s, cn_s read before reuse
  }
}

// ---------------------------------------------------------------------
// 5. columns: dk, dv, dW W's column sums, kw's log-gradient
// ---------------------------------------------------------------------
__host__ __device__ constexpr int cols_smem_floats(int nt) {
  return 2 * kT * strip_ld(nt) + 2 * kDS * kLd + kT * kLd + 5 * kMaxQ +
         kMaxDK;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_cols(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dh,
               T* __restrict__ dk, T* __restrict__ dv, Shape sh, Work w) {
  extern __shared__ float4 smem4[];
  const int ld = strip_ld(sh.nt);
  float* s1 = reinterpret_cast<float*>(smem4);  // [64][ld]: dS^T (rows j)
  float* s2 = s1 + kT * ld;                     // [64][ld]: (W / lim)^T
  float (*a_s)[kLd] = reinterpret_cast<float (*)[kLd]>(s2 + kT * ld);
  float (*b_s)[kLd] = a_s + kDS;
  float (*kt)[kLd] = b_s + kDS;                 // [64][kLd]: the k tile
  float* bcs_s = reinterpret_cast<float*>(kt + kT);  // [kMaxQ] each
  float* mr_s = bcs_s + kMaxQ;
  float* inv_s = mr_s + kMaxQ;
  float* dd_s = inv_s + kMaxQ;
  float* ii_s = dd_s + kMaxQ;
  float* gn_s = ii_s + kMaxQ;                   // [kMaxDK] G^n

  const int jt = blockIdx.x, ch = blockIdx.y;
  const Chunk ck(sh, ch);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int j0 = jt * kT, iend = sh.nt * kT;
  const size_t qs = (size_t)sh.H * sh.DK, vs = (size_t)sh.H * sh.DV;
  const size_t rec = (size_t)ch * sh.Q;
  const bool state = ck.c < sh.nc - 1;   // the last chunk's G is 0
  for (int i = tid; i < sh.Q; i += kThreads) {
    bcs_s[i] = w.bcs[rec + i];
    mr_s[i] = w.mrow[rec + i];
    inv_s[i] = w.inv[rec + i];
    dd_s[i] = w.dden[rec + i];
    ii_s[i] = w.ii[rec + i];
  }
  if (state)
    for (int d = tid; d < sh.DK; d += kThreads)
      gn_s[d] = w.gnout[(size_t)ch * sh.DK + d];
  __syncthreads();

  // the pairs (i >= j, j), rows j: dS^T and (W / lim)^T into the strips
  float csum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = jt; it < sh.nt; ++it) {
    const int i0 = it * kT;
    float sc[4][4], pc[4][4];
    zero(sc);
    zero(pc);
    for (int d0 = 0; d0 < sh.DK; d0 += kDS) {
      __syncthreads();
      load_slab(a_s, k, ck.qk0, qs, j0, ck.qv, d0, nullptr);
      load_slab(b_s, q, ck.qk0, qs, i0, ck.qv, d0, nullptr);
      __syncthreads();
      mma_slab(sc, a_s, b_s, tx, ty);
    }
    for (int e0 = 0; e0 < sh.DV; e0 += kDS) {
      __syncthreads();
      load_slab(a_s, v, ck.v0, vs, j0, ck.qv, e0, nullptr);
      load_slab(b_s, dh, ck.v0, vs, i0, ck.qv, e0, nullptr);
      __syncthreads();
      mma_slab(pc, a_s, b_s, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, gj = j0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gi = i0 + tx * 4 + j;
        float v1 = 0.f, v2 = 0.f;
        if (gj <= gi && gi < sh.Q) {
          const float e = expf(bcs_s[gi] - bcs_s[gj] + ii_s[gj] - mr_s[gi]);
          const float wv = sc[i][j] * sh.scale * e;
          const float dw = pc[i][j] * inv_s[gi] + dd_s[gi];
          v1 = dw * e * sh.scale;
          v2 = wv * inv_s[gi];
          csum[i] = fmaf(dw, wv, csum[i]);
        }
        s1[r * ld + gi] = v1;
        s2[r * ld + gi] = v2;
      }
    }
  }
  __syncthreads();

  // dk = dS^T q + kw (v G^T + G^n), 64 columns of dk at a time
  const float* gout = w.gout + (size_t)ch * sh.DK * sh.DV;
  float kgv[4] = {0.f, 0.f, 0.f, 0.f};   // k_j . (G v_j + G^n)
  for (int a0 = 0; a0 < sh.DK; a0 += kT) {
    float acc[4][4];
    zero(acc);
    for (int x0 = j0; x0 < iend; x0 += kDS) {
      __syncthreads();
      load_rows(b_s, q, ck.qk0, qs, x0, ck.qv, a0, nullptr);
      __syncthreads();
      mma_strip(acc, s1, ld, x0, b_s, tx, ty);
    }
    if (state) {
      float gv[4][4];
      zero(gv);
      for (int e0 = 0; e0 < sh.DV; e0 += kDS) {
        __syncthreads();
        load_slab(a_s, v, ck.v0, vs, j0, ck.qv, e0, nullptr);
        load_slab(b_s, gout, (size_t)a0 * sh.DV, sh.DV, 0, kT, e0, nullptr);
        __syncthreads();
        mma_slab(gv, a_s, b_s, tx, ty);
      }
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e / kT, d = e % kT;
        kt[r][d] = j0 + r < ck.qv
                       ? to_f(k[ck.qk0 + (size_t)(j0 + r) * qs + a0 + d])
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, gj = j0 + r;
        const float kw = gj < sh.Q ? w.kw[rec + gj] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = tx * 4 + j;
          const float g = gv[i][j] + gn_s[a0 + d];
          kgv[i] = fmaf(kt[r][d], g, kgv[i]);
          acc[i][j] = fmaf(kw, g, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gj = j0 + ty * 4 + i;
      if (gj >= ck.qv) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dk[ck.qk0 + (size_t)gj * qs + a0 + tx * 4 + j] = from_f<T>(acc[i][j]);
    }
  }

  // dv = (W / lim)^T dh + kw k G, 64 columns of dv at a time
  for (int e0 = 0; e0 < sh.DV; e0 += kT) {
    float acc[4][4];
    zero(acc);
    for (int x0 = j0; x0 < iend; x0 += kDS) {
      __syncthreads();
      load_rows(b_s, dh, ck.v0, vs, x0, ck.qv, e0, nullptr);
      __syncthreads();
      mma_strip(acc, s2, ld, x0, b_s, tx, ty);
    }
    if (state) {
      float kg[4][4];
      zero(kg);
      for (int d0 = 0; d0 < sh.DK; d0 += kDS) {
        __syncthreads();
        load_slab(a_s, k, ck.qk0, qs, j0, ck.qv, d0, nullptr);
        load_rows(b_s, gout, 0, sh.DV, d0, sh.DK, e0, nullptr);
        __syncthreads();
        mma_slab(kg, a_s, b_s, tx, ty);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gj = j0 + ty * 4 + i;
        const float kw = gj < sh.Q ? w.kw[rec + gj] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kw, kg[i][j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gj = j0 + ty * 4 + i;
      if (gj >= ck.qv) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dv[ck.v0 + (size_t)gj * vs + e0 + tx * 4 + j] = from_f<T>(acc[i][j]);
    }
  }

  // dW W's column sums and kw's log-gradient, a row j each
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gj = j0 + ty * 4 + i;
    const float cs = row_group_sum(csum[i]), kg = row_group_sum(kgv[i]);
    if (tx == 0 && gj < sh.Q) {
      w.cols[rec + gj] = cs;
      w.dkw[rec + gj] = w.kw[rec + gj] * kg;
    }
  }
}

// ---------------------------------------------------------------------
// 6. the gates' gradients, a chunk a block
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_gate_grads(const float* __restrict__ fg, float* __restrict__ di,
                     float* __restrict__ df, Shape sh, Work w) {
  __shared__ float db_s[kMaxQ];
  __shared__ float dkw_s[kMaxQ];
  const int ch = blockIdx.x, tid = threadIdx.x;
  const Chunk ck(sh, ch);
  const size_t rec = (size_t)ch * sh.Q;
  if (tid < sh.Q) {
    const float dkw = w.dkw[rec + tid];
    db_s[tid] = w.rows[rec + tid] - w.cols[rec + tid] + w.drw[rec + tid] -
                dkw;
    dkw_s[tid] = dkw;
  }
  __syncthreads();
  if (tid == 0) {
    const int ntile = (sh.DK / kT) * (sh.DV / kT);
    float dcar = 0.f, skw = 0.f;
    for (int t = 0; t < ntile; ++t) dcar += w.dcar[(size_t)ch * ntile + t];
    for (int j = 0; j < sh.Q; ++j) skw += dkw_s[j];
    db_s[sh.Q - 1] += w.carry[ch] * dcar + skw;
    float run = 0.f;
    for (int i = sh.Q - 1; i >= 0; --i) {
      run += db_s[i];
      db_s[i] = run;
    }
  }
  __syncthreads();
  if (tid < ck.qv) {
    const size_t gi = (ck.row0 + tid) * sh.H + ck.h;
    di[gi] = w.cols[rec + tid] + dkw_s[tid];
    df[gi] = db_s[tid] / (1.f + expf(fg[gi]));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, const void* dh, void* dq, void* dk, void* dv,
           void* di, void* df, void* work, int B, int S, int H, int DK,
           int DV, int Q, float scale, cudaStream_t s) {
  static bool set_rows[64] = {}, set_cols[64] = {};
  const int nc = (S + Q - 1) / Q, nt = (Q + kT - 1) / kT;
  Shape sh{B, S, H, DK, DV, Q, nc, nt, scale};
  const size_t chunks = (size_t)B * H * nc;
  const size_t rec = chunks * Q;
  const int ntile = (DK / kT) * (DV / kT);
  Work w;
  float* p = (float*)work;
  float** recs[] = {&w.bcs, &w.ii, &w.mrow, &w.wrow, &w.kw, &w.inv,
                    &w.dden, &w.drw, &w.rows, &w.cols, &w.dkw};
  for (float** r : recs) {
    *r = p;
    p += rec;
  }
  w.carry = p; p += chunks;
  w.dcar = p; p += chunks * ntile;
  w.cin = p; p += chunks * DK * DV;
  w.gout = p; p += chunks * DK * DV;
  w.nin = p; p += chunks * DK;
  w.gnout = p; p += chunks * DK;
  w.x = p;
  const int max_nt = kMaxQ / kT;
  cudaError_t err = sm90::allow_smem(
      mlstm_bwd_rows<T>, rows_smem_floats(max_nt) * (int)sizeof(float),
      set_rows);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(mlstm_bwd_cols<T>,
                         cols_smem_floats(max_nt) * (int)sizeof(float),
                         set_cols);
  if (err != cudaSuccess) return (int)err;
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  const T* gt = (const T*)dh;
  const dim3 tiles((unsigned)ntile, (unsigned)(B * H));
  const dim3 pieces((unsigned)nt, (unsigned)chunks);
  mlstm_bwd_gates<<<(unsigned)(B * H), kThreads, 0, s>>>(
      (const float*)ig, (const float*)fg, sh, w);
  mlstm_bwd_fstate<T><<<tiles, kThreads, 0, s>>>(kt, vt, sh, w);
  mlstm_bwd_rows<T><<<pieces, kThreads,
                      rows_smem_floats(nt) * sizeof(float), s>>>(
      qt, kt, vt, gt, (T*)dq, sh, w);
  mlstm_bwd_rstate<T><<<tiles, kThreads, 0, s>>>(qt, gt, sh, w);
  mlstm_bwd_cols<T><<<pieces, kThreads,
                      cols_smem_floats(nt) * sizeof(float), s>>>(
      qt, kt, vt, gt, (T*)dk, (T*)dv, sh, w);
  mlstm_bwd_gate_grads<<<(unsigned)chunks, kThreads, 0, s>>>(
      (const float*)fg, (float*)di, (float*)df, sh, w);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward of mlstm_scan_fwd from zero state, final state's cotangent 0.
// dtype 0: fp32 q, k, v, dh, dq, dk, dv; 1: bf16. i~, f~, di~, df~ fp32.
// `work`: mlstm_scan_bwd_scratch_floats(...) fp32 words.
extern "C" int mlstm_scan_bwd(const void* q, const void* k, const void* v,
                              const void* ig, const void* fg, const void* dh,
                              void* dq, void* dk, void* dv, void* di,
                              void* df, void* work, int B, int S, int H,
                              int DK, int DV, int Q, float scale, int dtype,
                              void* stream) {
  if (DK <= 0 || DK % kT != 0 || DK > kMaxDK || DV <= 0 || DV % kT != 0 ||
      Q <= 0 || Q > kMaxQ || B <= 0 || S <= 0 || H <= 0 || work == nullptr ||
      (long long)B * H * ((S + Q - 1) / Q) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, ig, fg, dh, dq, dk, dv, di, df, work, B, S,
                         H, DK, DV, Q, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ig, fg, dh, dq, dk, dv, di, df,
                                 work, B, S, H, DK, DV, Q, scale, s);
  return (int)cudaErrorInvalidValue;
}

// fp32 words of the scratch mlstm_scan_bwd takes at these shapes.
extern "C" long long mlstm_scan_bwd_scratch_floats(int B, int S, int H,
                                                   int DK, int DV, int Q) {
  const long long chunks = (long long)B * H * ((S + Q - 1) / Q);
  const long long ntile = (long long)(DK / kT) * (DV / kT);
  return chunks * (11LL * Q + 1 + ntile + 2LL * DK * DV + 2LL * DK +
                   (long long)Q * DK);
}
