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
//   once are q, k, v, dh, dq, dk, dv (15.7 MB each) and the gates (0.3
//   MB): 110.4 MB, 33.0 us at 3.35 TB/s. The operations of the function
//   (chip_smoke.py's mlstm_bwd_flops_bytes), counted on the causal half
//   of each chunk (Q (Q + 1) / 2 pairs): q k^T, dS k and dS^T q (dk
//   multiply-adds a pair), dh v^T and W^T dnum (dv each), and the state
//   products (dk dv multiply-adds a row): C_in dh and L over the rows
//   after the first chunk, the chunk states, G v and G^T k over the rows
//   before the last: 32.8 GFLOP, 33.1 us on the tensor cores' 989
//   TFLOP/s. So its bound is 0.0331 ms, by operations, with bytes within
//   1% of it.
//
// Two designs, by dtype (mlstm_scan_bwd dispatches; there is no other
// switch, and nothing falls back from one to the other):
//
// bf16: the tensor cores (wgmma over cp.async rings), a warpgroup a
//   block, nine launches in order on one stream, fp32 scratch between
//   them; every operand made in fp32 (kw k, C_in, dS, W/lim, the
//   weighted q, G_c) is fed as a bf16 pair hi = bf16(x), lo = bf16(x -
//   hi), two products into one fp32 accumulator; q, k, v and dh go in as
//   they are. Each causal 64-row tile pair's q k^T and dh v^T is
//   computed once, in launch 5; launch 8 reads the pair's dS and W/lim
//   from the scratch. Accumulators are 128 columns a pass (64 where 128
//   does not divide the width), and a kernel runs all its passes' steps
//   through one ring, so a pass's epilogue overlaps the next pass's
//   copies.
//   1. mlstm_bwd_gates (the fp32 design's): the stabilisers, w_i, kw_j,
//      the carry.
//   2. mlstm_bwd_cstate_sm90, a block a (64 dk x 128 dv tile, chunk
//      before the last): S_c = (kw k)^T v and n_c over 64-row pieces
//      through a 2-stage ring (68 KB), kw k made hi/lo in shared memory,
//      both operands MN-major; kw_j is the gates' exp(g - b_j + i~_j -
//      m'), so S_c is in the outgoing state's units.
//   3. mlstm_bwd_fpass_sm90, 4 elements a thread, chunks in order: C_in
//      over S_c in fp32 (C = carry C + S_c), a later chunk's C_in also as
//      a pair.
//   4. mlstm_bwd_x_sm90, a block a (64-row tile i, 128 columns of dk,
//      chunk after the first), 81 KB (two blocks an SM): X = dh_i C_in^T
//      (C_in's pair K-major) to the scratch, and the pass's parts of q.X
//      and q.n_in.
//   5. mlstm_bwd_rows_sm90, a block a (chunk, 64-row tile i), the
//      heaviest tiles first, 214 KB (one block an SM): the pairs (i, j <=
//      i), each once: S = q_i k_j^T and P = dh_i v_j^T over 64-column
//      slabs through a 5-stage ring of 16 KB, on the fragments W = E S
//      scale (0 above the diagonal), den and dh.num's parts, W and P to
//      the pair's 32 KB slot in shared memory as the fragments hold them;
//      the row scalars lim, dden (with launch 4's parts); per pair dS =
//      (P / lim + dden) E scale and W / lim as pairs of swizzled 64 x 64
//      tiles over the slot (the pair's image, copied to the scratch), dW
//      W's row sums and column sums; dq = dS k (dS's pair from the slots,
//      K-major, k_j MN-major) + w scale (X / lim + dden n_in).
//   6. mlstm_bwd_lstate_sm90, as 2 on chunks after the first: L_c = (w
//      scale q / lim)^T dh with the weighted q as a pair, and its n part.
//   7. mlstm_bwd_rpass_sm90, chunks in reverse: G_c (0 for the last) as a
//      pair, G^n_c in fp32, G = L_c + carry G, and the carry's
//      log-gradient <C_in, G_c> (+ n) as one part a block (1024
//      elements), summed in order by 9.
//   8. mlstm_bwd_cols_sm90, a block a (chunk, 64-row tile j), the
//      heaviest tiles first, 83 KB (two blocks an SM): dk_j = kw_j (v_j
//      G^T + G^n) + sum_{i >= j} dS_ij^T q_i and dv_j = kw_j k_j G +
//      sum_i (W/lim)_ij^T dh_i, 128 columns a pass (64 where 128 does
//      not divide), each pass's state term over G's pair and then its
//      pair terms, with the images' halves read MN-major, all through
//      one 2-stage ring of 40 KB for dk and one for dv; kw_j's
//      log-gradient; dW W's column sums over the row tiles in order.
//   9. mlstm_bwd_gate_grads (the fp32 design's).
//   Scratch: per chunk the two states (S_c then C_in, L_c then G^n), the
//   pairs of C_in and G, the pairs' images (32 KB each), X, the column
//   sums by row tile, q.X's and q.n_in's parts, the records and the
//   carry's parts: 248.4 MB at the path's shape.
//
// fp32: the first, CUDA-core version (wgmma has no fp32 operands; the
//   xLSTM fp32 probe rests on it): six launches in order on one stream,
//   fp32 scratch between them, 256 threads a block, each owning a 4 x 4
//   micro-tile of a 64 x 64 product whose operands sit in shared memory
//   in 32-deep slabs (read as float4 rows):
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
//   What it computes again: the pairs' q k^T and dh v^T in kernels 3 and
//   5 (twice the function's own), and the forward's states. Scratch: per
//   chunk the incoming state and its gradient (2 dk dv fp32), X (Q dk),
//   eleven records of Q rows, the carry and a part a state tile: 126.3 MB
//   at the path's shape.
//
// Determinism (both designs): no float atomics. Every output element and
// every scratch part is written by one thread, every sum runs in a fixed
// order, so two runs give equal bits.
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

// (the CUDA-core kernels are built for fp32 only: bf16 takes the
// tensor-core kernels below)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

struct Shape {
  int B, S, H, DK, DV, Q, nc, nt;
  float scale;
  int ndcar;                          // the carry gradient's parts a chunk
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
  // bf16 only (launch_sm90):
  float *st, *lst;                    // chunks x DK (DV + 1): S_c, n_c
                                      // then C_in, n_in; L_c, ln_c (n:
                                      // then G^n)
  __nv_bfloat16 *cpair, *gpair;       // chunks x 2 x DK x DV: C_in's and
                                      // G_c's pairs (hi, then lo)
  uint4* pairs;                       // chunks x pairs x kPairU4: images
  float* colp;                        // chunks x nt x nt 64: dW W's
                                      // column sums by row tile
  float* qxn;                         // chunks x nt x passes x 2 x 64:
                                      // q.X and q.n_in by dk pass
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
    const int ntile = sh.ndcar;
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
  const int ntile = (DK / kT) * (DV / kT);
  Shape sh{B, S, H, DK, DV, Q, nc, nt, scale, ntile};
  const size_t chunks = (size_t)B * H * nc;
  const size_t rec = chunks * Q;
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

// ---------------------------------------------------------------------
// bf16: the tensor cores (wgmma), a warpgroup a block
// ---------------------------------------------------------------------
constexpr int kRowTile = 64;            // rows of a pair's tiles; a piece
constexpr int kWg = 128;                // one warpgroup
constexpr int kBlk = kRowTile * 128;    // 64 rows x 64 bf16: 8 KB
constexpr int kDvTile = 128;            // dv columns a state-product block
constexpr int kPass = 128;              // accumulator columns a pass (64
                                        // where 128 does not divide)
constexpr int kPairU4 = 4 * kBlk / 16;  // a pair's image in 16-byte words:
                                        // dS hi, lo, W/lim hi, lo
constexpr int kPartLen = 1024;          // state elements a carry part
constexpr int kSlot = 4 * kBlk;         // a pair: W, P fp32, then its image
constexpr int kSlots = kMaxQ / kRowTile;
constexpr int kPairStage = 2 * kBlk;    // two 64 x 64 tiles
constexpr int kColStage = 4 * kBlk;     // an image's half and a 128-column
                                        // tile
constexpr int kWideStage = 5 * kBlk;    // a 64 x 64 tile and two 128 x 64
constexpr int kStStage = 4 * kBlk;      // k or q (then hi), lo, 128
                                        // columns of v or dh
// a 2-stage ring; the rows' two weights; n's halves; 1 KB to align
constexpr int kStSmem = 2 * kStStage + 2 * kMaxQ * 4 + kWg * 4 + 1024;
// a 2-stage ring of wide stages; 1 KB to align: two blocks an SM
constexpr int kXSmem = 2 * kWideStage + 1024;
// the slots; a 5-stage ring of tile pairs; b, i~, the column sums' warp
// parts; n_in; 1 KB to align
constexpr int kRowsSmem = kSlots * kSlot + 5 * kPairStage +
                          (3 * kMaxQ + kMaxDK) * 4 + 1024;
// a 2-stage ring of wide stages (or of image halves); G^n; 1 KB to
// align: two blocks an SM
constexpr int kColsSmem = 2 * kWideStage + kMaxDK * 4 + 1024;
static_assert(kColStage <= kWideStage, "rings");

__host__ __device__ constexpr int pair_count(int nt) {
  return nt * (nt + 1) / 2;
}
__host__ __device__ constexpr int pair_index(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

template <int N> struct Int { static constexpr int value = N; };

// A kStages-deep cp.async ring of kStage-byte stages at `ring_s`: step s's
// copies (load(s, stage)) have landed, for every thread, when compute(s,
// stage) runs, and the copies of the next kStages - 1 steps are in flight
// meanwhile. compute waits for its own products; on return the ring is
// free.
template <int kStages, int kStage, class Load, class Compute>
__device__ __forceinline__ void ring(uint32_t ring_s, int n, Load&& load,
                                     Compute&& compute) {
#pragma unroll 1
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n) load(p, ring_s + p * kStage);
    sm90::cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    sm90::cp_async_wait<kStages - 2>();        // step s landed
    sm90::fence_proxy_async();
    __syncthreads();                           // ... for every thread;
                                               // step s-1's stage is free
    const int nx = s + kStages - 1;
    if (nx < n) load(nx, ring_s + (nx % kStages) * kStage);
    sm90::cp_async_commit();
    compute(s, ring_s + (s % kStages) * kStage);
  }
  sm90::cp_async_wait<0>();
  __syncthreads();
}

// the sum over the 4 lanes of a quad (a fragment row), the same bits in
// each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float2 ld_bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------
// 2 / 6. state products over a chunk's rows, a (64 dk rows x 128 dv
//    columns) tile a block: kMode 0 the chunk states S_c = (kw k)^T v and
//    n_c = sum_j kw_j k_j (chunks before the last), kMode 1 L_c = (rw inv
//    q)^T dh and its n part sum_i rw_i dden_i q_i (chunks after the
//    first); the weighted k or q made in fp32 and fed as a bf16 pair,
//    both operands MN-major, over 64-row pieces through a 2-stage ring
// ---------------------------------------------------------------------
template <int kMode>
__device__ __forceinline__ void state_products(
    uint8_t* smem_raw, const __nv_bfloat16* __restrict__ a,
    const __nv_bfloat16* __restrict__ bm, const Shape& sh, const Work& w) {
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* wt_s = reinterpret_cast<float*>(gbase + 2 * kStStage);
  float* wn_s = wt_s + kMaxQ;
  float* n_s = wn_s + kMaxQ;

  const int n_dvt = (sh.DV + kDvTile - 1) / kDvTile;
  const int dkt = blockIdx.x / n_dvt, dvt = blockIdx.x % n_dvt;
  const int bh = blockIdx.y / (sh.nc - 1);
  const int ch = bh * sh.nc + blockIdx.y % (sh.nc - 1) + kMode;
  const Chunk ck(sh, ch);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int dk0 = dkt * kRowTile, dv0 = dvt * kDvTile;
  const int pc = min(kDvTile, sh.DV - dv0) / 8;
  const size_t qs = (size_t)sh.H * sh.DK, vs = (size_t)sh.H * sh.DV;
  const size_t rec = (size_t)ch * sh.Q;
  const __nv_bfloat16* ag = a + ck.qk0 + dk0;
  const __nv_bfloat16* bg = bm + ck.v0 + dv0;
  for (int r = tid; r < kMaxQ; r += kWg) {
    float x = 0.f, y = 0.f;
    if (r < sh.Q) {
      if (kMode == 0) {
        x = y = w.kw[rec + r];
      } else {
        const float rw = w.wrow[rec + r] * sh.scale;
        x = rw * w.inv[rec + r];
        y = rw * w.dden[rec + r];
      }
    }
    wt_s[r] = x;
    wn_s[r] = y;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float npart = 0.f;                           // column tid % 64, a half
  ring<2, kStStage>(
      base, (ck.qv + kRowTile - 1) / kRowTile,
      [&](int p, uint32_t st) {
        const int r0 = p * kRowTile;
        sm90::load_rows<kRowTile, 8, kWg>(st, ag + (size_t)r0 * qs, qs,
                                          ck.qv - r0, 8, tid);
        sm90::load_rows<kRowTile, 16, kWg>(st + 2 * kBlk,
                                           bg + (size_t)r0 * vs, vs,
                                           ck.qv - r0, pc, tid);
      },
      [&](int p, uint32_t st) {
        uint8_t* araw = gbase + (st - base);
        if (dvt == 0) {
          const int d = tid % 64, rh = (tid / 64) * 32;
          for (int rr = 0; rr < 32; ++rr) {
            const int r = rh + rr;
            const __nv_bfloat16 x = *reinterpret_cast<const __nv_bfloat16*>(
                araw + sm90::tile_off(kRowTile, r, d / 8) + (d % 8) * 2);
            npart = fmaf(wn_s[p * kRowTile + r], __bfloat162float(x), npart);
          }
        }
        __syncthreads();                       // read before it is hi
        for (int i = tid; i < kRowTile * 8; i += kWg) {
          const int r = i / 8;
          const uint32_t o = sm90::tile_off(kRowTile, r, i % 8);
          const uint4 u = *reinterpret_cast<const uint4*>(araw + o);
          const __nv_bfloat162* a2 =
              reinterpret_cast<const __nv_bfloat162*>(&u);
          const float wv = wt_s[p * kRowTile + r];
          float x[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(a2[e]);
            x[2 * e] = f.x * wv;
            x[2 * e + 1] = f.y * wv;
          }
          uint4 hi, lo;
          sm90::split8(x, hi, lo);
          *reinterpret_cast<uint4*>(araw + o) = hi;
          *reinterpret_cast<uint4*>(araw + kBlk + o) = lo;
        }
        sm90::fence_proxy_async();
        __syncthreads();
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_ss<128, 1, 1>(
              acc, sm90::desc_sw128(st + ks * 2048, kBlk, 1024),
              sm90::desc_sw128(st + 2 * kBlk + ks * 2048, kBlk, 1024), 1);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_ss<128, 1, 1>(
              acc, sm90::desc_sw128(st + kBlk + ks * 2048, kBlk, 1024),
              sm90::desc_sw128(st + 2 * kBlk + ks * 2048, kBlk, 1024), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      });

  const size_t len = (size_t)sh.DK * (sh.DV + 1);
  float* out = (kMode == 0 ? w.st : w.lst) + (size_t)ch * len;
  const int dr = dk0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = dv0 + 8 * j + 2 * (lane % 4);
    if (col < sh.DV) {
      *reinterpret_cast<float2*>(out + (size_t)dr * sh.DV + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(dr + 8) * sh.DV + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (dvt == 0) {
    n_s[tid] = npart;
    __syncthreads();
    if (tid < 64)
      out[(size_t)sh.DK * sh.DV + dk0 + tid] = n_s[tid] + n_s[tid + 64];
  }
}

__global__ void __launch_bounds__(kWg)
mlstm_bwd_cstate_sm90(const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, Shape sh,
                      Work w) {
  extern __shared__ uint8_t smem_raw[];
  state_products<0>(smem_raw, k, v, sh, w);
}

__global__ void __launch_bounds__(kWg)
mlstm_bwd_lstate_sm90(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ dh, Shape sh,
                      Work w) {
  extern __shared__ uint8_t smem_raw[];
  state_products<1>(smem_raw, q, dh, sh, w);
}

// ---------------------------------------------------------------------
// 3. the incoming states in chunk order, fp32, 4 elements a thread of a
//    chunk's DK (DV + 1) record (C, then n): C_in[c] over S_c (chunk 0's
//    zero too), a later chunk's C_in also as a bf16 pair; the loads of 4
//    chunks are issued before their dependent updates
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(256)
mlstm_bwd_fpass_sm90(Shape sh, Work w) {
  const size_t len = (size_t)sh.DK * (sh.DV + 1);
  const size_t cn = (size_t)sh.DK * sh.DV;
  const size_t e = ((size_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= len) return;
  const size_t ch0 = (size_t)blockIdx.y * sh.nc;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 st = z;
  for (int c0 = 0; c0 < sh.nc; c0 += 4) {
    float4 sc[4];
    float carry[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      sc[j] = c + 1 < sh.nc ? *reinterpret_cast<const float4*>(
                                  w.st + (ch0 + c) * len + e)
                            : z;
      carry[j] = c < sh.nc ? w.carry[ch0 + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= sh.nc) break;
      *reinterpret_cast<float4*>(w.st + (ch0 + c) * len + e) = st;
      if (c > 0 && e < cn) {
        uint32_t h0, l0, h1, l1;
        sm90::split2(st.x, st.y, h0, l0);
        sm90::split2(st.z, st.w, h1, l1);
        __nv_bfloat16* hp = w.cpair + (ch0 + c) * 2 * cn + e;
        *reinterpret_cast<uint2*>(hp) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(hp + cn) = make_uint2(l0, l1);
      }
      st.x = fmaf(carry[j], st.x, sc[j].x);
      st.y = fmaf(carry[j], st.y, sc[j].y);
      st.z = fmaf(carry[j], st.z, sc[j].z);
      st.w = fmaf(carry[j], st.w, sc[j].w);
    }
  }
}

// ---------------------------------------------------------------------
// 7. the outgoing states' gradients in reverse, fp32: G_c (0 for the
//    last chunk) as a bf16 pair, G^n_c over ln_c, the carry's
//    log-gradient's part <C_in, G_c> (+ n) a block, summed in a fixed
//    order; then G = L_c + carry G. The loads of 4 chunks are issued
//    before their dependent updates.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(256)
mlstm_bwd_rpass_sm90(Shape sh, Work w) {
  __shared__ float red[4][8];
  const size_t len = (size_t)sh.DK * (sh.DV + 1);
  const size_t cn = (size_t)sh.DK * sh.DV;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t e = ((size_t)blockIdx.x * 256 + tid) * 4;
  const bool live = e < len;
  const size_t ch0 = (size_t)blockIdx.y * sh.nc;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 g = z;
  for (int c1 = sh.nc - 1; c1 >= 0; c1 -= 4) {
    float4 ci[4], lc[4];
    float carry[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c1 - j;
      const size_t o = (ch0 + c) * len + e;
      ci[j] = live && c >= 0 ? *reinterpret_cast<const float4*>(w.st + o) : z;
      lc[j] = live && c > 0 ? *reinterpret_cast<const float4*>(w.lst + o) : z;
      carry[j] = c >= 0 ? w.carry[ch0 + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c1 - j;
      if (c < 0) break;
      float part = 0.f;
      if (live) {
        if (e >= cn) {
          *reinterpret_cast<float4*>(w.lst + (ch0 + c) * len + e) = g;
        } else if (c + 1 < sh.nc) {
          uint32_t h0, l0, h1, l1;
          sm90::split2(g.x, g.y, h0, l0);
          sm90::split2(g.z, g.w, h1, l1);
          __nv_bfloat16* hp = w.gpair + (ch0 + c) * 2 * cn + e;
          *reinterpret_cast<uint2*>(hp) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(hp + cn) = make_uint2(l0, l1);
        }
        part = ci[j].x * g.x;
        part = fmaf(ci[j].y, g.y, part);
        part = fmaf(ci[j].z, g.z, part);
        part = fmaf(ci[j].w, g.w, part);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[j][warp] = part;
      g.x = fmaf(carry[j], g.x, lc[j].x);
      g.y = fmaf(carry[j], g.y, lc[j].y);
      g.z = fmaf(carry[j], g.z, lc[j].z);
      g.w = fmaf(carry[j], g.w, lc[j].w);
    }
    __syncthreads();
    if (tid < 4 && c1 - tid >= 0) {
      float s = 0.f;
      for (int i = 0; i < 8; ++i) s += red[tid][i];
      w.dcar[(ch0 + c1 - tid) * sh.ndcar + blockIdx.x] = s;
    }
    __syncthreads();                           // red read before reuse
  }
}

// ---------------------------------------------------------------------
// 4. the carried state's terms of a chunk after the first, a block a
//    (64-row tile i, kPass columns of dk): X = dh_i C_in^T (C_in's pair,
//    K-major, over 64-column dv slabs through a 2-stage ring) to the
//    scratch as the fragments hold it (the layout does not depend on the
//    pass's width), and the pass's parts of q.X and q.n_in. A chunk's
//    blocks run side by side, so its C_in pair is read from memory once.
// ---------------------------------------------------------------------
template <int NW>
__device__ __forceinline__ void x_pass(uint32_t base, int ch, int it,
                                       int p, int npass,
                                       const __nv_bfloat16* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ dh,
                                       const Shape& sh, const Work& w) {
  const Chunk ck(sh, ch);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = it * kRowTile, lr = warp * 16 + lane / 4;
  const int lc = 2 * (lane % 4), c0 = p * kPass;
  const size_t qs = (size_t)sh.H * sh.DK, vs = (size_t)sh.H * sh.DV;
  const size_t cn = (size_t)sh.DK * sh.DV, len = cn + sh.DK;
  const __nv_bfloat16* dg = dh + ck.v0 + (size_t)min(i0, ck.qv - 1) * vs;
  const __nv_bfloat16* cg =
      w.cpair + (size_t)ch * 2 * cn + (size_t)c0 * sh.DV;
  float acc[NW / 2];
#pragma unroll
  for (int r = 0; r < NW / 2; ++r) acc[r] = 0.f;
  ring<2, kWideStage>(
      base, sh.DV / 64,
      [&](int s, uint32_t st) {
        const int e0 = s * 64;
        sm90::load_rows<kRowTile, 8, kWg>(st, dg + e0, vs, ck.qv - i0, 8,
                                          tid);
        sm90::load_rows<NW, 8, kWg>(st + kBlk, cg + e0, sh.DV, NW, 8, tid);
        sm90::load_rows<NW, 8, kWg>(st + kBlk + NW * 128, cg + cn + e0,
                                    sh.DV, NW, 8, tid);
      },
      [&](int, uint32_t st) {
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<NW, 0>(
              acc, sm90::desc_sw128(st + kk * 32, 16, 1024),
              sm90::desc_sw128(st + kBlk + kk * 32, 16, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss<NW, 0>(
              acc, sm90::desc_sw128(st + kk * 32, 16, 1024),
              sm90::desc_sw128(st + kBlk + NW * 128 + kk * 32, 16, 1024),
              1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      });
  const float* nin = w.st + (size_t)ch * len + cn;
  float qx[2] = {0.f, 0.f}, qn[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < NW / 8; ++jj) {
    const int col = c0 + 8 * jj + lc;
    const float2 nv = *reinterpret_cast<const float2*>(nin + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gi = i0 + lr + 8 * e;
      const float2 qv = gi < ck.qv ? ld_bf2(q + ck.qk0 + (size_t)gi * qs + col)
                                   : make_float2(0.f, 0.f);
      qx[e] = fmaf(qv.x, acc[4 * jj + 2 * e], qx[e]);
      qx[e] = fmaf(qv.y, acc[4 * jj + 2 * e + 1], qx[e]);
      qn[e] = fmaf(qv.x, nv.x, qn[e]);
      qn[e] = fmaf(qv.y, nv.y, qn[e]);
    }
  }
  float* xw = w.x + ((size_t)ch * sh.nt + it) * kRowTile * sh.DK +
              (size_t)c0 * kRowTile;
#pragma unroll
  for (int r = 0; r < NW / 2; ++r) xw[r * kWg + tid] = acc[r];
  float* part =
      w.qxn + (((size_t)ch * sh.nt + it) * npass + p) * 2 * kRowTile;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float sx = quad_sum(qx[e]), sn = quad_sum(qn[e]);
    if (lane % 4 == 0) {
      part[lr + 8 * e] = sx;
      part[kRowTile + lr + 8 * e] = sn;
    }
  }
}

__global__ void __launch_bounds__(kWg, 2)
mlstm_bwd_x_sm90(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ dh, Shape sh, Work w) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int npass = (sh.DK + kPass - 1) / kPass;
  const int it = blockIdx.x / npass, p = blockIdx.x % npass;
  const int ch = (blockIdx.y / (sh.nc - 1)) * sh.nc +
                 blockIdx.y % (sh.nc - 1) + 1;
  if ((p + 1) * kPass <= sh.DK)
    x_pass<kPass>(base, ch, it, p, npass, q, dh, sh, w);
  else
    x_pass<64>(base, ch, it, p, npass, q, dh, sh, w);
}

// ---------------------------------------------------------------------
// 5. rows: a block a (chunk, 64-row tile i), the heaviest tiles first
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kWg, 1)
mlstm_bwd_rows_sm90(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dh,
                    __nv_bfloat16* __restrict__ dq, Shape sh, Work w) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t ring_s = base + kSlots * kSlot;
  float* bcs_s = reinterpret_cast<float*>(gbase + kSlots * kSlot +
                                          5 * kPairStage);
  float* ii_s = bcs_s + kMaxQ;
  float* red_s = ii_s + kMaxQ;                 // [4 warps][64 columns]
  float* nin_s = red_s + kMaxQ;                // [kMaxDK]

  const int ch = blockIdx.x, it = sh.nt - 1 - (int)blockIdx.y;
  const Chunk ck(sh, ch);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = it * kRowTile, lr = warp * 16 + lane / 4;
  const int lc = 2 * (lane % 4);
  const size_t qs = (size_t)sh.H * sh.DK, vs = (size_t)sh.H * sh.DV;
  const size_t rec = (size_t)ch * sh.Q;
  const size_t cn = (size_t)sh.DK * sh.DV, len = cn + sh.DK;
  const bool inter = ck.c > 0;                 // chunk 0's C_in is 0
  const __nv_bfloat16* qg = q + ck.qk0;
  const __nv_bfloat16* kg = k + ck.qk0;
  const __nv_bfloat16* vg = v + ck.v0;
  const __nv_bfloat16* dg = dh + ck.v0;
  // a tile's first row, clamped into the chunk's rows (a tile wholly past
  // them is read as zeros from a valid address)
  auto at = [&](const __nv_bfloat16* g, size_t ld, int r0) {
    return g + (size_t)min(r0, ck.qv - 1) * ld;
  };
  for (int j = tid; j < kMaxQ; j += kWg) {
    bcs_s[j] = j < sh.Q ? w.bcs[rec + j] : 0.f;
    ii_s[j] = j < sh.Q ? w.ii[rec + j] : kNegBig;
  }
  if (inter)
    for (int d = tid; d < sh.DK; d += kWg)
      nin_s[d] = w.st[(size_t)ch * len + cn + d];
  float bi[2], mi[2], rw[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gi = i0 + lr + 8 * e;
    const bool ok = gi < sh.Q;
    bi[e] = ok ? w.bcs[rec + gi] : 0.f;
    mi[e] = ok ? w.mrow[rec + gi] : 0.f;
    rw[e] = ok ? w.wrow[rec + gi] * sh.scale : 0.f;
  }
  __syncthreads();

  // A. q.X and q.n_in of the tile's rows: the X kernel's parts in pass
  // order
  float qx[2] = {0.f, 0.f}, qn[2] = {0.f, 0.f};
  const float* xw = w.x + ((size_t)ch * sh.nt + it) * kRowTile * sh.DK;
  if (inter) {
    const int npass = (sh.DK + kPass - 1) / kPass;
    const float* part =
        w.qxn + ((size_t)ch * sh.nt + it) * npass * 2 * kRowTile;
    for (int p = 0; p < npass; ++p)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        qx[e] += part[p * 2 * kRowTile + lr + 8 * e];
        qn[e] += part[p * 2 * kRowTile + kRowTile + lr + 8 * e];
      }
  }

  // B. the pairs (i, j <= i), each once: S = q_i k_j^T and P = dh_i v_j^T
  // (exact bf16 operands, K-major) over 64-column slabs through a 5-stage
  // ring; on the fragments W = E S scale (0 above the diagonal), den and
  // dh.num's pair parts; W and P to slot j as the fragments hold them
  const int nk = sh.DK / 64, per = nk + sh.DV / 64;
  float den[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
  float sacc[32], pacc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) sacc[r] = pacc[r] = 0.f;
  ring<5, kPairStage>(
      ring_s, (it + 1) * per,
      [&](int s, uint32_t st) {
        const int j0 = (s / per) * kRowTile, sub = s % per;
        if (sub < nk) {
          sm90::load_rows<kRowTile, 8, kWg>(st, at(qg, qs, i0) + sub * 64,
                                            qs, ck.qv - i0, 8, tid);
          sm90::load_rows<kRowTile, 8, kWg>(st + kBlk,
                                            at(kg, qs, j0) + sub * 64, qs,
                                            ck.qv - j0, 8, tid);
        } else {
          const int e0 = (sub - nk) * 64;
          sm90::load_rows<kRowTile, 8, kWg>(st, at(dg, vs, i0) + e0, vs,
                                            ck.qv - i0, 8, tid);
          sm90::load_rows<kRowTile, 8, kWg>(st + kBlk, at(vg, vs, j0) + e0,
                                            vs, ck.qv - j0, 8, tid);
        }
      },
      [&](int s, uint32_t st) {
        const int jt = s / per, sub = s % per;
        sm90::wgmma_fence();
        if (sub < nk) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_ss<64, 0>(
                sacc, sm90::desc_sw128(st + kk * 32, 16, 1024),
                sm90::desc_sw128(st + kBlk + kk * 32, 16, 1024),
                sub > 0 || kk > 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_ss<64, 0>(
                pacc, sm90::desc_sw128(st + kk * 32, 16, 1024),
                sm90::desc_sw128(st + kBlk + kk * 32, 16, 1024),
                sub > nk || kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sacc);
        sm90::fence_regs(pacc);
        if (sub != per - 1) return;
        const int j0 = jt * kRowTile;
        float* sw = reinterpret_cast<float*>(gbase + jt * kSlot);
        float* sp = sw + 32 * kWg;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int idx = 4 * jj + 2 * e + x;
              const int gi = i0 + lr + 8 * e, gj = j0 + 8 * jj + lc + x;
              float wv = 0.f;
              if (gj <= gi && gi < sh.Q)
                wv = sacc[idx] * sh.scale *
                     expf(bi[e] - bcs_s[gj] + ii_s[gj] - mi[e]);
              den[e] += wv;
              dot[e] = fmaf(wv, pacc[idx], dot[e]);
              sw[idx * kWg + tid] = wv;
              sp[idx * kWg + tid] = pacc[idx];
            }
      });

  // C. the row scalars
  float inv[2], dd[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gi = i0 + lr + 8 * e;
    const float den_t = quad_sum(den[e]), dot_t = quad_sum(dot[e]);
    float iv = 0.f, d_ = 0.f;
    if (gi < sh.Q) {
      const float dn = den_t + rw[e] * qn[e], dt = dot_t + rw[e] * qx[e];
      const float floor = expf(-mi[e]);
      iv = 1.f / fmaxf(fabsf(dn), floor);
      if (fabsf(dn) > floor) d_ = -copysignf(1.f, dn) * dt * iv * iv;
      if (lane % 4 == 0) {
        w.inv[rec + gi] = iv;
        w.dden[rec + gi] = d_;
        w.drw[rec + gi] = rw[e] * (qx[e] * iv + qn[e] * d_);
      }
    }
    inv[e] = iv;
    dd[e] = d_;
  }

  // D. per pair: dW = P / lim + dden, dS = dW E scale and W / lim as bf16
  // pairs of swizzled tiles over the slot (its image: dS hi, lo, W/lim
  // hi, lo); dW W's row sums, and its column sums (the rows of a warp by
  // butterfly, then the warps in order) to the scratch
  float rsum[2] = {0.f, 0.f};
  const size_t cp0 = ((size_t)ch * sh.nt + it) * (sh.nt * kRowTile);
#pragma unroll 1
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kRowTile;
    uint8_t* img = gbase + jt * kSlot;
    float wv[32], pv[32];
    {
      const float* sw = reinterpret_cast<const float*>(img);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        wv[r] = sw[r * kWg + tid];
        pv[r] = sw[(32 + r) * kWg + tid];
      }
    }
    __syncthreads();                           // the slot read; red free
    float cs[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      cs[2 * jj] = cs[2 * jj + 1] = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gi = i0 + lr + 8 * e;
        float dsv[2], wlv[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int idx = 4 * jj + 2 * e + x, gj = j0 + 8 * jj + lc + x;
          dsv[x] = wlv[x] = 0.f;
          if (gj <= gi && gi < sh.Q) {
            const float dw = pv[idx] * inv[e] + dd[e];
            const float ex = expf(bi[e] - bcs_s[gj] + ii_s[gj] - mi[e]);
            dsv[x] = dw * ex * sh.scale;
            wlv[x] = wv[idx] * inv[e];
            const float dD = dw * wv[idx];
            rsum[e] += dD;
            cs[2 * jj + x] += dD;
          }
        }
        const uint32_t o = sm90::tile_off(kRowTile, lr + 8 * e, jj) +
                           (lane % 4) * 4;
        uint32_t hi, lo;
        sm90::split2(dsv[0], dsv[1], hi, lo);
        *reinterpret_cast<uint32_t*>(img + o) = hi;
        *reinterpret_cast<uint32_t*>(img + kBlk + o) = lo;
        sm90::split2(wlv[0], wlv[1], hi, lo);
        *reinterpret_cast<uint32_t*>(img + 2 * kBlk + o) = hi;
        *reinterpret_cast<uint32_t*>(img + 3 * kBlk + o) = lo;
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float c = cs[i];
      c += __shfl_xor_sync(0xffffffffu, c, 4);
      c += __shfl_xor_sync(0xffffffffu, c, 8);
      c += __shfl_xor_sync(0xffffffffu, c, 16);
      cs[i] = c;
    }
    if (lane < 4) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        red_s[warp * 64 + 8 * jj + 2 * lane] = cs[2 * jj];
        red_s[warp * 64 + 8 * jj + 2 * lane + 1] = cs[2 * jj + 1];
      }
    }
    __syncthreads();
    if (tid < 64)
      w.colp[cp0 + j0 + tid] =
          ((red_s[tid] + red_s[64 + tid]) + red_s[128 + tid]) +
          red_s[192 + tid];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gi = i0 + lr + 8 * e;
    const float sr = quad_sum(rsum[e]);
    if (lane % 4 == 0 && gi < sh.Q) w.rows[rec + gi] = sr;
  }
  __syncthreads();                             // every image written
  {
    uint4* pg = w.pairs + ((size_t)ch * pair_count(sh.nt) +
                           pair_index(it, 0)) * kPairU4;
    for (int i = tid; i < (it + 1) * kPairU4; i += kWg)
      pg[i] = *reinterpret_cast<const uint4*>(
          gbase + (i / kPairU4) * kSlot + (i % kPairU4) * 16);
  }

  // E. dq = dS k (dS's pair from the slots, K-major; k_j MN-major) + w
  // scale (X / lim + dden n_in), NW columns of dk a pass (128 where it
  // divides dk, else 64), the passes' steps through one ring
  auto dq_passes = [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    const int steps = it + 1;
    float acc[NW / 2];
#pragma unroll
    for (int r = 0; r < NW / 2; ++r) acc[r] = 0.f;
    ring<5, kPairStage>(
        ring_s, (sh.DK / NW) * steps,
        [&](int s, uint32_t st) {
          const int c0 = (s / steps) * NW, j0 = (s % steps) * kRowTile;
          sm90::load_rows<kRowTile, NW / 8, kWg>(st, at(kg, qs, j0) + c0, qs,
                                                 ck.qv - j0, NW / 8, tid);
        },
        [&](int s, uint32_t st) {
          const int jt = s % steps, c0 = (s / steps) * NW;
          const uint32_t img = base + jt * kSlot;
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_ss<NW, 1>(
                acc, sm90::desc_sw128(img + kk * 32, 16, 1024),
                sm90::desc_sw128(st + kk * 2048, kBlk, 1024),
                jt > 0 || kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_ss<NW, 1>(
                acc, sm90::desc_sw128(img + kBlk + kk * 32, 16, 1024),
                sm90::desc_sw128(st + kk * 2048, kBlk, 1024), 1);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
          if (jt != it) return;
          // the pass's X, every load issued before any store (dq's stores
          // would otherwise hold each load back)
          float xv[NW / 2];
          const float* xr = xw + (size_t)c0 * kRowTile + tid;
#pragma unroll
          for (int r = 0; r < NW / 2; ++r) xv[r] = inter ? xr[r * kWg] : 0.f;
#pragma unroll
          for (int jj = 0; jj < NW / 8; ++jj) {
            const int col = c0 + 8 * jj + lc;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int gi = i0 + lr + 8 * e, r = 4 * jj + 2 * e;
              float a0 = acc[r], a1 = acc[r + 1];
              if (inter) {
                a0 += rw[e] * (xv[r] * inv[e] + dd[e] * nin_s[col]);
                a1 += rw[e] * (xv[r + 1] * inv[e] + dd[e] * nin_s[col + 1]);
              }
              if (gi < ck.qv)
                *reinterpret_cast<__nv_bfloat162*>(
                    dq + ck.qk0 + (size_t)gi * qs + col) =
                    __floats2bfloat162_rn(a0, a1);
            }
          }
        });
  };
  if (sh.DK % kPass == 0)
    dq_passes(Int<kPass>{});
  else
    dq_passes(Int<64>{});
}

// ---------------------------------------------------------------------
// 8. columns: a block a (chunk, 64-row tile j), the heaviest tiles first;
//    no pair product is computed again: dS and W/lim come from the rows'
//    images
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kWg, 2)
mlstm_bwd_cols_sm90(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dh,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Shape sh, Work w) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* gn_s = reinterpret_cast<float*>(gbase + 2 * kWideStage);

  const int ch = blockIdx.x, jt = blockIdx.y;
  const Chunk ck(sh, ch);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = jt * kRowTile, lr = warp * 16 + lane / 4;
  const int lc = 2 * (lane % 4);
  const size_t qs = (size_t)sh.H * sh.DK, vs = (size_t)sh.H * sh.DV;
  const size_t rec = (size_t)ch * sh.Q;
  const size_t cn = (size_t)sh.DK * sh.DV, len = cn + sh.DK;
  const bool state = ck.c < sh.nc - 1;         // the last chunk's G is 0
  const __nv_bfloat16* qg = q + ck.qk0;
  const __nv_bfloat16* kg = k + ck.qk0;
  const __nv_bfloat16* vg = v + ck.v0;
  const __nv_bfloat16* dg = dh + ck.v0;
  auto at = [&](const __nv_bfloat16* g, size_t ld, int r0) {
    return g + (size_t)min(r0, ck.qv - 1) * ld;
  };
  const __nv_bfloat16* gp = w.gpair + (size_t)ch * 2 * cn;
  const uint4* pim = w.pairs + (size_t)ch * pair_count(sh.nt) * kPairU4;
  if (state)
    for (int d = tid; d < sh.DK; d += kWg)
      gn_s[d] = w.lst[(size_t)ch * len + cn + d];
  float kw[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gj = j0 + lr + 8 * e;
    kw[e] = gj < sh.Q ? w.kw[rec + gj] : 0.f;
  }
  __syncthreads();

  // an accumulator's rows j (those inside the chunk) in bf16
  auto store = [&](const auto& acc, __nv_bfloat16* out, size_t ld,
                   int c0) {
    constexpr int NW = 2 * (int)(sizeof(acc) / sizeof(float));
#pragma unroll
    for (int jj = 0; jj < NW / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gj = j0 + lr + 8 * e, r = 4 * jj + 2 * e;
        if (gj < ck.qv)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)gj * ld + c0 +
                                             8 * jj + lc) =
              __floats2bfloat162_rn(acc[r], acc[r + 1]);
      }
  };
  // the pair steps' copies: image half `half` of pair (i, j) (A's pair,
  // read MN-major) and B_i's NW columns at c0 (MN-major)
  auto load_pair = [&](auto nw, uint32_t st, int it, int half,
                       const __nv_bfloat16* bsrc, size_t ld, int c0) {
    constexpr int NW = decltype(nw)::value;
    const int i0 = it * kRowTile;
    const uint4* src =
        pim + pair_index(it, jt) * kPairU4 + half * (kPairU4 / 2);
    for (int i = tid; i < kPairU4 / 2; i += kWg)
      sm90::cp_async_16(st + i * 16, src + i, true);
    sm90::load_rows<kRowTile, NW / 8, kWg>(st + 2 * kBlk,
                                           at(bsrc, ld, i0) + c0, ld,
                                           ck.qv - i0, NW / 8, tid);
  };
  // acc (+)= A_ij^T B_i of the stage's pair
  auto mma_pair = [&](auto& acc, uint32_t st, int accumulate) {
    constexpr int NW = 2 * (int)(sizeof(acc) / sizeof(float));
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss<NW, 1, 1>(
          acc, sm90::desc_sw128(st + kk * 2048, kBlk, 1024),
          sm90::desc_sw128(st + 2 * kBlk + kk * 2048, kBlk, 1024),
          accumulate || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss<NW, 1, 1>(
          acc, sm90::desc_sw128(st + kBlk + kk * 2048, kBlk, 1024),
          sm90::desc_sw128(st + 2 * kBlk + kk * 2048, kBlk, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  };
  const int nsk = state ? sh.DV / 64 : 0, nsv = state ? sh.DK / 64 : 0;
  const int np = sh.nt - jt;

  // dk_j = kw_j (v_j G^T + G^n) + sum_{i >= j} dS_ij^T q_i, NW columns a
  // pass (128 where it divides dk, else 64), every pass's steps (the state
  // term's over G's pair, then the pairs') through one ring; kw_j's
  // log-gradient from the state term
  float kgv[2] = {0.f, 0.f};
  auto dk_passes = [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    const int per = nsk + np;
    float acc[NW / 2];
#pragma unroll
    for (int r = 0; r < NW / 2; ++r) acc[r] = 0.f;
    ring<2, kWideStage>(
        base, (sh.DK / NW) * per,
        [&](int s, uint32_t st) {
          const int c0 = (s / per) * NW, sub = s % per;
          if (sub < nsk) {
            const int e0 = sub * 64;
            sm90::load_rows<kRowTile, 8, kWg>(st, at(vg, vs, j0) + e0, vs,
                                              ck.qv - j0, 8, tid);
            sm90::load_rows<NW, 8, kWg>(st + kBlk,
                                        gp + (size_t)c0 * sh.DV + e0, sh.DV,
                                        NW, 8, tid);
            sm90::load_rows<NW, 8, kWg>(st + kBlk + NW * 128,
                                        gp + cn + (size_t)c0 * sh.DV + e0,
                                        sh.DV, NW, 8, tid);
          } else {
            load_pair(nw, st, jt + sub - nsk, 0, qg, qs, c0);
          }
        },
        [&](int s, uint32_t st) {
          const int c0 = (s / per) * NW, sub = s % per;
          if (sub < nsk) {
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              sm90::wgmma_ss<NW, 0>(
                  acc, sm90::desc_sw128(st + kk * 32, 16, 1024),
                  sm90::desc_sw128(st + kBlk + kk * 32, 16, 1024),
                  sub > 0 || kk > 0);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              sm90::wgmma_ss<NW, 0>(
                  acc, sm90::desc_sw128(st + kk * 32, 16, 1024),
                  sm90::desc_sw128(st + kBlk + NW * 128 + kk * 32, 16,
                                   1024), 1);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(acc);
            if (sub != nsk - 1) return;
#pragma unroll
            for (int jj = 0; jj < NW / 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int gj = j0 + lr + 8 * e, r = 4 * jj + 2 * e;
                const int col = c0 + 8 * jj + lc;
                const float2 kv = gj < ck.qv
                                      ? ld_bf2(kg + (size_t)gj * qs + col)
                                      : make_float2(0.f, 0.f);
                const float t0 = acc[r] + gn_s[col];
                const float t1 = acc[r + 1] + gn_s[col + 1];
                kgv[e] = fmaf(kv.x, t0, kgv[e]);
                kgv[e] = fmaf(kv.y, t1, kgv[e]);
                acc[r] = kw[e] * t0;
                acc[r + 1] = kw[e] * t1;
              }
            return;
          }
          mma_pair(acc, st, nsk > 0 || sub > 0);
          if (sub == per - 1) store(acc, dk + ck.qk0, qs, c0);
        });
  };
  if (sh.DK % kPass == 0)
    dk_passes(Int<kPass>{});
  else
    dk_passes(Int<64>{});

  // dv_j = kw_j k_j G + sum_i (W / lim)_ij^T dh_i, the same way
  auto dv_passes = [&](auto nw) {
    constexpr int NW = decltype(nw)::value;
    const int per = nsv + np;
    float acc[NW / 2];
#pragma unroll
    for (int r = 0; r < NW / 2; ++r) acc[r] = 0.f;
    ring<2, kWideStage>(
        base, (sh.DV / NW) * per,
        [&](int s, uint32_t st) {
          const int c0 = (s / per) * NW, sub = s % per;
          if (sub < nsv) {
            const int a0 = sub * 64;
            sm90::load_rows<kRowTile, 8, kWg>(st, at(kg, qs, j0) + a0, qs,
                                              ck.qv - j0, 8, tid);
            sm90::load_rows<kRowTile, NW / 8, kWg>(
                st + kBlk, gp + (size_t)a0 * sh.DV + c0, sh.DV, kRowTile,
                NW / 8, tid);
            sm90::load_rows<kRowTile, NW / 8, kWg>(
                st + kBlk + NW * 128, gp + cn + (size_t)a0 * sh.DV + c0,
                sh.DV, kRowTile, NW / 8, tid);
          } else {
            load_pair(nw, st, jt + sub - nsv, 1, dg, vs, c0);
          }
        },
        [&](int s, uint32_t st) {
          const int c0 = (s / per) * NW, sub = s % per;
          if (sub < nsv) {
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              sm90::wgmma_ss<NW, 1>(
                  acc, sm90::desc_sw128(st + kk * 32, 16, 1024),
                  sm90::desc_sw128(st + kBlk + kk * 2048, kBlk, 1024),
                  sub > 0 || kk > 0);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              sm90::wgmma_ss<NW, 1>(
                  acc, sm90::desc_sw128(st + kk * 32, 16, 1024),
                  sm90::desc_sw128(st + kBlk + NW * 128 + kk * 2048, kBlk,
                                   1024), 1);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(acc);
            if (sub == nsv - 1) {
#pragma unroll
              for (int r = 0; r < NW / 2; ++r) acc[r] *= kw[(r / 2) % 2];
            }
            return;
          }
          mma_pair(acc, st, nsv > 0 || sub > 0);
          if (sub == per - 1) store(acc, dv + ck.v0, vs, c0);
        });
  };
  if (sh.DV % kPass == 0)
    dv_passes(Int<kPass>{});
  else
    dv_passes(Int<64>{});

  // kw_j's log-gradient; dW W's column sums over the row tiles in order
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gj = j0 + lr + 8 * e;
    const float s = quad_sum(kgv[e]);
    if (lane % 4 == 0 && gj < sh.Q) w.dkw[rec + gj] = kw[e] * s;
  }
  if (tid < 64 && j0 + tid < sh.Q) {
    float s = 0.f;
    for (int it = jt; it < sh.nt; ++it)
      s += w.colp[((size_t)ch * sh.nt + it) * (sh.nt * kRowTile) + j0 + tid];
    w.cols[rec + j0 + tid] = s;
  }
}

int launch_sm90(const void* q, const void* k, const void* v, const void* ig,
                const void* fg, const void* dh, void* dq, void* dk, void* dv,
                void* di, void* df, void* work, int B, int S, int H, int DK,
                int DV, int Q, float scale, cudaStream_t s) {
  static bool set_c[64] = {}, set_l[64] = {}, set_x[64] = {},
              set_r[64] = {}, set_k[64] = {};
  using bf = __nv_bfloat16;
  const int nc = (S + Q - 1) / Q, nt = (Q + kRowTile - 1) / kRowTile;
  const size_t cn = (size_t)DK * DV, len = cn + DK;
  const int ndcar = (int)((len + kPartLen - 1) / kPartLen);
  const int npass = (DK + kPass - 1) / kPass;
  Shape sh{B, S, H, DK, DV, Q, nc, nt, scale, ndcar};
  const size_t chunks = (size_t)B * H * nc;
  Work w = {};
  float* p = (float*)work;
  w.st = p; p += chunks * len;
  w.lst = p; p += chunks * len;
  w.cpair = (bf*)p; p += chunks * cn;
  w.gpair = (bf*)p; p += chunks * cn;
  w.pairs = (uint4*)p; p += chunks * pair_count(nt) * (size_t)kPairU4 * 4;
  w.x = p; p += chunks * nt * kRowTile * DK;
  w.colp = p; p += chunks * nt * nt * kRowTile;
  w.qxn = p; p += chunks * nt * npass * 2 * kRowTile;
  float** recs[] = {&w.bcs, &w.ii, &w.mrow, &w.wrow, &w.kw, &w.inv,
                    &w.dden, &w.drw, &w.rows, &w.cols, &w.dkw};
  for (float** r : recs) {
    *r = p;
    p += chunks * Q;
  }
  w.carry = p; p += chunks;
  w.dcar = p;
  cudaError_t err = sm90::allow_smem(mlstm_bwd_cstate_sm90, kStSmem, set_c);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(mlstm_bwd_lstate_sm90, kStSmem, set_l);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(mlstm_bwd_x_sm90, kXSmem, set_x);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(mlstm_bwd_rows_sm90, kRowsSmem, set_r);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(mlstm_bwd_cols_sm90, kColsSmem, set_k);
  if (err != cudaSuccess) return (int)err;
  const bf* qt = (const bf*)q;
  const bf* kt = (const bf*)k;
  const bf* vt = (const bf*)v;
  const bf* gt = (const bf*)dh;
  const dim3 states((unsigned)((DK / kRowTile) * ((DV + kDvTile - 1) /
                                                  kDvTile)),
                    (unsigned)(B * H * (nc - 1)));
  const dim3 pass((unsigned)ndcar, (unsigned)(B * H));
  const dim3 tiles((unsigned)chunks, (unsigned)nt);
  mlstm_bwd_gates<<<(unsigned)(B * H), kThreads, 0, s>>>(
      (const float*)ig, (const float*)fg, sh, w);
  if (nc > 1)
    mlstm_bwd_cstate_sm90<<<states, kWg, kStSmem, s>>>(kt, vt, sh, w);
  mlstm_bwd_fpass_sm90<<<pass, 256, 0, s>>>(sh, w);
  if (nc > 1)
    mlstm_bwd_x_sm90<<<dim3((unsigned)(nt * npass),
                            (unsigned)(B * H * (nc - 1))),
                       kWg, kXSmem, s>>>(qt, gt, sh, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_rows_sm90<<<tiles, kWg, kRowsSmem, s>>>(qt, kt, vt, gt, (bf*)dq,
                                                    sh, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nc > 1)
    mlstm_bwd_lstate_sm90<<<states, kWg, kStSmem, s>>>(qt, gt, sh, w);
  mlstm_bwd_rpass_sm90<<<pass, 256, 0, s>>>(sh, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_cols_sm90<<<tiles, kWg, kColsSmem, s>>>(
      qt, kt, vt, gt, (bf*)dk, (bf*)dv, sh, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_bwd_gate_grads<<<(unsigned)chunks, kThreads, 0, s>>>(
      (const float*)fg, (float*)di, (float*)df, sh, w);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward of mlstm_scan_fwd from zero state, final state's cotangent 0.
// dtype 0: fp32 q, k, v, dh, dq, dk, dv; 1: bf16. i~, f~, di~, df~ fp32.
// `work`: mlstm_scan_bwd_scratch_floats(..., dtype) fp32 words (16-byte
// aligned in bf16).
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
    return launch_sm90(q, k, v, ig, fg, dh, dq, dk, dv, di, df, work, B, S,
                       H, DK, DV, Q, scale, s);
  return (int)cudaErrorInvalidValue;
}

// fp32 words of the scratch mlstm_scan_bwd takes at these shapes and
// dtype (0 fp32, 1 bf16); -1 for another dtype.
extern "C" long long mlstm_scan_bwd_scratch_floats(int B, int S, int H,
                                                   int DK, int DV, int Q,
                                                   int dtype) {
  const long long chunks = (long long)B * H * ((S + Q - 1) / Q);
  if (dtype == 0) {
    const long long ntile = (long long)(DK / kT) * (DV / kT);
    return chunks * (11LL * Q + 1 + ntile + 2LL * DK * DV + 2LL * DK +
                     (long long)Q * DK);
  }
  if (dtype != 1) return -1;
  const long long nt = (Q + kRowTile - 1) / kRowTile;
  const long long len = (long long)DK * (DV + 1);
  const long long npass = (DK + kPass - 1) / kPass;
  return chunks * (2 * len + 2LL * DK * DV +
                   pair_count((int)nt) * (long long)kPairU4 * 4 +
                   nt * kRowTile * DK + nt * nt * kRowTile +
                   nt * npass * 2 * kRowTile + 11LL * Q + 1 +
                   (len + kPartLen - 1) / kPartLen);
}

// What the bf16 kernels' tiles are, as mlstm_scan_bwd_tiled_plain models
// them (BWD_ROW_TILE and BWD_PASS in kernels/mlstm_scan/mlstm_scan.py):
// axis 0 the rows of a pair's tiles, 1 the accumulator columns a pass; -1
// otherwise.
extern "C" int mlstm_scan_bwd_sm90_tile(int axis) {
  return axis == 0 ? kRowTile : axis == 1 ? kPass : -1;
}
// Dynamic shared memory (bytes) of the bf16 state-product kernels (0),
// the rows kernel (1), the columns kernel (2) and the X kernel (3); -1
// otherwise.
extern "C" int mlstm_scan_bwd_sm90_smem(int kernel) {
  return kernel == 0 ? kStSmem : kernel == 1 ? kRowsSmem
                               : kernel == 2 ? kColsSmem
                               : kernel == 3 ? kXSmem : -1;
}
