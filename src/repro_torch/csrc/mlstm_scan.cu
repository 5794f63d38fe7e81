// xLSTM mLSTM chunkwise-parallel scan from zero state for prefill,
// written for sm_90a.
//
// Replaces: src/repro/kernels/mlstm_scan/mlstm_scan.py, mlstm_scan_pallas
//   (_mlstm_kernel, pallas_call at :141).
//
// Computes, for q/k (B, S, H, dk) and v (B, S, H, dv) in T (fp32 or
//   bf16) and the gate pre-activations i~/f~ (B, S, H) in fp32, with
//   chunks of Q = min(chunk_size, S) rows and scale = dk^-1/2, per chunk
//   (log space, stabilised; b the inclusive cumsum of logsigmoid(f~)
//   over the chunk, g = b_last, m the carried stabiliser):
//     D_ij  = b_i - b_j + i~_j                    (j <= i)
//     m_i   = max(max_{j<=i} D_ij, b_i + m)
//     num_i = sum_{j<=i} exp(D_ij - m_i) (q_i.k_j scale) v_j
//             + exp(b_i + m - m_i) (q_i C) scale
//     den_i = the same with v_j -> 1 and C -> n
//     h_i   = num_i / max(|den_i|, exp(-m_i))
//     m'    = max(g + m, max_j (g - b_j + i~_j))
//     C     = exp(g + m - m') C + sum_j exp(g - b_j + i~_j - m') k_j v_j^T
//     n     = the same with v_j -> 1;  m = m'
//   from C = 0, n = 0, m = -1e30; h (B, S, H, dv) in T, the final C (B, H,
//   dk, dv), n (B, H, dk) and m (B, H) in fp32. A ragged last chunk reads
//   its rows past S as i~ = -1e30, f~ = 30 and q = k = v = 0, exactly
//   what the Pallas wrapper pads with (mlstm_scan.py:131-133), and their
//   h is not written. Held against ref.py::mlstm_chunked.
//
// What bounds it on the H100: at xlstm-125m's prefill (B=4, S=1024, H=4,
//   dk = dv = 384, Q=256, bf16) the work is ~12 GFLOP (q.k^T and its
//   product with v on the causal half, q C and the state update) and the
//   bytes ~60 MB (q, k, v and h 12.6 MB each, the final fp32 C 9.4 MB),
//   ~195 operations a byte, under the card's ~295: bound by bytes at
//   3.35 TB/s (~18 us a layer).
//
// Two designs, by dtype (mlstm_scan_fwd dispatches; there is no other
// switch):
//
// bf16: the GPU form of the chunked scan on the tensor cores, three
//   kernels in order on one stream (one wrapper call), each a warpgroup:
//   1. Chunk state, grid (dk tiles of 64 x dv tiles of 128, chunks, B H):
//      the chunk's gates as block scans (b, u_j = i~_j - b_j, its prefix
//      max, g, the local stabiliser m_loc = max_j (g + u_j)), written by
//      the first tile's block to a record a chunk; then the chunk's own
//      state from zero, S_c = (kw k)^T v and n_c = sum_j kw_j k_j with
//      kw_j = exp(g + u_j - m_loc) <= 1, over 64-row pieces through a
//      2-stage cp.async ring (68 KB, three blocks an SM): kw k (made in
//      fp32) is the A operand, read MN-major, as a bf16 pair hi = bf16(x),
//      lo = bf16(x - hi) (two products into one fp32 accumulator); v
//      (bf16, exact) the B operand, MN-major. n_c on the CUDA cores.
//   2. State passing, grid (dk (dv + 1) / 1024, B H), fp32 on the CUDA
//      cores in chunk order: m_{c+1} = max(g_c + m_c, m_loc_c), C_{c+1}
//      = exp(g_c + m_c - m_{c+1}) C_c + exp(m_loc_c - m_{c+1}) S_c and n
//      the same (both factors <= 1; m_{c+1} is the reference's m'), from
//      C = n = 0, m = -1e30; each later chunk's incoming C written as a
//      bf16 pair (hi, lo: made once here, not once a row tile), its
//      incoming n over its n_c (chunk 0's state, zero, is not read), the
//      final state to the outputs.
//   3. Chunk scan, grid (pairs of 64-row tiles x dv slices of 128,
//      chunks, B H), the heaviest pairs first, two warpgroups a block,
//      one a row tile i (199 KB at dk = 384, one block an SM): the q
//      tiles resident, every other copy made once for both; for a chunk
//      after the first, exp(b_i + m - m_i) scale (q_i C_in) over 64-row
//      dk slabs of C_in's pair through a 2-stage cp.async ring (the next
//      slab's copies in flight while the tensor cores take this one),
//      q_i.n_in on the CUDA cores meanwhile; then for each 64-row tile j at or
//      below i, in order: S = q_i k_j^T (exact bf16 operands, K = dk), W =
//      exp((b_i - m_i) + u_j) S scale on the fp32 fragment (0 above the
//      diagonal, set before the exponent, which is positive there), den +=
//      W's row sums in fp32, W as a bf16 pair from registers times v_j
//      (MN-major); k_j in the C_in ring's space, tile j+1's copies in
//      flight while tile j's W and W v_j run, v_j in two stages. One
//      warpgroup's exponents run while the other's products do. h = num
//      / max(|den|, exp(-m_i)) rounded once, staged in shared memory and
//      written by 16-byte rows.
//   What it recomputes: q_i k_j^T once a dv slice (3 times at dv = 384, ~10%
//   of the work), the gates once a block of kernels 1 and 3 reads them
//   (O(Q)). Scratch: the per-chunk states and n, B H nc dk (dv + 1) fp32
//   (37.8 MB at the path's shape), the incoming C's pairs (the same size
//   again), and a gate record a chunk (b, the intra-chunk stabiliser b_i +
//   max_{j<=i} u_j, u; g, m_loc). Its own floor in bytes: the 60 MB above
//   plus the states written (37.8 MB), read by the passing (37.8 MB), the
//   pairs written (28.3 MB) and read by the scan (28.3 MB), ~192 MB: 0.057
//   ms at 3.35 TB/s, 3.2x the bound. What it reads again from L2 goes beyond
//   that: k 3 times and v 6 times in kernel 1 (by its tiles), q_i and k_j
//   once a dv slice and C_in's pair once a pair of row tiles in kernel 3.
//   One bf16 rounding of kw k, C_in or W instead of its pair would read up
//   to 1.4e-3, 1.2e-3 and 2.8e-3 relative L2 on C or h
//   (tests/test_torch_sm90_numerics.py), over the limit of 6e-4; the pairs
//   read 7e-5-1.6e-4. Rows past S or past Q are zero-filled by the 16-byte
//   cp.async loads; their u is -1e30, so they add nothing. No float atomics:
//   every sum has a fixed order, and two runs give equal bits.
//
// fp32: the first, CUDA-core version (wgmma has no fp32 operands; the
//   xLSTM fp32 gate rests on it), one kernel. What it keeps from the TPU
//   kernel: the chunk's (Q, Q) weights and the state never reach device
//   memory.
//   * On the TPU the chunk axis was the sequential grid axis and the
//     (dk, dv) state sat in VMEM. At dk = dv = 384 one head's fp32 C is
//     576 KiB, over an SM's 227 KiB, so one block owns one (b, h,
//     64-column slice of dv) and loops over the chunks itself, carrying
//     its (dk, 64) columns of C (96 KiB) in shared memory. n and m do not
//     depend on dv: every block recomputes them (O(Q) and O(Q dk) work),
//     and the slice-0 block writes them.
//   * The stabilisers come from the gates alone, O(Q) work before any
//     product: m_intra_i = b_i + prefix-max_{j<=i}(i~_j - b_j) (a block
//     scan), the state's new max from a block max. So every exponent the
//     products need, exp(D_ij - m_i) and exp(b_i + m - m_i), is at most
//     (a rounding above) 0.
//   * The intra-chunk q.k^T is tiled over 64 rows x 64 columns x 32-wide
//     dk slabs, only on tiles with a column at or left of the diagonal
//     (the diagonal tile masks j > i to 0): a (64, 64) weight tile then
//     multiplies the (64, 64) v tile of the slice. Each thread owns a 4 x
//     4 micro-tile of every product; operands sit in shared memory
//     transposed so a thread reads 4 rows and 4 columns as two float4s.
//   * q C reads the slice of C from shared memory over the same dk
//     slabs; the state update is (kw k)^T v over 32-row slabs of the
//     chunk, 64 rows of dk at a time.
//   * Shared memory: (65 dk + 14,528) floats, 157,952 bytes at dk = 384,
//     as dynamic shared memory; 128 registers a thread, 256 threads a
//     block, one block an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;    // one gate row per thread: Q <= 256
constexpr int kMaxQ = kThreads;
constexpr int kT = 64;           // row / column tile, dv slice, dk tile
constexpr int kDS = 32;          // dk slab of q.k^T and q C; chunk slab
constexpr int kLd = kT + 4;      // padded tile row (keeps float4 aligned)
constexpr int kMaxDK = 512;
constexpr float kNegBig = -1e30f;
constexpr float kPadF = 30.f;

// (the CUDA-core kernel is built for fp32 only: bf16 takes the
// tensor-core kernels below)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// min(x, 0) - log1p(exp(-|x|)): logsigmoid as torch and jax compute it
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

constexpr size_t smem_floats(int dk) {
  return (size_t)dk * kT + dk + 2 * kDS * kLd + 2 * kT * kLd + 5 * kMaxQ +
         2 * kT + 64;
}

// rows r0.. r0+63 of the chunk, dk columns d0.. d0+31, into dst[d][r]
// (rows past the chunk or past S read as 0)
template <typename T>
__device__ __forceinline__ void load_rows_t(const T* __restrict__ src,
                                            float (*dst)[kLd], size_t base,
                                            size_t row_stride, int t0,
                                            int r0, int Q, int S, int d0) {
  for (int e = threadIdx.x; e < kT * kDS; e += kThreads) {
    const int r = e / kDS, d = e % kDS;
    const int lr = r0 + r;
    float x = 0.f;
    if (lr < Q && t0 + lr < S)
      x = to_f(src[base + (size_t)(t0 + lr) * row_stride + d0 + d]);
    dst[d][r] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, T* __restrict__ hout,
                  float* __restrict__ cfin, float* __restrict__ nfin,
                  float* __restrict__ mfin, int S, int H, int DK, int DV,
                  int Q, float scale) {
  extern __shared__ float4 smem4[];
  float* c_s = reinterpret_cast<float*>(smem4);      // [DK][kT]
  float* n_s = c_s + (size_t)DK * kT;                // [DK]
  float (*a_s)[kLd] = reinterpret_cast<float (*)[kLd]>(n_s + DK);
  float (*b_s)[kLd] = a_s + kDS;                     // [kDS][kLd] each
  float (*w_s)[kLd] = b_s + kDS;                     // [kT][kLd]
  float (*v_s)[kLd] = w_s + kT;                      // [kT][kLd]
  float* bcs_s = reinterpret_cast<float*>(v_s + kT); // [kMaxQ] each:
  float* ii_s = bcs_s + kMaxQ;                       //   i~
  float* mi_s = ii_s + kMaxQ;                        //   m_i
  float* iw_s = mi_s + kMaxQ;                        //   exp(b_i + m - m_i)
  float* kw_s = iw_s + kMaxQ;                        //   exp(w_state - m')
  float* den_s = kw_s + kMaxQ;                       // [kT]
  float* qn_s = den_s + kT;                          // [kT]
  float* red_s = qn_s + kT;                          // 32 + 2 scalars

  const int v0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t qk_stride = (size_t)H * DK, v_stride = (size_t)H * DV;
  const size_t qk_base = (size_t)b * S * qk_stride + (size_t)h * DK;
  const size_t v_base = (size_t)b * S * v_stride + (size_t)h * DV;

  for (int i = tid; i < DK * kT; i += kThreads) c_s[i] = 0.f;
  for (int i = tid; i < DK; i += kThreads) n_s[i] = 0.f;
  float m_run = kNegBig;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;

    // ---- the gates: b, g, the stabilisers, the state weights (O(Q))
    const bool row = tid < Q;
    float iv = kNegBig, fv = kPadF;
    if (row && t0 + tid < S) {
      const size_t gi = ((size_t)b * S + t0 + tid) * H + h;
      iv = ig[gi];
      fv = fg[gi];
    }
    const float bcs = block_scan<false>(row ? log_sigmoid(fv) : 0.f, red_s);
    if (tid == Q - 1) red_s[32] = bcs;
    const float pmax = block_scan<true>(row ? iv - bcs : -INFINITY, red_s);
    const float g = red_s[32];
    const float m_inter = bcs + m_run;
    const float mi = fmaxf(bcs + pmax, m_inter);
    const float ws = row ? g - bcs + iv : -INFINITY;
    const float wmax = block_scan<true>(ws, red_s);
    if (tid == kThreads - 1) red_s[33] = wmax;
    __syncthreads();
    const float m_new = fmaxf(g + m_run, red_s[33]);
    const float carry = expf(g + m_run - m_new);
    bcs_s[tid] = bcs;
    ii_s[tid] = iv;
    mi_s[tid] = mi;
    iw_s[tid] = expf(m_inter - mi);
    kw_s[tid] = row ? expf(ws - m_new) : 0.f;
    __syncthreads();

    // ---- h, 64 chunk rows at a time
    for (int r0 = 0; r0 < Q; r0 += kT) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      __syncthreads();                   // the last tile's h read den_s
      if (tid < kT) den_s[tid] = qn_s[tid] = 0.f;

      // the causal intra-chunk sum: column tiles at or left of the diagonal
      for (int c0 = 0; c0 <= r0; c0 += kT) {
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int d0 = 0; d0 < DK; d0 += kDS) {
          __syncthreads();
          load_rows_t(q, a_s, qk_base, qk_stride, t0, r0, Q, S, d0);
          load_rows_t(k, b_s, qk_base, qk_stride, t0, c0, Q, S, d0);
          __syncthreads();
#pragma unroll
          for (int d = 0; d < kDS; ++d) {
            const float4 a = *reinterpret_cast<const float4*>(&a_s[d][ty * 4]);
            const float4 bb = *reinterpret_cast<const float4*>(&b_s[d][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
          }
        }
        // weights exp(D_ij - m_i) (q_i.k_j scale), 0 above the diagonal
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = r0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gj = c0 + tx * 4 + j;
            float w = 0.f;
            if (gj <= gi && gi < Q)
              w = sc[i][j] * scale *
                  expf(bcs_s[gi] - bcs_s[gj] + ii_s[gj] - mi_s[gi]);
            w_s[ty * 4 + i][tx * 4 + j] = w;
          }
        }
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int r = e / kT, cc = e % kT;
          const int lr = c0 + r;
          float x = 0.f;
          if (lr < Q && t0 + lr < S)
            x = to_f(v[v_base + (size_t)(t0 + lr) * v_stride + v0 + cc]);
          v_s[r][cc] = x;
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < kT; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][tx * 4]);
          const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = w_s[ty * 4 + i][j];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][jj] = fmaf(w, vj[jj], acc[i][jj]);
          }
        }
        if (tid < kT) {
          float s = den_s[tid];
          for (int j = 0; j < kT; ++j) s += w_s[tid][j];
          den_s[tid] = s;
        }
      }

      // the carried state's term: q C (the slice) and q.n
      float qc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) qc[i][j] = 0.f;
      for (int d0 = 0; d0 < DK; d0 += kDS) {
        __syncthreads();
        load_rows_t(q, a_s, qk_base, qk_stride, t0, r0, Q, S, d0);
        __syncthreads();
#pragma unroll
        for (int d = 0; d < kDS; ++d) {
          const float4 a = *reinterpret_cast<const float4*>(&a_s[d][ty * 4]);
          const float4 cc = *reinterpret_cast<const float4*>(
              &c_s[(size_t)(d0 + d) * kT + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) qc[i][j] = fmaf(av[i], cv[j], qc[i][j]);
        }
        if (tid < kT) {
          float s = qn_s[tid];
          for (int d = 0; d < kDS; ++d) s = fmaf(a_s[d][tid], n_s[d0 + d], s);
          qn_s[tid] = s;
        }
      }
      __syncthreads();                   // den_s, qn_s complete

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lr = ty * 4 + i, gi = r0 + lr;
        if (gi < Q && t0 + gi < S) {
          const float iw = iw_s[gi];
          const float den = den_s[lr] + iw * qn_s[lr] * scale;
          const float lim = fmaxf(fabsf(den), expf(-mi_s[gi]));
          T* hr = hout + v_base + (size_t)(t0 + gi) * v_stride + v0 + tx * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hr[j] = from_f<T>((acc[i][j] + iw * qc[i][j] * scale) / lim);
        }
      }
    }
    __syncthreads();                     // every row read the old state

    // ---- the state update: C = carry C + (kw k)^T v, 64 rows of dk a time
    for (int d0 = 0; d0 < DK; d0 += kT) {
      float su[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) su[i][j] = 0.f;
      for (int j0 = 0; j0 < Q; j0 += kDS) {
        __syncthreads();
        for (int e = tid; e < kDS * kT; e += kThreads) {
          const int r = e / kT, cc = e % kT;
          const int lr = j0 + r;
          float kx = 0.f, vx = 0.f;
          if (lr < Q && t0 + lr < S) {
            kx = kw_s[lr] * to_f(k[qk_base + (size_t)(t0 + lr) * qk_stride +
                                   d0 + cc]);
            vx = to_f(v[v_base + (size_t)(t0 + lr) * v_stride + v0 + cc]);
          }
          a_s[r][cc] = kx;
          b_s[r][cc] = vx;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kDS; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(&a_s[r][ty * 4]);
          const float4 bb = *reinterpret_cast<const float4*>(&b_s[r][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) su[i][j] = fmaf(av[i], bv[j], su[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* cp = &c_s[(size_t)(d0 + ty * 4 + i) * kT + tx * 4 + j];
          *cp = fmaf(carry, *cp, su[i][j]);
        }
    }
    // n = carry n + sum_j kw_j k_j (every block; no other thread reads n_s
    // until the next chunk's h)
    for (int d = tid; d < DK; d += kThreads) {
      float s = 0.f;
      for (int j = 0; j < Q && t0 + j < S; ++j)
        s = fmaf(kw_s[j], to_f(k[qk_base + (size_t)(t0 + j) * qk_stride + d]),
                 s);
      n_s[d] = fmaf(carry, n_s[d], s);
    }
    m_run = m_new;
    __syncthreads();
  }

  const size_t st = (size_t)b * H + h;
  for (int e = tid; e < DK * kT; e += kThreads) {
    const int d = e / kT, cc = e % kT;
    cfin[(st * DK + d) * DV + v0 + cc] = c_s[e];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < DK; d += kThreads) nfin[st * DK + d] = n_s[d];
    if (tid == 0) mfin[st] = m_run;
  }
}

int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* hout, void* cfin, void* nfin, void* mfin,
           int B, int S, int H, int DK, int DV, int Q, float scale,
           cudaStream_t s) {
  static bool smem_set[64] = {};
  const int smem = (int)(smem_floats(kMaxDK) * sizeof(float));
  cudaError_t err = sm90::allow_smem(mlstm_scan_kernel<float>, smem,
                                     smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(DV / kT, H, B);
  mlstm_scan_kernel<float>
      <<<grid, kThreads, smem_floats(DK) * sizeof(float), s>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)ig, (const float*)fg, (float*)hout, (float*)cfin,
          (float*)nfin, (float*)mfin, S, H, DK, DV, Q, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16: tensor cores (wgmma), chunk states / state passing / chunk scan
// ---------------------------------------------------------------------

constexpr int kRowTile = 64;     // rows a tile of the chunk scan; rows a
                                 // piece and dk columns a tile of the
                                 // chunk states
constexpr int kDvSlice = 128;    // dv columns a block of kernels 1 and 3
constexpr int kWg = 128;         // one warpgroup
constexpr int kBlk = kRowTile * 128;           // 64 rows x 64 bf16: 8 KB
// the gate record of a chunk: g, m_loc, 2 unused, then b, the
// intra-chunk stabiliser b_i + max_{j<=i} u_j, and u, Q floats each
constexpr int kRecHead = 4;
// a 2-stage ring of 64-row pieces (k then its weighted hi, the lo, v's
// 128 columns); kw, the scans' totals, n's halves; 1 KB to align
constexpr int kStateSmem = 2 * 4 * kBlk + kMaxQ * 4 + 16 * 4 + kWg * 4 +
                           1024;
constexpr int kScanWgs = 2;      // warpgroups a chunk-scan block, a row
                                 // tile each
constexpr int kScanThreads = kScanWgs * kWg;
constexpr int kBlockRows = kScanWgs * kRowTile;
// the warpgroups' q tiles, k_j or the C_in ring (2 stages of hi and lo,
// 128 columns each), a 2-stage ring of v_j (128 columns), u and q.n; 1 KB
// to align
constexpr int scan_smem(int dk) {
  return (kScanWgs * (dk / 64) + (dk / 64 > 8 ? dk / 64 : 8) + 4) * kBlk +
         (kMaxQ + kBlockRows) * 4 + 1024;
}

__device__ __forceinline__ size_t rec_len(int Q) {
  return (size_t)kRecHead + 3 * (size_t)Q;
}

// inclusive scan (sum, or max with kMax) over the rows 2t, 2t + 1 of the
// block's kWg threads t; tot_s: 4 floats of this scan's own
template <bool kMax>
__device__ __forceinline__ float2 scan_pairs(float a, float b,
                                             float* tot_s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float id = kMax ? -INFINITY : 0.f;
  float incl = kMax ? fmaxf(a, b) : a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = kMax ? fmaxf(u, incl) : u + incl;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = id;
  if (lane == 31) tot_s[warp] = incl;
  __syncthreads();
  float off = id;
  for (int w = 0; w < warp; ++w)
    off = kMax ? fmaxf(off, tot_s[w]) : off + tot_s[w];
  const float base = kMax ? fmaxf(off, excl) : off + excl;
  const float r0 = kMax ? fmaxf(base, a) : base + a;
  return make_float2(r0, kMax ? fmaxf(r0, b) : r0 + b);
}

// 1. the chunk's gates (to its record, by the first tile's block) and its
// state from zero, S_c (64 dk rows x 128 dv columns) = (kw k)^T v and, in
// the first dv tile's blocks, n_c; over 64-row pieces through a 2-stage
// ring
__global__ void __launch_bounds__(kWg)
mlstm_chunk_state_sm90(const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ ig,
                       const float* __restrict__ fg,
                       float* __restrict__ states, float* __restrict__ gates,
                       int S, int H, int DK, int DV, int Q, int nc) {
  constexpr int kStage = 4 * kBlk;             // k (then hi), lo, v
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* kw_s = reinterpret_cast<float*>(gbase + 2 * kStage);
  float* red_s = kw_s + kMaxQ;                 // 3 scans' totals, g, m_loc
  float* n_s = red_s + 16;                     // n's two halves

  const int n_dvt = (DV + kDvSlice - 1) / kDvSlice;
  const int dkt = blockIdx.x / n_dvt, dvt = blockIdx.x % n_dvt;
  const int c = blockIdx.y, bh = blockIdx.z, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int dk0 = dkt * kRowTile, dv0 = dvt * kDvSlice;
  const int pc = min(kDvSlice, DV - dv0) / 8;
  const size_t qk_ld = (size_t)H * DK, v_ld = (size_t)H * DV;
  const size_t row0 = (size_t)b * S + t0;
  const __nv_bfloat16* kg = k + row0 * qk_ld + (size_t)h * DK + dk0;
  const __nv_bfloat16* vg = v + row0 * v_ld + (size_t)h * DV + dv0;
  const int n_pc = (rows + kRowTile - 1) / kRowTile;   // live pieces

  // piece p's k and v rows into stage p % 2 (zero past `rows`)
  auto load_piece = [&](int p) {
    const uint32_t st = base + (p & 1) * kStage;
    const int r0 = p * kRowTile;
    sm90::load_rows<kRowTile, 8, kWg>(st, kg + (size_t)r0 * qk_ld, qk_ld,
                                      rows - r0, 8, tid);
    sm90::load_rows<kRowTile, 16, kWg>(st + 2 * kBlk,
                                       vg + (size_t)r0 * v_ld, v_ld,
                                       rows - r0, pc, tid);
  };
  load_piece(0);
  sm90::cp_async_commit();

  // the gates: thread t owns rows 2t, 2t + 1; rows past S are pads (i~ =
  // -1e30, f~ = 30), rows past Q are not rows (b flat, u = -inf)
  const int r0 = 2 * tid;
  float ls[2], iv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + e;
    const bool real = r < rows;
    iv[e] = real ? ig[(row0 + r) * H + h] : kNegBig;
    ls[e] = r < Q ? log_sigmoid(real ? fg[(row0 + r) * H + h] : kPadF)
                  : 0.f;
  }
  const float2 bb = scan_pairs<false>(ls[0], ls[1], red_s);
  const float u0 = r0 < Q ? iv[0] - bb.x : -INFINITY;
  const float u1 = r0 + 1 < Q ? iv[1] - bb.y : -INFINITY;
  const float2 pm = scan_pairs<true>(u0, u1, red_s + 4);
  if (r0 == Q - 1) red_s[12] = bb.x;
  if (r0 + 1 == Q - 1) red_s[12] = bb.y;
  __syncthreads();
  const float g = red_s[12];
  const float w0 = g + u0, w1 = g + u1;
  const float2 wm = scan_pairs<true>(w0, w1, red_s + 8);
  if (tid == kWg - 1) red_s[13] = wm.y;
  __syncthreads();
  const float m_loc = red_s[13];
  kw_s[r0] = r0 < Q ? expf(w0 - m_loc) : 0.f;
  kw_s[r0 + 1] = r0 + 1 < Q ? expf(w1 - m_loc) : 0.f;
  if (blockIdx.x == 0) {
    float* rec = gates + ((size_t)bh * nc + c) * rec_len(Q);
    if (tid == 0) {
      rec[0] = g;
      rec[1] = m_loc;
    }
    const float bv[2] = {bb.x, bb.y}, pv[2] = {pm.x, pm.y},
                uv[2] = {u0, u1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + e;
      if (r < Q) {
        rec[kRecHead + r] = bv[e];
        rec[kRecHead + Q + r] = bv[e] + pv[e];
        rec[kRecHead + 2 * Q + r] = uv[e];
      }
    }
  }

  // S_c (dk x dv) += (kw k)^T v piece by piece: both operands MN-major
  // (rows are the chunk's), kw k as hi + lo
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float npart = 0.f;                           // column tid % 64, half
  for (int p = 0; p < n_pc; ++p) {
    sm90::cp_async_wait<0>();                  // piece p landed
    __syncthreads();                           // ... for every thread; kw;
                                               // stage p-1 is free
    if (p + 1 < n_pc) load_piece(p + 1);
    sm90::cp_async_commit();
    const uint32_t kh_s = base + (p & 1) * kStage, kl_s = kh_s + kBlk;
    const uint32_t vv_s = kh_s + 2 * kBlk;
    uint8_t* kraw = gbase + (kh_s - base);
    if (dvt == 0) {                            // n: rows of one half
      const int d = tid % 64, rh = (tid / 64) * 32;
      for (int rr = 0; rr < 32; ++rr) {
        const int r = rh + rr;
        const __nv_bfloat16 x = *reinterpret_cast<const __nv_bfloat16*>(
            kraw + sm90::tile_off(kRowTile, r, d / 8) + (d % 8) * 2);
        npart = fmaf(kw_s[p * kRowTile + r], __bfloat162float(x), npart);
      }
    }
    __syncthreads();                           // k read before it is hi
    for (int i = tid; i < kRowTile * 8; i += kWg) {
      const int r = i / 8, ch = i % 8;
      const uint32_t o = sm90::tile_off(kRowTile, r, ch);
      const uint4 u = *reinterpret_cast<const uint4*>(kraw + o);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float w = kw_s[p * kRowTile + r];
      float x[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(k2[e]);
        x[2 * e] = f.x * w;
        x[2 * e + 1] = f.y * w;
      }
      uint4 hi, lo;
      sm90::split8(x, hi, lo);
      *reinterpret_cast<uint4*>(kraw + o) = hi;
      *reinterpret_cast<uint4*>(gbase + (kl_s - base) + o) = lo;
    }
    sm90::fence_proxy_async();
    __syncthreads();
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      sm90::wgmma_ss<128, 1, 1>(
          acc, sm90::desc_sw128(kh_s + ks * 2048, kBlk, 1024),
          sm90::desc_sw128(vv_s + ks * 2048, kBlk, 1024), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      sm90::wgmma_ss<128, 1, 1>(
          acc, sm90::desc_sw128(kl_s + ks * 2048, kBlk, 1024),
          sm90::desc_sw128(vv_s + ks * 2048, kBlk, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }

  const size_t len = (size_t)DK * (DV + 1);
  float* st = states + ((size_t)bh * nc + c) * len;
  const int dr = dk0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = dv0 + 8 * j + 2 * (lane % 4);
    if (col < DV) {
      *reinterpret_cast<float2*>(st + (size_t)dr * DV + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(st + (size_t)(dr + 8) * DV + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (dvt == 0) {
    n_s[tid] = npart;
    __syncthreads();
    if (tid < 64) st[(size_t)DK * DV + dk0 + tid] = n_s[tid] + n_s[tid + 64];
  }
}

// 2. state passing in chunk order: each later chunk's incoming C as a
// bf16 pair (hi then lo, row-major (dk, dv) each) into `cpair`, its
// incoming n written over its n_c (chunk 0's state, zero, is not read and
// not written); the final state out. A thread owns 4 values of the
// chunk's dk (dv + 1) record (C, then n); the loads of 4 chunks are issued
// before their dependent updates.
__global__ void __launch_bounds__(256)
mlstm_state_pass(float* __restrict__ states, const float* __restrict__ gates,
                 __nv_bfloat16* __restrict__ cpair, float* __restrict__ cfin,
                 float* __restrict__ nfin, float* __restrict__ mfin, int DK,
                 int DV, int Q, int nc) {
  const size_t len = (size_t)DK * (DV + 1), cn = (size_t)DK * DV;
  const size_t e = ((size_t)blockIdx.x * 256 + threadIdx.x) * 4;
  const int bh = blockIdx.y;
  if (e >= len) return;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegBig;
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 sc[4];
    float gv[4], ml[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= nc) break;
      const size_t bc = (size_t)bh * nc + c0 + j;
      sc[j] = *reinterpret_cast<const float4*>(states + bc * len + e);
      gv[j] = gates[bc * rec_len(Q)];
      ml[j] = gates[bc * rec_len(Q) + 1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= nc) break;
      const size_t bc = (size_t)bh * nc + c0 + j;
      if (c0 + j > 0 && e < cn) {
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(st.x, st.y);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(st.z, st.w);
        const float2 f01 = __bfloat1622float2(h01);
        const float2 f23 = __bfloat1622float2(h23);
        __nv_bfloat16* hp = cpair + bc * 2 * cn + e;
        *reinterpret_cast<uint2*>(hp) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&h01),
            *reinterpret_cast<const uint32_t*>(&h23));
        *reinterpret_cast<uint2*>(hp + cn) = make_uint2(
            sm90::pack_bf16(st.x - f01.x, st.y - f01.y),
            sm90::pack_bf16(st.z - f23.x, st.w - f23.y));
      } else if (c0 + j > 0) {
        *reinterpret_cast<float4*>(states + bc * len + e) = st;
      }
      const float m_next = fmaxf(gv[j] + m, ml[j]);
      const float a = expf(gv[j] + m - m_next), w = expf(ml[j] - m_next);
      st.x = fmaf(a, st.x, w * sc[j].x);
      st.y = fmaf(a, st.y, w * sc[j].y);
      st.z = fmaf(a, st.z, w * sc[j].z);
      st.w = fmaf(a, st.w, w * sc[j].w);
      m = m_next;
    }
  }
  if (e < cn)
    *reinterpret_cast<float4*>(cfin + (size_t)bh * cn + e) = st;
  else
    *reinterpret_cast<float4*>(nfin + (size_t)bh * DK + (e - cn)) = st;
  if (e == 0) mfin[bh] = m;
}

// 3. the chunk scan of two 64-row tiles of one chunk and one dv slice, a
// warpgroup each; the copies serve both
__global__ void __launch_bounds__(kScanThreads)
mlstm_chunk_scan_sm90(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ states,
                      const __nv_bfloat16* __restrict__ cpair,
                      const float* __restrict__ gates,
                      __nv_bfloat16* __restrict__ hout, int S, int H, int DK,
                      int DV, int Q, int nc, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const int nkb = DK / 64;                     // 64-column blocks of dk
  // the warpgroups' q tiles; k_j, or before the intra tiles the C_in
  // ring (2 stages of hi and lo, 2 blocks each); v_j's 2 stages of 2
  // blocks (then the staged h)
  const uint32_t k_s = base + kScanWgs * nkb * kBlk;
  const uint32_t v_s = k_s + max(nkb, 8) * kBlk;
  float* u_s = reinterpret_cast<float*>(gbase + (v_s + 4 * kBlk - base));
  float* qn_s = u_s + kMaxQ;

  const int n_ds = (DV + kDvSlice - 1) / kDvSlice;
  const int n_rb = (Q + kBlockRows - 1) / kBlockRows;
  const int ib = n_rb - 1 - (int)blockIdx.x / n_ds;    // heaviest first
  const int ds = blockIdx.x % n_ds, c = blockIdx.y;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, wg = tid / kWg, lane = tid % 32;
  const int warp = (tid % kWg) / 32;           // in the warpgroup
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int i0 = ib * kBlockRows + wg * kRowTile;      // this warpgroup's
                                                       // tile
  if (ib * kBlockRows >= rows) return;         // a block wholly past S
  // the last tile j with rows: both warpgroups run every tile j to it (a
  // tile above a warpgroup's diagonal is masked to 0 and adds exact
  // zeros; a row tile past S has q = 0), so no product sits in a branch
  const int jlast = min(ib * kScanWgs + kScanWgs - 1, (rows - 1) / kRowTile);
  const int d0 = ds * kDvSlice, pc = min(kDvSlice, DV - d0) / 8;
  const size_t qk_ld = (size_t)H * DK, v_ld = (size_t)H * DV;
  const size_t row0 = (size_t)b * S + t0;      // the chunk's first row
  const size_t bc = (size_t)bh * nc + c;
  const uint32_t q_s = base + wg * nkb * kBlk;
  const __nv_bfloat16* qg = q + row0 * qk_ld + (size_t)h * DK;
  const __nv_bfloat16* kg = k + row0 * qk_ld + (size_t)h * DK;
  const __nv_bfloat16* vg = v + row0 * v_ld + (size_t)h * DV + d0;
  const __nv_bfloat16* cg = cpair + bc * 2 * DK * DV + d0;

  // tile j's k rows (every dk block) and v rows (the slice, into stage j
  // % 2), zero past `rows`; slab sl of C_in's pair into ring stage sl % 2
  auto load_k = [&](int jt) {
    const int j0 = jt * kRowTile;
    for (int kb = 0; kb < nkb; ++kb)
      sm90::load_rows<kRowTile, 8, kScanThreads>(
          k_s + kb * kBlk, kg + (size_t)j0 * qk_ld + kb * 64, qk_ld,
          rows - j0, 8, tid);
  };
  auto load_v = [&](int jt) {
    const int j0 = jt * kRowTile;
    sm90::load_rows<kRowTile, 16, kScanThreads>(
        v_s + (jt & 1) * 2 * kBlk, vg + (size_t)j0 * v_ld, v_ld, rows - j0,
        pc, tid);
  };
  auto load_c = [&](int sl) {
    const uint32_t dst = k_s + (sl & 1) * 4 * kBlk;
    const __nv_bfloat16* src = cg + (size_t)sl * 64 * DV;
    sm90::load_rows<kRowTile, 16, kScanThreads>(dst, src, DV, kRowTile, pc,
                                                tid);
    sm90::load_rows<kRowTile, 16, kScanThreads>(
        dst + 2 * kBlk, src + (size_t)DK * DV, DV, kRowTile, pc, tid);
  };
  // group 0: both tiles' q (zero past `rows`) and C_in's first slab
  // (after chunk 0); group 1: tile 0's k (chunk 0; later chunks after the
  // C_in term) and v
  for (int w = 0; w < kScanWgs; ++w) {
    const int r0 = ib * kBlockRows + w * kRowTile;
    for (int kb = 0; kb < nkb; ++kb)
      sm90::load_rows<kRowTile, 8, kScanThreads>(
          base + (w * nkb + kb) * kBlk,
          qg + (size_t)min(r0, rows - 1) * qk_ld + kb * 64, qk_ld,
          rows - r0, 8, tid);
  }
  if (c > 0) load_c(0);
  sm90::cp_async_commit();
  if (c == 0) load_k(0);
  load_v(0);
  sm90::cp_async_commit();

  // the carried stabiliser m (the passing's recurrence, same order), u of
  // the block's rows and those before (-1e30 past Q), this thread's rows'
  // b - m_i, m_i and exp(b_i + m - m_i) scale
  const size_t rl = rec_len(Q);
  const float* rec = gates + bc * rl;
  float m_in = kNegBig;
  for (int cc = 0; cc < c; ++cc) {
    const float* r = gates + ((size_t)bh * nc + cc) * rl;
    m_in = fmaxf(r[0] + m_in, r[1]);
  }
  for (int r = tid; r < (ib + 1) * kBlockRows; r += kScanThreads)
    u_s[r] = r < Q ? rec[kRecHead + 2 * Q + r] : kNegBig;
  const int lr = warp * 16 + lane / 4;
  float bm[2], mi[2], iw[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rr = min(i0 + lr + 8 * e, Q - 1);
    const float bi = rec[kRecHead + rr];
    mi[e] = fmaxf(rec[kRecHead + Q + rr], bi + m_in);
    bm[e] = bi - mi[e];
    iw[e] = expf(bi + m_in - mi[e]) * scale;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (c > 0) {
    // q_i C_in over 64-row dk slabs, C_in's hi then lo (MN-major: rows are
    // K), slab sl+1's copies in flight while the tensor cores take sl
    for (int sl = 0; sl < nkb; ++sl) {
      if (sl == 0)
        sm90::cp_async_wait<1>();              // q and slab 0 landed
      else
        sm90::cp_async_wait<0>();              // slab sl landed
      sm90::fence_proxy_async();
      __syncthreads();                         // ... for every thread;
                                               // stage sl-1 is free
      if (sl + 1 < nkb) load_c(sl + 1);
      sm90::cp_async_commit();
      const uint32_t ch_s = k_s + (sl & 1) * 4 * kBlk, cl_s = ch_s + 2 * kBlk;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<128, 1>(
            acc, sm90::desc_sw128(q_s + sl * kBlk + kk * 32, 16, 1024),
            sm90::desc_sw128(ch_s + kk * 2048, kBlk, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<128, 1>(
            acc, sm90::desc_sw128(q_s + sl * kBlk + kk * 32, 16, 1024),
            sm90::desc_sw128(cl_s + kk * 2048, kBlk, 1024), 1);
      sm90::wgmma_commit();
      if (sl == 0) {
        // q . n_in of the block's rows on the CUDA cores while the
        // products run: thread t takes half t % 2 of row t / 2's dk
        const int rr = tid / 2, half = tid % 2, nch = DK / 16;
        const uint32_t qt = (rr / kRowTile) * nkb * kBlk;
        const float* nin = states + bc * DK * (DV + 1) + (size_t)DK * DV;
        float s = 0.f;
        for (int ch = half * nch; ch < (half + 1) * nch; ++ch) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              gbase + qt + sm90::tile_off(kRowTile, rr % kRowTile, ch));
          const __nv_bfloat162* q2 =
              reinterpret_cast<const __nv_bfloat162*>(&u);
          const float4 n0 = *reinterpret_cast<const float4*>(nin + ch * 8);
          const float4 n1 =
              *reinterpret_cast<const float4*>(nin + ch * 8 + 4);
          const float nv[8] = {n0.x, n0.y, n0.z, n0.w,
                               n1.x, n1.y, n1.z, n1.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(q2[e]);
            s = fmaf(f.x, nv[2 * e], s);
            s = fmaf(f.y, nv[2 * e + 1], s);
          }
        }
        const float o = __shfl_xor_sync(0xffffffffu, s, 1);
        if (half == 0) qn_s[rr] = s + o;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[4 * j] *= iw[0];
      acc[4 * j + 1] *= iw[0];
      acc[4 * j + 2] *= iw[1];
      acc[4 * j + 3] *= iw[1];
    }
    __syncthreads();                           // every product read the
                                               // ring, k_j's space
    load_k(0);
    sm90::cp_async_commit();
  }

  // the causal intra-chunk sum, tile j = 0..i in order; tile j+1's
  // copies in flight while tile j's W and W v_j are computed
  float den[2] = {0.f, 0.f};
  for (int jt = 0; jt <= jlast; ++jt) {
    sm90::cp_async_wait<0>();                  // tile jt (and q) landed
    sm90::fence_proxy_async();
    __syncthreads();                           // ... for every thread; v
                                               // stage jt-1 is free
    // S = q_i k_j^T, both K-major, K = dk
    float sv[32];
    sm90::wgmma_fence();
    for (int kb = 0; kb < nkb; ++kb) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<64, 0>(
            sv, sm90::desc_sw128(q_s + kb * kBlk + kk * 32, 16, 1024),
            sm90::desc_sw128(k_s + kb * kBlk + kk * 32, 16, 1024),
            kb > 0 || kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sv);
    __syncthreads();                           // every product read k_j
    if (jt < jlast) {
      load_k(jt + 1);
      load_v(jt + 1);
    }
    sm90::cp_async_commit();
    // W = exp((b_i - m_i) + u_j) S scale, 0 above the diagonal (before the
    // exponent), its row sums, and W as the A fragments of a bf16 pair:
    // k16 slice ks is registers 8 ks .. 8 ks + 7
    const int j0 = jt * kRowTile;
    uint32_t wh[4][4], wl[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 8 * ks + 2 * i, e1 = i & 1;
        const int ri = i0 + lr + 8 * e1;
        const int jc = j0 + 16 * ks + 8 * (i >> 1) + 2 * (lane % 4);
        float w2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          w2[e] = jc + e <= ri
                      ? sv[a + e] * scale * __expf(bm[e1] + u_s[jc + e])
                      : 0.f;
        den[e1] += w2[0] + w2[1];
        const __nv_bfloat162 hb = __floats2bfloat162_rn(w2[0], w2[1]);
        const float2 hf = __bfloat1622float2(hb);
        wh[ks][i] = *reinterpret_cast<const uint32_t*>(&hb);
        wl[ks][i] = sm90::pack_bf16(w2[0] - hf.x, w2[1] - hf.y);
      }
    }
    // acc += W_hi v_j + W_lo v_j, v_j MN-major (rows are K)
    const uint32_t vs = v_s + (jt & 1) * 2 * kBlk;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = sm90::desc_sw128(vs + ks * 2048, kBlk, 1024);
      sm90::wgmma_rs<128, 1>(acc, wh[ks], db, 1);
      sm90::wgmma_rs<128, 1>(acc, wl[ks], db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm90::fence_regs(wh[ks]);
      sm90::fence_regs(wl[ks]);
    }
  }

  // den: the quad's partial row sums (the same bits in its four lanes),
  // + exp(b_i + m - m_i) scale q_i.n_in; h = num / max(|den|, exp(-m_i))
  // rounded once, staged over the v stages (one a warpgroup)
  float lim[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float d = den[e];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (c > 0) d += iw[e] * qn_s[wg * kRowTile + lr + 8 * e];
    lim[e] = fmaxf(fabsf(d), expf(-mi[e]));
  }
  uint8_t* hs = gbase + (v_s + wg * 2 * kBlk - base);
  __syncthreads();                             // every product is done
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t o = sm90::tile_off(kRowTile, lr + 8 * e, j) +
                         (lane % 4) * 4;
      *reinterpret_cast<__nv_bfloat162*>(hs + o) =
          __floats2bfloat162_rn(acc[4 * j + 2 * e] / lim[e],
                                acc[4 * j + 2 * e + 1] / lim[e]);
    }
  }
  __syncthreads();
  for (int i = tid % kWg; i < kRowTile * 16; i += kWg) {
    const int r = i / 16, ch = i % 16, row = i0 + r;
    if (row < rows && ch < pc)
      *reinterpret_cast<uint4*>(
          hout + (row0 + row) * v_ld + (size_t)h * DV + d0 + ch * 8) =
          *reinterpret_cast<const uint4*>(hs +
                                          sm90::tile_off(kRowTile, r, ch));
  }
}

int launch_sm90(const void* q, const void* k, const void* v, const void* ig,
                const void* fg, void* hout, void* cfin, void* nfin,
                void* mfin, void* work, int B, int S, int H, int DK, int DV,
                int Q, float scale, cudaStream_t s) {
  static bool set1[64] = {}, set3[64] = {};
  cudaError_t err = sm90::allow_smem(mlstm_chunk_state_sm90, kStateSmem,
                                     set1);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(mlstm_chunk_scan_sm90, scan_smem(kMaxDK), set3);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const int nc = (S + Q - 1) / Q;
  const int n_dvt = (DV + kDvSlice - 1) / kDvSlice;
  const int n_rb = (Q + kBlockRows - 1) / kBlockRows;
  const size_t len = (size_t)DK * (DV + 1), chunks = (size_t)B * H * nc;
  float* states = (float*)work;
  bf* cpair = (bf*)(states + chunks * len);
  float* gates = states + chunks * (len + (size_t)DK * DV);
  mlstm_chunk_state_sm90<<<dim3((DK / kRowTile) * n_dvt, nc, B * H), kWg,
                           kStateSmem, s>>>(
      (const bf*)k, (const bf*)v, (const float*)ig, (const float*)fg, states,
      gates, S, H, DK, DV, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_state_pass<<<dim3((unsigned)((len / 4 + 255) / 256), B * H), 256, 0,
                     s>>>(states, gates, cpair, (float*)cfin, (float*)nfin,
                          (float*)mfin, DK, DV, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_chunk_scan_sm90<<<dim3(n_rb * n_dvt, nc, B * H), kScanThreads,
                          scan_smem(DK), s>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, states, cpair, gates,
      (bf*)hout, S, H, DK, DV, Q, nc, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of q, k, v and h): 0 = float32, 1 = bfloat16. work: fp32 scratch
// of B H nc (dk (2 dv + 1) + 4 + 3 Q) values, nc = ceil(S / Q), for the
// bf16 kernels (the per-chunk states and n, the incoming C's bf16 pairs,
// the gate records); unused (may be null) in fp32. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess); a configuration
// the kernels are not built for returns cudaErrorInvalidValue without
// launching.
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                              const void* ig, const void* fg, void* hout,
                              void* cfin, void* nfin, void* mfin, void* work,
                              int B, int S, int H, int DK, int DV, int Q,
                              float scale, int dtype, void* stream) {
  if (DK <= 0 || DK % kT != 0 || DK > kMaxDK || DV <= 0 || DV % kT != 0 ||
      Q <= 0 || Q > kMaxQ || B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch(q, k, v, ig, fg, hout, cfin, nfin, mfin, B, S, H, DK, DV,
                  Q, scale, s);
  if (dtype == 1) {
    if (work == nullptr || (long long)B * H > 65535)
      return (int)cudaErrorInvalidValue;
    return launch_sm90(q, k, v, ig, fg, hout, cfin, nfin, mfin, work, B, S,
                       H, DK, DV, Q, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// What the bf16 chunk scan's tiles are, as mlstm_scan_tiled_plain models
// them (ROW_TILE and DV_SLICE in kernels/mlstm_scan/mlstm_scan.py): axis 0
// the rows a tile, 1 the dv columns a block; -1 otherwise.
extern "C" int mlstm_scan_sm90_tile(int axis) {
  return axis == 0 ? kRowTile : axis == 1 ? kDvSlice : -1;
}
// Dynamic shared memory (bytes) of the bf16 chunk-state kernel (0) and
// chunk-scan kernel (1) at this dk; -1 otherwise.
extern "C" int mlstm_scan_sm90_smem(int kernel, int dk) {
  return kernel == 0 ? kStateSmem : kernel == 1 ? scan_smem(dk) : -1;
}
