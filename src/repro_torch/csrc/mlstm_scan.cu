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
// What this design does about it: this first version is the simple,
//   right one and does NOT reach that bound: it computes in fp32 on the
//   CUDA cores (no wgmma, no TMA). What it keeps from the TPU kernel: the
//   chunk's (Q, Q) weights and the state never reach device memory.
//   * On the TPU the chunk axis was the sequential grid axis and the
//     (dk, dv) state sat in VMEM. At dk = dv = 384 one head's fp32 C is
//     576 KiB, over an SM's 227 KiB, so one block owns one (b, h,
//     64-column slice of dv) and loops over the chunks itself, carrying
//     its (dk, 64) columns of C (96 KiB) in shared memory. n and m do not
//     depend on dv: every block recomputes them (O(Q) and O(Q dk) work),
//     and the slice-0 block writes them. Slices of 64 give 6 x 4 x 4 = 96
//     blocks at B=4 (one wave on 132 SMs, one block an SM: the shared
//     memory binds); slices of 32 would give 192 blocks but recompute
//     q.k^T (the largest product) twelve times instead of six, for about
//     1.5x the work of the 64-wide split spread over 1.4x the SMs.
//   * The stabilisers come from the gates alone, O(Q) work before any
//     product: m_intra_i = b_i + prefix-max_{j<=i}(i~_j - b_j) (a block
//     scan), the state's new max from a block max. So every exponent the
//     products need, exp(D_ij - m_i) and exp(b_i + m - m_i), is at most
//     (a rounding above) 0.
//   * The intra-chunk q.k^T is tiled over 64 rows x 64 columns x 32-wide
//     dk slabs, only on tiles with a column at or left of the diagonal
//     (the diagonal tile masks j > i to 0), so no (Q, Q) matrix and no
//     full (Q, dk) tile is stored: a (64, 64) weight tile then multiplies
//     the (64, 64) v tile of the slice. Each thread owns a 4 x 4
//     micro-tile of every product; operands sit in shared memory
//     transposed so a thread reads 4 rows and 4 columns as two float4s.
//   * q C reads the slice of C from shared memory over the same dk
//     slabs; the state update is (kw k)^T v over 32-row slabs of the
//     chunk, 64 rows of dk at a time.
//   * Shared memory: (65 dk + 14,528) floats, 157,952 bytes at dk = 384
//     (the C slice 96 KiB, four 64-wide operand tiles, five gate rows of
//     Q), as dynamic shared memory (opted in at each launch).
//   * Registers (ptxas -v, the card's nvcc): 128 a thread in both
//     instantiations, with an 8-byte spill (4 bytes in fp32); 256 threads
//     a block, one block an SM (the shared memory binds).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;    // one gate row per thread: Q <= 256
constexpr int kMaxQ = kThreads;
constexpr int kT = 64;           // row / column tile, dv slice, dk tile
constexpr int kDS = 32;          // dk slab of q.k^T and q C; chunk slab
constexpr int kLd = kT + 4;      // padded tile row (keeps float4 aligned)
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
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* hout, void* cfin, void* nfin, void* mfin,
           int B, int S, int H, int DK, int DV, int Q, float scale,
           cudaStream_t s) {
  const size_t smem = smem_floats(DK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(DV / kT, H, B);
  mlstm_scan_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ig,
      (const float*)fg, (T*)hout, (float*)cfin, (float*)nfin, (float*)mfin,
      S, H, DK, DV, Q, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of q, k, v and h): 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess); a configuration
// the kernel is not built for returns cudaErrorInvalidValue without
// launching.
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                              const void* ig, const void* fg, void* hout,
                              void* cfin, void* nfin, void* mfin, int B,
                              int S, int H, int DK, int DV, int Q,
                              float scale, int dtype, void* stream) {
  if (DK <= 0 || DK % kT != 0 || DK > kMaxDK || DV <= 0 || DV % kT != 0 ||
      Q <= 0 || Q > kMaxQ || B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, ig, fg, hout, cfin, nfin, mfin, B, S, H,
                         DK, DV, Q, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ig, fg, hout, cfin, nfin, mfin, B,
                                 S, H, DK, DV, Q, scale, s);
  return (int)cudaErrorInvalidValue;
}
