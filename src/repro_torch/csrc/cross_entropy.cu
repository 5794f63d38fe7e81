// Fused LM-head cross-entropy: forward (ce_fwd) and the elementwise
// dlogits pass of its recompute backward (ce_dlogits), written for
// sm_90a.
//
// ce_fwd replaces: src/repro/kernels/cross_entropy/cross_entropy.py,
//   cross_entropy_pallas (_ce_kernel, pallas_call at :121).
//   For hidden h (T, D) and head W (D, V), both fp32 or both bf16, and
//   labels (T,) int32, it computes per token, all in fp32:
//     logits = h W (the product inside the kernel), softcap
//     c*tanh(logits/c) when c > 0, columns >= V masked, then the online
//     lse = m + log(max(l, 1e-30)), nll = lse - logits[label] and, for
//     label smoothing eps > 0, nll = (1-eps) nll + eps (lse - sum/V).
//   It writes nll (T,) and lse (T,) fp32; the wrapper applies the
//   weights and returns (sum nll*w, sum w), as the Pallas wrapper does.
//   W is read either as a (D, V) matrix or, with w_rows = 1, as the
//   rows of a (V, D) matrix: a tied head is the embedding table (V, D)
//   itself, so the kernel reads it in place instead of the wrapper
//   writing a (D, V) copy (206 MB at olmo-1b widths in bf16) per call.
//
// ce_dlogits is held against: src/repro/kernels/cross_entropy/ref.py::
//   _ce_bwd (:90-131), the body of its chunk loop. Given an fp32 logits
//   tile (R, V) recomputed by the caller, lse, labels, weights w and the
//   cotangent dloss (a device scalar), it writes in the compute dtype
//     dlogits = ((1-eps)(exp(l - lse) - onehot) [+ eps(exp(l - lse) -
//               1/V) when eps > 0]) * (w * dloss),
//   in that order of operations. The three products around it (the
//   recomputed tile, dh = dlogits W^T, dW += h^T dlogits) are outside
//   any Pallas kernel in the JAX package too (ref.py:111-125) and stay
//   library matmuls in the caller.
//
// What bounds them on the H100:
//   * ce_fwd: operations, 2*T*D*V (0.84 TFLOP at T=4096, D=2048,
//     V=50304) over the tensor cores' 989 TFLOP/s, ~0.85 ms; its bytes
//     (h and W read once, 0.22 GB in bf16) take ~0.07 ms.
//   * ce_dlogits: bytes, T*V*(4 + 2) (fp32 in, bf16 out; 1.2 GB at
//     T=4096) over 3.35 TB/s, ~0.37 ms.
//
// What the designs do about it:
//   * ce_fwd keeps the TPU kernel's point: no (T, V) logits tile ever
//     reaches device memory. On the TPU the vocab axis was a sequential
//     grid axis with the hidden tile resident in VMEM and the running
//     (max, sumexp, true logit, sum) in VMEM scratch. A block's 227 KB
//     of shared memory cannot hold a (tokens, 2048) hidden tile in fp32,
//     so here one block owns 32 tokens and loops over 64-column vocab
//     tiles itself; each tile's product is summed over D in 32-wide
//     steps with both h and W sub-tiles staged in shared memory, each
//     thread holding a 4x4 block of the tile in registers. The tile then
//     goes through shared memory to the reduction, one warp per 8
//     tokens, whose running (m, l, true logit, sum) stay in registers
//     across the vocab loop. This first version computes the product on
//     the CUDA cores in fp32 (no tensor cores), far from the bound, and
//     T/32 blocks (160 at the train step's T=5120) give each SM about
//     one block of 4 warps, too few to hide latency. Splitting the vocab
//     axis across blocks, with a pass that merges their (m, l) in a
//     fixed order, and tensor-core tiles are the next steps.
//   * ce_dlogits streams the tile once: each element is read once and
//     written once, consecutive threads on consecutive columns, one
//     block per row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBT = 32;          // tokens per block
constexpr int kBV = 64;          // vocab columns per tile
constexpr int kBK = 32;          // D step of the staged sub-tiles
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBT / kWarps;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
              const int* __restrict__ labels, float* __restrict__ nll,
              float* __restrict__ lse_out, int T_, int D, int V, int w_rows,
              float eps, float softcap) {
  __shared__ __align__(16) float h_s[kBK][kBT + 4];   // h_s[k][token]
  __shared__ __align__(16) float w_s[kBK][kBV + 4];   // w_s[k][column]
  __shared__ float s_s[kBT][kBV + 1];                 // the logits tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid / 16, tx = tid % 16;    // 8 x 16 threads, 4x4 each
  const int t0 = blockIdx.x * kBT;

  float m[kRowsPerWarp], l[kRowsPerWarp], tru[kRowsPerWarp],
      sum[kRowsPerWarp];
  int lab[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf; l[i] = 0.f; tru[i] = 0.f; sum[i] = 0.f;
    const int t = t0 + warp * kRowsPerWarp + i;
    lab[i] = t < T_ ? labels[t] : -1;
  }

  const int n_vt = (V + kBV - 1) / kBV;
  for (int vt = 0; vt < n_vt; ++vt) {
    const int v0 = vt * kBV;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kBK) {
      __syncthreads();                    // sub-tiles and s_s consumed
      for (int i = tid; i < kBT * kBK; i += kThreads) {
        const int t = i / kBK, kk = i % kBK;          // along D: coalesced
        const int tok = t0 + t, d = k0 + kk;
        h_s[kk][t] = (tok < T_ && d < D) ? to_f(h[(size_t)tok * D + d])
                                         : 0.f;
      }
      if (w_rows) {                                   // W^T rows (V, D)
        for (int i = tid; i < kBV * kBK; i += kThreads) {
          const int j = i / kBK, kk = i % kBK;
          const int col = v0 + j, d = k0 + kk;
          w_s[kk][j] = (col < V && d < D) ? to_f(w[(size_t)col * D + d])
                                          : 0.f;
        }
      } else {                                        // W (D, V)
        for (int i = tid; i < kBV * kBK; i += kThreads) {
          const int kk = i / kBV, j = i % kBV;
          const int col = v0 + j, d = k0 + kk;
          w_s[kk][j] = (col < V && d < D) ? to_f(w[(size_t)d * V + col])
                                          : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&h_s[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&w_s[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_s[ty * 4 + i][tx * 4 + j] = acc[i][j];
    __syncthreads();

    // online reduction: one warp per 8 tokens, a lane per 2 columns
    const int c0 = v0 + lane, c1 = v0 + lane + 32;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      float x0 = s_s[r][lane], x1 = s_s[r][lane + 32];
      if (softcap > 0.f) {
        x0 = softcap * tanhf(x0 / softcap);
        x1 = softcap * tanhf(x1 / softcap);
      }
      x0 = c0 < V ? x0 : kNegInf;
      x1 = c1 < V ? x1 : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(x0, x1)));
      const float e = expf(x0 - m_new) + expf(x1 - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(e);
      m[i] = m_new;
      tru[i] += warp_sum((c0 == lab[i] ? x0 : 0.f) + (c1 == lab[i] ? x1 : 0.f));
      if (eps > 0.f)
        sum[i] += warp_sum((c0 < V ? x0 : 0.f) + (c1 < V ? x1 : 0.f));
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int t = t0 + warp * kRowsPerWarp + i;
      if (t >= T_) continue;
      const float ls = m[i] + logf(fmaxf(l[i], 1e-30f));
      float n = ls - tru[i];
      if (eps > 0.f) n = (1.f - eps) * n + eps * (ls - sum[i] / (float)V);
      nll[t] = n;
      lse_out[t] = ls;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
ce_dlogits_kernel(const float* __restrict__ logits,
                  const float* __restrict__ lse,
                  const int* __restrict__ labels,
                  const float* __restrict__ weights,
                  const float* __restrict__ dloss, T* __restrict__ out,
                  int V, float eps) {
  const int r = blockIdx.x;
  const float ls = lse[r];
  const int lab = labels[r];
  const float scale = weights[r] * dloss[0];
  const float inv_v = 1.0f / (float)V;
  const float* row = logits + (size_t)r * V;
  T* dst = out + (size_t)r * V;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    const float p = expf(row[c] - ls);
    float g = (1.f - eps) * (p - (c == lab ? 1.f : 0.f));
    if (eps > 0.f) g = g + eps * (p - inv_v);
    dst[c] = from_f<T>(g * scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of h and W). Returns
// cudaGetLastError() after the launch (0 = cudaSuccess); shapes are
// checked by the caller.
extern "C" int ce_fwd(const void* h, const void* w, const void* labels,
                      void* nll, void* lse, int T, int D, int V, int w_rows,
                      float eps, float softcap, int dtype, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((T + kBT - 1) / kBT);
  if (dtype == 0) {
    ce_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)h, (const float*)w, (const int*)labels, (float*)nll,
        (float*)lse, T, D, V, w_rows, eps, softcap);
  } else if (dtype == 1) {
    ce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const int*)labels,
        (float*)nll, (float*)lse, T, D, V, w_rows, eps, softcap);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// logits (R, V) fp32, lse/weights (R,) fp32, labels (R,) int32, dloss a
// device fp32 scalar; out (R, V) in dtype (0 = float32, 1 = bfloat16).
extern "C" int ce_dlogits(const void* logits, const void* lse,
                          const void* labels, const void* weights,
                          const void* dloss, void* out, int R, int V,
                          float eps, int dtype, void* stream) {
  if (R <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    ce_dlogits_kernel<float><<<R, 256, 0, s>>>(
        (const float*)logits, (const float*)lse, (const int*)labels,
        (const float*)weights, (const float*)dloss, (float*)out, V, eps);
  } else if (dtype == 1) {
    ce_dlogits_kernel<__nv_bfloat16><<<R, 256, 0, s>>>(
        (const float*)logits, (const float*)lse, (const int*)labels,
        (const float*)weights, (const float*)dloss, (__nv_bfloat16*)out, V,
        eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
