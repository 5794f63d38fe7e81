// Fused LM-head cross-entropy: forward (ce_fwd) and the elementwise
// dlogits pass of its recompute backward (ce_dlogits), written for
// sm_90a.
//
// ce_fwd replaces: src/repro/kernels/cross_entropy/cross_entropy.py,
//   cross_entropy_pallas (_ce_kernel, pallas_call at :121).
//   For hidden h (T, D) and head W (D, V), both fp32 or both bf16 (then
//   D a multiple of 16), and labels (T,) int32, it computes per token,
//   all in fp32:
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
//   * ce_fwd: operations, 2*T*D*V (1.05 TFLOP at the train step's
//     T=5120, D=2048, V=50304) over the tensor cores' 989 TFLOP/s, ~1.07
//     ms; its bytes (h and W read once, 0.23 GB in bf16) take ~0.07 ms.
//   * ce_dlogits: bytes, T*V*(4 + 2) (fp32 in, bf16 out; 1.2 GB at
//     T=4096) over 3.35 TB/s, ~0.37 ms.
//
// What the designs do about it. ce_fwd keeps the TPU kernel's point: no
// (T, V) logits tile ever reaches device memory. On the TPU the vocab
// axis was a sequential grid axis with the hidden tile resident in VMEM
// and the running (max, sumexp, true logit, sum) in VMEM scratch. Blocks
// on the GPU run in no order, so each block loops over vocab tiles
// itself, and ce_fwd dispatches by dtype (no other switch):
//   * bf16, on the tensor cores: the vocab is split across blocks. The
//     grid is (token tiles of 128) x (splits, chosen by the wrapper so
//     the grid makes many waves of 132 SMs); a block walks its split's
//     slab in vocab tiles of 256 columns and accumulates each 128 x 256
//     tile over D by wgmma (two warpgroups of 64 tokens; h as A, K-major;
//     W as B: K-major rows of a tied (V, D) table, or a (D, V) matrix
//     read MN-major with the transpose bit), in stages of 128 of D that
//     a 2-stage ring of 16-byte cp.async copies fills (zero past T, V and
//     D; a (D, V) matrix whose rows are not 16-byte aligned, V % 8 != 0,
//     is copied by 2-byte loads). On the accumulator fragment: softcap,
//     the column mask, the label pick, and each thread's running (m, l,
//     true logit, sum of logits) over its own columns; the quad's four
//     are merged at the end, and the block writes its slab's partials to
//     a (T, splits, 4) scratch. A second kernel (ce_merge) merges each
//     token's partials in split order into lse and nll: no atomics, two
//     runs give equal bits. The tiling (kCeBV, kCeBK) is the fastest of
//     those timed at the train step's shape: one 193 KB block an SM, few
//     large stages between barriers.
//   * fp32, the first CUDA-core version, unchanged (wgmma has no fp32
//     operands): one block owns 32 tokens and loops over 64-column vocab
//     tiles; each tile's product is summed over D in 32-wide steps with
//     both sub-tiles staged in shared memory, each thread holding a 4x4
//     block of the tile in registers. The tile then goes through shared
//     memory to the reduction, one warp per 8 tokens, whose running (m,
//     l, true logit, sum) stay in registers across the vocab loop.
//   * ce_dlogits streams the tile once: each element is read once and
//     written once, consecutive threads on consecutive columns, one
//     block per row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int kBT = 32;          // tokens per block
constexpr int kBV = 64;          // vocab columns per tile
constexpr int kBK = 32;          // D step of the staged sub-tiles
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kBT / kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
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


// ---------------------------------------------------------------------
// ce_fwd in bf16: tensor cores (wgmma) over a cp.async ring, the vocab
// split across blocks, then a merge in split order
// ---------------------------------------------------------------------

constexpr int kCeBT = 128;           // tokens a block (two warpgroups)
constexpr int kCeThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// 256 vocab columns a tile by 128 of D a stage, a 2-stage ring (193 KB:
// one block an SM): the fastest of the tilings timed at the train step's
// shape (PERF.md); fewer, larger stages between barriers beat
// more blocks an SM and deeper rings
constexpr int kCeBV = 256;           // vocab columns a tile
constexpr int kCeBK = 128;           // D a stage (a multiple of 64)
constexpr int kCeHBytes = kCeBT * kCeBK * 2;
constexpr int kCeStageBytes = kCeHBytes + kCeBV * kCeBK * 2;
constexpr int kCeSmem = 2 * kCeStageBytes + 1024;

// one stage: h rows t0.. (128 x 64 at d0, K-major) and the W tile of
// vocab columns v0.. (K-major rows of a (V, D) table, or 64 rows of a
// (D, V) matrix read MN-major); what lies past T, V or D reads as zero
__device__ __forceinline__ void ce_load_stage(
    uint32_t st, const __nv_bfloat16* __restrict__ h,
    const __nv_bfloat16* __restrict__ w, int t0, int v0, int d0, int T_,
    int D, int V, int w_rows, int tid) {
  constexpr int kBV = kCeBV, kBK = kCeBK;
  const int dc = (D - d0 + 7) / 8;                 // chunks of D left
  sm90::load_rows<kCeBT, kBK / 8, kCeThreads>(st, h + (size_t)t0 * D + d0,
                                              D, T_ - t0, dc, tid);
  const uint32_t ws = st + kCeHBytes;
  if (w_rows) {
    sm90::load_rows<kBV, kBK / 8, kCeThreads>(ws, w + (size_t)v0 * D + d0,
                                              D, V - v0, dc, tid);
  } else if (V % 8 == 0) {
    sm90::load_rows<kBK, kBV / 8, kCeThreads>(
        ws, w + (size_t)d0 * V + v0, V, D - d0, (V - v0 + 7) / 8, tid);
  } else {
    // a (D, V) row of V % 8 != 0 columns is not 16-byte aligned: the
    // same tile by 2-byte loads (generic-proxy stores, fenced as cp.async)
    for (int i = tid; i < kBK * kBV; i += kCeThreads) {
      const int r = i / kBV, n = i % kBV, d = d0 + r, col = v0 + n;
      const unsigned short x =
          (d < D && col < V)
              ? reinterpret_cast<const unsigned short*>(w)[(size_t)d * V +
                                                           col]
              : (unsigned short)0;
      const uint32_t a = ws + sm90::tile_off(kBK, r, n / 8) + (n % 8) * 2;
      asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(a), "h"(x));
    }
  }
}

// Block (token tile, split): the logits of its 128 tokens over the
// split's slab of vocab tiles, reduced to this slab's (max, sumexp, true
// logit, sum of logits) per token in part (T, splits, 4).
template <int kMN>
__global__ void __launch_bounds__(kCeThreads)
ce_fwd_sm90(const __nv_bfloat16* __restrict__ h,
            const __nv_bfloat16* __restrict__ w,
            const int* __restrict__ labels, float4* __restrict__ part,
            int T_, int D, int V, int splits, float softcap) {
  constexpr int kBV = kCeBV, kBK = kCeBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int t0 = blockIdx.x * kCeBT, sp = blockIdx.y;
  const int n_vt = (V + kBV - 1) / kBV;
  const int vt0 = (int)((long long)sp * n_vt / splits);
  const int vt1 = (int)((long long)(sp + 1) * n_vt / splits);
  const int kt_n = (D + kBK - 1) / kBK;
  const int n_it = (vt1 - vt0) * kt_n;

  if (n_it > 0)                                  // the ring's first stage
    ce_load_stage(base, h, w, t0, vt0 * kBV, 0, T_, D, V, !kMN, tid);
  sm90::cp_async_commit();

  const int row0 = t0 + wg * 64 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int lab0 = row0 < T_ ? labels[row0] : -1;
  const int lab1 = row1 < T_ ? labels[row1] : -1;
  // running state of this thread's columns of its two rows
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float tr0 = 0.f, tr1 = 0.f, sm0 = 0.f, sm1 = 0.f;
  float acc[kBV / 2];
#pragma unroll
  for (int i = 0; i < kBV / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int kt = it % kt_n;
    sm90::cp_async_wait<0>();                  // stage `it` landed
    sm90::fence_proxy_async();
    __syncthreads();                           // ... everywhere; and the
                                               // other stage is free
    const int nxt = it + 1;
    if (nxt < n_it)
      ce_load_stage(base + (nxt & 1) * kCeStageBytes, h, w, t0,
                    (vt0 + nxt / kt_n) * kBV, (nxt % kt_n) * kBK, T_, D, V,
                    !kMN, tid);
    sm90::cp_async_commit();

    const uint32_t hs = base + (it & 1) * kCeStageBytes;
    const uint32_t ws = hs + kCeHBytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      // k16 step s: 64-column block s / 4 of the K-major tiles, 32 bytes
      // a step inside it; 16 rows of K a step of the MN-major W tile
      const uint32_t kb = (s / 4) * 128, ko = (s % 4) * 32;
      const uint64_t da = sm90::desc_sw128(
          hs + kb * kCeBT + wg * 64 * 128 + ko, 16, 1024);
      const uint64_t db =
          kMN ? sm90::desc_sw128(ws + s * 16 * 128, kBK * 128, 1024)
              : sm90::desc_sw128(ws + kb * kBV + ko, 16, 1024);
      sm90::wgmma_ss<kBV, kMN>(acc, da, db, kt > 0 || s > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    if (kt != kt_n - 1) continue;
    sm90::fence_regs(acc);

    // the vocab tile's logits are in acc: softcap, mask, online update
    const int v0 = (vt0 + it / kt_n) * kBV;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + 8 * j + 2 * (lane % 4) + e;
        float x0 = acc[4 * j + e], x1 = acc[4 * j + 2 + e];
        if (softcap > 0.f) {
          x0 = softcap * tanhf(x0 / softcap);
          x1 = softcap * tanhf(x1 / softcap);
        }
        if (col < V) {
          tr0 += col == lab0 ? x0 : 0.f;
          tr1 += col == lab1 ? x1 : 0.f;
          sm0 += x0;
          sm1 += x1;
        } else {
          x0 = -INFINITY;
          x1 = -INFINITY;
        }
        acc[4 * j + e] = x0;
        acc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float e0 = 0.f, e1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        e0 += exp2f((acc[4 * j + e] - mn0) * kLog2e);
        e1 += exp2f((acc[4 * j + 2 + e] - mn1) * kLog2e);
      }
    }
    l0 = l0 * exp2f((m0 - mn0) * kLog2e) + e0;
    l1 = l1 * exp2f((m1 - mn1) * kLog2e) + e1;
    m0 = mn0;
    m1 = mn1;
  }

  // merge the quad's columns (the same result on all four lanes)
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float om0 = __shfl_xor_sync(0xffffffffu, m0, o);
    const float om1 = __shfl_xor_sync(0xffffffffu, m1, o);
    const float ol0 = __shfl_xor_sync(0xffffffffu, l0, o);
    const float ol1 = __shfl_xor_sync(0xffffffffu, l1, o);
    const float mm0 = fmaxf(m0, om0), mm1 = fmaxf(m1, om1);
    l0 = l0 * exp2f((m0 - mm0) * kLog2e) + ol0 * exp2f((om0 - mm0) * kLog2e);
    l1 = l1 * exp2f((m1 - mm1) * kLog2e) + ol1 * exp2f((om1 - mm1) * kLog2e);
    m0 = mm0;
    m1 = mm1;
    tr0 += __shfl_xor_sync(0xffffffffu, tr0, o);
    tr1 += __shfl_xor_sync(0xffffffffu, tr1, o);
    sm0 += __shfl_xor_sync(0xffffffffu, sm0, o);
    sm1 += __shfl_xor_sync(0xffffffffu, sm1, o);
  }
  if (lane % 4 == 0) {
    if (row0 < T_)
      part[(size_t)row0 * splits + sp] = make_float4(m0, l0, tr0, sm0);
    if (row1 < T_)
      part[(size_t)row1 * splits + sp] = make_float4(m1, l1, tr1, sm1);
  }
}

// per token: the splits' partials merged in split order, then lse and nll
__global__ void __launch_bounds__(256)
ce_merge(const float4* __restrict__ part, float* __restrict__ nll,
         float* __restrict__ lse_out, int T_, int splits, int V, float eps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T_) return;
  const float4* p = part + (size_t)t * splits;
  float m = kNegInf;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, p[s].x);
  float l = 0.f, tru = 0.f, sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float4 x = p[s];
    l += x.y * expf(x.x - m);
    tru += x.z;
    sum += x.w;
  }
  const float ls = m + logf(fmaxf(l, 1e-30f));
  float n = ls - tru;
  if (eps > 0.f) n = (1.f - eps) * n + eps * (ls - sum / (float)V);
  nll[t] = n;
  lse_out[t] = ls;
}

template <int kMN>
int launch_ce_sm90(const void* h, const void* w, const void* labels,
                   void* nll, void* lse, void* part, int T_, int D, int V,
                   int splits, float eps, float softcap, cudaStream_t s) {
  static bool smem_set[64] = {};               // one set per kernel
  cudaError_t err = sm90::allow_smem(ce_fwd_sm90<kMN>, kCeSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_ + kCeBT - 1) / kCeBT, splits);
  ce_fwd_sm90<kMN><<<grid, kCeThreads, kCeSmem, s>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const int*)labels,
      (float4*)part, T_, D, V, splits, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_merge<<<(T_ + 255) / 256, 256, 0, s>>>((const float4*)part,
                                            (float*)nll, (float*)lse, T_,
                                            splits, V, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of h and W). part: bf16 only, a
// (T, splits, 4) fp32 scratch; splits in [1, ceil(V / 256)] (ignored in
// fp32). Returns cudaGetLastError() after the launches (0 =
// cudaSuccess); shapes are checked by the caller (bf16: D a multiple of
// 16, h and W 16-byte aligned).
extern "C" int ce_fwd(const void* h, const void* w, const void* labels,
                      void* nll, void* lse, void* part, int T, int D, int V,
                      int w_rows, int splits, float eps, float softcap,
                      int dtype, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    dim3 grid((T + kBT - 1) / kBT);
    ce_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)h, (const float*)w, (const int*)labels, (float*)nll,
        (float*)lse, T, D, V, w_rows, eps, softcap);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || D % 16 != 0 || splits < 1 ||
      splits > (V + kCeBV - 1) / kCeBV || part == nullptr)
    return (int)cudaErrorInvalidValue;
  return w_rows ? launch_ce_sm90<0>(h, w, labels, nll, lse, part, T, D, V,
                                    splits, eps, softcap, s)
                : launch_ce_sm90<1>(h, w, labels, nll, lse, part, T, D, V,
                                    splits, eps, softcap, s);
}

// Dynamic shared memory a bf16 launch of ce_fwd's product kernel asks
// for (bytes).
extern "C" int ce_fwd_sm90_smem() { return kCeSmem; }

// The bf16 product kernel's tile, axis 0: tokens a block, axis 1: vocab
// columns a tile; what cross_entropy_split_plain and ce_splits model
// (TOKEN_TILE, VOCAB_TILE in kernels/cross_entropy/cross_entropy.py).
extern "C" int ce_fwd_sm90_tile(int axis) {
  return axis == 0 ? kCeBT : axis == 1 ? kCeBV : -1;
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
