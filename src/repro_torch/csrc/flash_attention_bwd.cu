// Causal GQA flash-attention backward (recompute), written for sm_90a.
//
// Held against: src/repro/kernels/flash_attention/ref.py::_flash_bwd
//   (:115-171), the custom_vjp backward of the JAX package's chunked
//   attention; the Pallas forward (flash_attention_pallas) has no
//   backward of its own. Plain version: repro_torch ref.flash_bwd_ref.
//
// Computes, from the forward's q, k, v, out and lse (B, Sq, H) fp32:
//   Dv   = rowsum(dout * out)                       (B, Sq, H) fp32
//   p    = exp(q k^T * scale - lse), masked (causal on qpos = row +
//          q_offset, kpos < Skv)
//   dv   = p^T dout, dp = dout v^T, ds = p * (dp - Dv) * scale
//   dq   = ds k, dk = ds^T q
//   GQA: q head h reads kv head h / (H / Hkv), and dk/dv of a kv head
//   sum over its H / Hkv query heads. dq, dk, dv come out in q's dtype
//   (fp32 or bf16) with fp32 accumulation; like the reference, p is
//   rounded to that dtype before the dv product and ds before the dq
//   and dk products. D in {64, 128}; all tensors contiguous.
//
// What bounds it on the H100: about 2.5x the forward's causal flops
//   (five products of the forward's size, one of them recomputing the
//   scores, counted once more in the dq pass), so at olmo-1b widths
//   (H = Hkv = 16, D = 128, S = 1024) the tensor cores' 989 TFLOP/s
//   bound it; bytes (q, k, v, out, dout, lse read once, dq, dk, dv
//   written once) are far below.
//
// What this design does about it: like the forward it is the simple,
//   right version on the CUDA cores in fp32 (no wgmma, no TMA), far from
//   that bound. Its design is set by one promise instead: HetSeq's
//   results are identical from run to run, so there are no float
//   atomics. Two launches, each output owned by exactly one block:
//   * dq pass: one block per (b, h, q tile) loops over the
//     causally visible kv tiles (as the forward does) and sums dq in
//     registers. It also computes Dv for its rows first and writes it
//     out for the second pass.
//   * dk/dv pass: one block per (b, kv head, 32-key tile) loops over the
//     H / Hkv query heads of the group and over the q tiles that see its
//     keys, and sums dk and dv for the kv head itself. This folds GQA
//     with no repeated K/V and no atomics: the sum over the group's
//     heads runs in a fixed order inside one block.
//   Both passes rebuild p from the saved lse, so no (Sq, Skv) tile ever
//   reaches device memory. K and V tiles are padded to D+1 floats in
//   shared memory where 32 lanes read 32 different keys.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBKV = 32;         // kv positions per tile (one per lane)
constexpr int kBQ2 = 32;         // dk/dv pass: q rows per staged tile
constexpr int kRows2 = kBQ2 / kWarps;

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
// the reference's .astype(q.dtype) on an fp32 value
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dq pass: q rows per block. 32 at D=128 halves the accumulators a
// lane holds (168 registers at 64 rows, 72 at 32); ptxas still reports
// a 32-byte local stack at D=128 with either tile, so that spill is
// not register pressure.
template <int D>
__host__ __device__ constexpr int dq_tile() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * dq_tile<D>() * D + 2 * kBKV * (D + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kBKV * (D + 1) + 2 * kBQ2 * D +
                          2 * kBQ2 * (kBKV + 1) + 2 * kBQ2);
}

// ---------------------------------------------------------------------
// dq pass (and Dv)
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dvec,
                    T* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
                    int causal, int q_offset, float scale) {
  constexpr int kC = D / 32;
  constexpr int kBQ = dq_tile<D>();
  constexpr int kRowsPerWarp = kBQ / kWarps;
  extern __shared__ float smem[];
  float (*q_s)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*do_s)[D] = reinterpret_cast<float (*)[D]>(smem + kBQ * D);
  float (*k_s)[D + 1] =
      reinterpret_cast<float (*)[D + 1]>(smem + 2 * kBQ * D);
  float (*v_s)[D + 1] = reinterpret_cast<float (*)[D + 1]>(
      smem + 2 * kBQ * D + kBKV * (D + 1));

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kBQ;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, row = q0 + r;
    float x = 0.f, g = 0.f;
    if (row < Sq) {
      const size_t off = ((size_t)(b * Sq + row) * H + h) * D + d;
      x = to_f(q[off]);
      g = to_f(dout[off]);
    }
    q_s[r][d] = x;
    do_s[r][d] = g;
  }

  // Dv = rowsum(dout * out) for this warp's rows, fp32
  float lse_r[kRowsPerWarp], dv_r[kRowsPerWarp], acc[kRowsPerWarp][kC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp * kRowsPerWarp + i;
    float part = 0.f, ls = 0.f;
    if (row < Sq) {
      const size_t base = ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = lane + 32 * c;
        part += to_f(dout[base + d]) * to_f(out[base + d]);
      }
      ls = lse[(size_t)(b * Sq + row) * H + h];
    }
    dv_r[i] = warp_sum(part);
    lse_r[i] = ls;
    if (row < Sq && lane == 0) dvec[(size_t)(b * Sq + row) * H + h] = dv_r[i];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  int kv_end = Skv;
  if (causal) {
    const int last_q = min(q0 + kBQ, Sq) - 1 + q_offset;
    kv_end = min(Skv, last_q + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBKV - 1) / kBKV : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();                      // q/do staged; old tile consumed
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int r = i / D, d = i % D, pos = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (pos < Skv) {
        const size_t off = ((size_t)(b * Skv + pos) * Hkv + hk) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      k_s[r][d] = kx;
      v_s[r][d] = vx;
    }
    __syncthreads();

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int row = q0 + r;
      if (row >= Sq) continue;            // uniform across the warp
      const int qpos = row + q_offset;
      const bool live = kpos < Skv && (!causal || qpos >= kpos);
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[r][d], k_s[lane][d], s);
        dp = fmaf(do_s[r][d], v_s[lane][d], dp);
      }
      const float p = live ? expf(s * scale - lse_r[i]) : 0.f;
      const float ds = round_to<T>(p * (dp - dv_r[i]) * scale);
#pragma unroll
      for (int j = 0; j < kBKV; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < kC; ++c)
          acc[i][c] = fmaf(dsj, k_s[j][lane + 32 * c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp * kRowsPerWarp + i;
    if (row >= Sq) continue;
    T* dst = dq + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) dst[lane + 32 * c] = from_f<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------
// dk/dv pass
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                     int causal, int q_offset, float scale) {
  constexpr int kC = D / kWarps;           // dims per thread: warp + 4c
  extern __shared__ float smem[];
  float* p_ = smem;
  float (*k_s)[D + 1] = reinterpret_cast<float (*)[D + 1]>(p_);
  p_ += kBKV * (D + 1);
  float (*v_s)[D + 1] = reinterpret_cast<float (*)[D + 1]>(p_);
  p_ += kBKV * (D + 1);
  float (*q_s)[D] = reinterpret_cast<float (*)[D]>(p_);
  p_ += kBQ2 * D;
  float (*do_s)[D] = reinterpret_cast<float (*)[D]>(p_);
  p_ += kBQ2 * D;
  float (*P_s)[kBKV + 1] = reinterpret_cast<float (*)[kBKV + 1]>(p_);
  p_ += kBQ2 * (kBKV + 1);
  float (*dS_s)[kBKV + 1] = reinterpret_cast<float (*)[kBKV + 1]>(p_);
  p_ += kBQ2 * (kBKV + 1);
  float* lse_s = p_;
  float* dv_s = p_ + kBQ2;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = kt * kBKV;
  const int kpos = k0 + lane;

  for (int i = tid; i < kBKV * D; i += kThreads) {
    const int r = i / D, d = i % D, pos = k0 + r;
    float kx = 0.f, vx = 0.f;
    if (pos < Skv) {
      const size_t off = ((size_t)(b * Skv + pos) * Hkv + hk) * D + d;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    k_s[r][d] = kx;
    v_s[r][d] = vx;
  }

  float dk_acc[kC], dv_acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) { dk_acc[c] = 0.f; dv_acc[c] = 0.f; }

  // q rows that see any key of this tile: qpos >= k0
  int row_lo = 0;
  if (causal) row_lo = max(0, k0 - q_offset);
  const int t_lo = row_lo / kBQ2;
  const int n_qt = (Sq + kBQ2 - 1) / kBQ2;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = t_lo; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ2;
      __syncthreads();                    // previous q tile consumed
      for (int i = tid; i < kBQ2 * D; i += kThreads) {
        const int r = i / D, d = i % D, row = q0 + r;
        float x = 0.f, gg = 0.f;
        if (row < Sq) {
          const size_t off = ((size_t)(b * Sq + row) * H + h) * D + d;
          x = to_f(q[off]);
          gg = to_f(dout[off]);
        }
        q_s[r][d] = x;
        do_s[r][d] = gg;
      }
      for (int r = tid; r < kBQ2; r += kThreads) {
        const int row = q0 + r;
        const size_t o = (size_t)(b * Sq + row) * H + h;
        lse_s[r] = row < Sq ? lse[o] : 0.f;
        dv_s[r] = row < Sq ? dvec[o] : 0.f;
      }
      __syncthreads();

      // p and ds for (row, key = lane), this warp's rows of the tile
#pragma unroll
      for (int i = 0; i < kRows2; ++i) {
        const int r = warp * kRows2 + i;
        const int row = q0 + r;
        const int qpos = row + q_offset;
        const bool live =
            row < Sq && kpos < Skv && (!causal || qpos >= kpos);
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(q_s[r][d], k_s[lane][d], s);
          dp = fmaf(do_s[r][d], v_s[lane][d], dp);
        }
        const float p = live ? expf(s * scale - lse_s[r]) : 0.f;
        P_s[r][lane] = round_to<T>(p);
        dS_s[r][lane] = round_to<T>(p * (dp - dv_s[r]) * scale);
      }
      __syncthreads();

      // dv[key][d] += sum_r p[r][key] dout[r][d]; dk likewise with ds, q
#pragma unroll 4
      for (int r = 0; r < kBQ2; ++r) {
        const float pr = P_s[r][lane], dsr = dS_s[r][lane];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int d = warp + kWarps * c;
          dv_acc[c] = fmaf(pr, do_s[r][d], dv_acc[c]);
          dk_acc[c] = fmaf(dsr, q_s[r][d], dk_acc[c]);
        }
      }
    }
  }

  if (kpos < Skv) {
    const size_t base = ((size_t)(b * Skv + kpos) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = warp + kWarps * c;
      dk[base + d] = from_f<T>(dk_acc[c]);
      dv[base + d] = from_f<T>(dv_acc[c]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int Hkv,
           int causal, int q_offset, float scale, cudaStream_t s) {
  const size_t s1 = dq_smem_bytes<D>(), s2 = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((Sq + dq_tile<D>() - 1) / dq_tile<D>(), H, B);
  flash_bwd_dq_kernel<T, D><<<g1, kThreads, s1, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout,
      lse, dvec, (T*)dq, Sq, Skv, H, Hkv, causal, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Skv <= 0) return 0;
  dim3 g2((Skv + kBKV - 1) / kBKV, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<g2, kThreads, s2, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dvec,
      (T*)dk, (T*)dv, Sq, Skv, H, Hkv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dvec is fp32 scratch (B, Sq, H)
// that the first launch fills and the second reads. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess); shapes are
// checked by the caller, other configurations return
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* dvec, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int H, int Hkv,
                                   int D, int causal, int q_offset,
                                   float scale, int dtype, void* stream) {
  if ((D != 64 && D != 128) || Hkv <= 0 || H % Hkv != 0 || B <= 0 ||
      Sq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dvc = (float*)dvec;
#define REPRO_BWD(T, DD)                                                   \
  return launch<T, DD>(q, k, v, out, dout, l, dvc, dq, dk, dv, B, Sq, Skv, \
                       H, Hkv, causal, q_offset, scale, s)
  if (dtype == 0) {
    if (D == 64) REPRO_BWD(float, 64);
    REPRO_BWD(float, 128);
  }
  if (dtype == 1) {
    if (D == 64) REPRO_BWD(__nv_bfloat16, 64);
    REPRO_BWD(__nv_bfloat16, 128);
  }
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}
