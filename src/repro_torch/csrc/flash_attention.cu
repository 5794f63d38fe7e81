// Causal GQA flash-attention forward for prefill and training, written
// for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   flash_attention_pallas (_fa_kernel, pallas_call at :125).
//
// Computes out = softmax(q k^T * scale + mask) v with
//   q (B, Sq, H, D), k/v (B, Skv, Hkv, D), out (B, Sq, H, D), all in
//   the same dtype (fp32 or bf16), contiguous, D in {64, 128}; q head h
//   reads kv head h / (H / Hkv); mask = (kpos < Skv) && (!causal ||
//   qpos >= kpos), qpos = row + q_offset. Softmax state (running max m,
//   running sum l, accumulator acc) is fp32. When lse is not null it
//   also writes lse (B, Sq, H) fp32 = m + log(max(l, 1e-30)), what the
//   recompute backward (flash_attention_bwd.cu) rebuilds p from, as
//   src/repro/kernels/flash_attention/ref.py:241-243 does.
//
// What bounds it on the H100: the work is 4*B*H*Sq*Skv*D flops, halved
//   by causality, on q, k, v read once and the output written once. At
//   tinyllama widths (H=32, Hkv=4, D=64) that is ~S/2.3 flops per bf16
//   byte: under the card's ~295 balance point up to S of about 660, so
//   the serving buckets (16..512) are bound by bytes at 3.35 TB/s, and
//   longer prompts by the tensor cores' 989 TFLOP/s. At olmo-1b widths
//   (H=Hkv=16, D=128) training at S=1024 is bound by the tensor cores.
//   Both bounds are two orders of magnitude below what this version
//   takes.
//
// What this design does about it: this first version is the simple,
//   right one and does NOT reach that bound: it computes on the CUDA
//   cores in fp32 (no wgmma, no TMA). What it keeps from the TPU kernel
//   is what matters for memory: no (Sq, Skv) score matrix and no
//   repeated-KV tensor ever reaches device memory.
//   * On the TPU the kv axis was a sequential grid axis carrying the
//     running softmax in VMEM scratch. Blocks on the GPU run in no
//     order, so here one block owns one (b, h, q tile) and loops over
//     kv tiles itself; m, l and acc live in registers.
//   * Each kv tile (32 positions) is staged once in shared memory and
//     reused by all q rows of the block. One warp owns a quarter of the
//     q tile's rows; a
//     lane owns one key of the tile for the score and D/32 of the head
//     dims for the accumulator (probabilities move by shuffle).
//   * The K tile's row stride is padded to D+1 floats so the 32 lanes,
//     each reading a different key, hit 32 different banks.
//   * kv tiles past the causal limit of the q tile are not visited
//     (the TPU kernel's pl.when skip, here a shorter loop).
//   * The head dim is a template parameter, and so is the q tile: 64
//     rows at D=64 (16 rows a warp, as the serving path always had) and
//     32 rows at D=128. With 64 rows at D=128 a lane holds 16 rows x 4
//     accumulators plus m and l, and ptxas spilled 24 bytes a thread
//     (128 registers); with 32 rows it reports 80 registers and no
//     spills (ptxas -v, on the card's nvcc). The tiles take 48.5 KB at
//     D=128, above the 48 KB of static shared memory, so both widths
//     take them as dynamic shared memory (opted in once per width).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBKV = 32;         // kv positions per tile (one per lane)
constexpr int kWarps = 4;
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

// q rows per block
template <int D>
__host__ __device__ constexpr int q_tile() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (q_tile<D>() * D + kBKV * (D + 1) + kBKV * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int causal, int q_offset, float scale) {
  constexpr int kC = D / 32;     // accumulator columns per lane
  constexpr int kBQ = q_tile<D>();
  constexpr int kRowsPerWarp = kBQ / kWarps;
  extern __shared__ float smem[];
  float (*q_s)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*k_s)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem + kBQ * D);
  float (*v_s)[D] = reinterpret_cast<float (*)[D]>(
      smem + kBQ * D + kBKV * (D + 1));

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kBQ;

  // stage the (pre-scaled) q tile; rows past Sq are zero and discarded
  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, row = q0 + r;
    float x = 0.f;
    if (row < Sq) x = to_f(q[((size_t)(b * Sq + row) * H + h) * D + d]);
    q_s[r][d] = x * scale;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf; l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  // causal limit: the last q position of this tile sees kpos <= last_q
  int kv_end = Skv;
  if (causal) {
    const int last_q = min(q0 + kBQ, Sq) - 1 + q_offset;
    kv_end = min(Skv, last_q + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBKV - 1) / kBKV : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();                      // previous tile fully consumed
    for (int i = tid; i < kBKV * D; i += kWarps * 32) {
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
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q_s[r][d], k_s[lane][d], s);
      s = live ? s : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = live ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      float a[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) a[c] = acc[i][c] * corr;
#pragma unroll
      for (int j = 0; j < kBKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kC; ++c) a[c] = fmaf(pj, v_s[j][lane + 32 * c], a[c]);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] = a[c];
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp * kRowsPerWarp + i;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    T* dst = o + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) dst[lane + 32 * c] = from_f<T>(acc[i][c] * inv);
    if (lse != nullptr && lane == 0)
      lse[(size_t)(b * Sq + row) * H + h] = m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int Hkv, int causal, int q_offset,
           float scale, cudaStream_t s) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + q_tile<D>() - 1) / q_tile<D>(), H, B);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Skv, H, Hkv,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess); the caller
// checks shapes, so any other configuration returns
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Sq, int Skv, int H, int Hkv, int D,
                                   int causal, int q_offset, float scale,
                                   int dtype, void* stream) {
  if ((D != 64 && D != 128) || Hkv <= 0 || H % Hkv != 0 || B <= 0 ||
      Sq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 0) {
    return D == 64 ? launch<float, 64>(q, k, v, o, l, B, Sq, Skv, H, Hkv,
                                       causal, q_offset, scale, s)
                   : launch<float, 128>(q, k, v, o, l, B, Sq, Skv, H, Hkv,
                                        causal, q_offset, scale, s);
  }
  if (dtype == 1) {
    return D == 64
               ? launch<__nv_bfloat16, 64>(q, k, v, o, l, B, Sq, Skv, H, Hkv,
                                           causal, q_offset, scale, s)
               : launch<__nv_bfloat16, 128>(q, k, v, o, l, B, Sq, Skv, H,
                                            Hkv, causal, q_offset, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
