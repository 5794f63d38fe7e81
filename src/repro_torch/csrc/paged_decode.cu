// Single-query GQA decode over a paged KV pool, written for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   flash_decode_paged_pallas (_paged_decode_kernel, pallas_call at :267).
//
// Computes, for each sequence b and q head h (kv head g = h / (H/Hkv)):
//   out[b, 0, h] = softmax_j(q[b, 0, h] . K[b, j, g] * scale) V[b, j, g]
//   over positions j < min(kv_lens[b], MB*bs), where position j lives in
//   pool block tables[b, j / bs] at row j % bs. A table entry outside
//   [0, N) (the NULL sentinel is N) is a block of zeros: its positions
//   below kv_lens[b] score exactly 0 and add nothing to the output, as
//   the reference's mode="fill" gather does. Such an entry is never
//   dereferenced. An inactive slot (all NULL, kv_lens = 1) gives exactly 0.
//   q (B, 1, H, D), pools (N, bs, Hkv, D), out (B, 1, H, D), one dtype
//   (fp32 or bf16); tables (B, MB) int32, kv_lens (B,) int32. fp32 softmax.
//
// What bounds it on the H100: memory. Each cached K and V element is
//   used by H/Hkv = 8 query heads for 2 flops each, ~4 flops per bf16
//   byte against the card's ~295 balance point, so the least time is
//   sum_b kv_lens[b] * Hkv * D * 2 bytes * 2 (K and V) over 3.35 TB/s.
//
// What this design does about it:
//   * One block per (sequence, kv head) serves all H/Hkv query heads of
//     the group (one warp each), so each K/V row is read from device
//     memory once, not once per query head.
//   * The block reads its own block-table row: what scalar prefetch did
//     on the TPU, here a load per 32-position tile.
//   * It walks only the positions below kv_lens[b]. The Pallas kernel
//     stepped over all MB table entries and buffered the whole window in
//     VMEM, then attended at the last step; a block's 227 KB of shared
//     memory cannot hold a long window, so this kernel streams it in
//     32-position tiles with an online softmax (m, l, acc in registers)
//     and its shared memory does not grow with the context.
//   * Not yet done, and why it is slow at small batch: B*Hkv blocks
//     (32 at B=8) leave most of the 132 SMs idle; splitting the window
//     across blocks (split-K with a combine pass) is a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kD = 64;           // head dim this kernel is built for
constexpr int kTile = 32;        // positions per tile (one per lane)
constexpr int kMaxGroup = 16;    // most query heads per kv head (warps)
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
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pool,
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ kv_lens,
                                    T* __restrict__ o, int H, int Hkv,
                                    int N, int bs, int MB, float scale) {
  __shared__ float q_s[kMaxGroup][kD];
  __shared__ float k_s[kTile][kD + 1];
  __shared__ float v_s[kTile][kD];

  const int g = blockIdx.x, b = blockIdx.y;
  const int group = H / Hkv;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = g * group + warp;

  for (int i = tid; i < group * kD; i += nthreads) {
    const int w = i / kD, d = i % kD;
    q_s[w][d] = to_f(q[((size_t)b * H + g * group + w) * kD + d]) * scale;
  }

  const int len = min(kv_lens[b], MB * bs);
  const int* table = tables + (size_t)b * MB;
  float m = kNegInf, l = 0.f, acc0 = 0.f, acc1 = 0.f;

  for (int t0 = 0; t0 < len; t0 += kTile) {
    __syncthreads();                      // previous tile fully consumed
    for (int i = tid; i < kTile * kD; i += nthreads) {
      const int r = i / kD, d = i % kD, pos = t0 + r;
      float kx = 0.f, vx = 0.f;
      if (pos < len) {
        const int blk = table[pos / bs];
        if (blk >= 0 && blk < N) {        // NULL / out of pool: zeros
          const size_t off =
              (((size_t)blk * bs + pos % bs) * Hkv + g) * kD + d;
          kx = to_f(k_pool[off]);
          vx = to_f(v_pool[off]);
        }
      }
      k_s[r][d] = kx;
      v_s[r][d] = vx;
    }
    __syncthreads();

    const bool live = t0 + lane < len;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) s = fmaf(q_s[warp][d], k_s[lane][d], s);
    s = live ? s : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float p = live ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    acc0 *= corr;
    acc1 *= corr;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      acc0 = fmaf(pj, v_s[j][lane], acc0);
      acc1 = fmaf(pj, v_s[j][lane + 32], acc1);
    }
    m = m_new;
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* dst = o + ((size_t)b * H + h) * kD;
  dst[lane] = from_f<T>(acc0 * inv);
  dst[lane + 32] = from_f<T>(acc1 * inv);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); a configuration the kernel does not take
// returns cudaErrorInvalidValue without launching.
extern "C" int paged_decode_fwd(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* kv_lens, void* o, int B, int H,
                                int Hkv, int D, int N, int bs, int MB,
                                float scale, int dtype, void* stream) {
  if (D != kD || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup ||
      B <= 0 || bs <= 0 || MB <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  dim3 block(32 * (H / Hkv));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, block, 0, s>>>(
        (const float*)q, (const float*)k_pool, (const float*)v_pool,
        (const int*)tables, (const int*)kv_lens, (float*)o, H, Hkv, N, bs,
        MB, scale);
  } else if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
        (const __nv_bfloat16*)v_pool, (const int*)tables,
        (const int*)kv_lens, (__nv_bfloat16*)o, H, Hkv, N, bs, MB, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
