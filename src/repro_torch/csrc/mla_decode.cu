// Absorbed-MLA single-token decode attention, over a contiguous latent
// cache and over a paged latent pool, written for sm_90a.
//
// Replaces: src/repro/kernels/mla_decode/mla_decode.py,
//   mla_decode_pallas (_kernel, pallas_call at :94) and
//   mla_decode_paged_pallas (_paged_kernel, pallas_call at :217).
//
// Computes, for each sequence b and head h (all heads share the cache):
//   s[j] = (q_abs[b,h] . ckv[b,j] + q_r[b,h] . kr[b,j]) * scale,
//   masked to -1e30 at positions j >= kv_len[b],
//   out[b,h] = sum_j softmax(s)[j] * ckv[b,j]          (latent space)
// with q_abs (B, H, 512), q_r (B, H, 64), ckv rows of 512, kr rows of
// 64, all in one dtype (fp32 or bf16), out (B, H, 512) fp32. The
// contiguous kernel reads position j at ckv[b, j] (B, S, 512) and has
// positions j < S; the paged kernel reads it in pool block
// tables[b, j / bs] at row j % bs (pools (N, bs, 512) and (N, bs, 64),
// tables (B, MB) int32) and has positions j < MB*bs. A table entry
// outside [0, N) (the NULL sentinel is N) is a block of zeros and is
// never dereferenced. kv_len[b] >= 1 (the serving path passes cached +
// 1). As in the Pallas kernels: the softmax state (m, l, acc (H, 512))
// is fp32, scores are fp32 sums of the inputs' exact products, p is
// rounded to the cache dtype before the value product (mla_decode.py
// :67-71, :163-167), and out = acc / max(l, 1e-30).
//
// What bounds it on the H100: memory. Each cached position (576 values)
// is used by all H = 128 heads, 2 flops per value for the scores and 2
// per latent value for the output: ~250 flops per bf16 byte of cache at
// H = 128, under the card's ~295 balance point, so the least time is
// the bytes (cache rows below kv_len, q, out) over 3.35 TB/s.
//
// What this design does about it, and what it does not do yet:
//   * The TPU kernel's point, kept: each tile of latent positions
//     (16 positions x 576 values) is brought from device memory into
//     shared memory ONCE (as fp32) and used for both the score product
//     and the value product; no (B, H, S) score or probability tensor
//     reaches device memory.
//   * On the TPU the position axis was a sequential grid axis carrying
//     (m, l, acc) in VMEM scratch. Here one block owns one (sequence,
//     group of 16 heads) and loops over the tiles itself; m, l and acc
//     live in registers. A warp owns 4 heads; a lane owns 16 latent
//     columns of each head's accumulator (lane + 32 j).
//   * Scores: lane t and lane t + 16 own position t of the tile and half
//     of its 576 columns each (interleaved in groups of 16), for the
//     warp's 4 heads, from float4 loads of the tile and of the queries
//     (staged once in shared memory); one shuffle joins the halves.
//     The tile's row stride is 580 floats, so the float4 reads of 8
//     lanes on 8 rows fall on 32 different banks.
//   * The block reads its own block-table row, what scalar prefetch did
//     on the TPU, and walks only the tiles below kv_len: the Pallas
//     kernel steps over every table entry, but a tile with no live
//     position adds exactly 0 to l and acc and multiplies them by 1.
//   * Not yet done: H/16 x B blocks (64 at B = 8) leave half the SMs
//     idle and each reads the tile again (8 times at H = 128); the
//     products run on the CUDA cores; tile loads are not overlapped
//     with compute. Splitting the positions across blocks, one block
//     for all heads and tensor-core tiles are later changes.
//   * Registers (ptxas -v, the card's nvcc 12.8): 128 a thread for the
//     paged kernel and 148 for the contiguous one, in both dtypes, no
//     spills; 73,984 bytes of dynamic shared memory (16 x 580 tile, 16 x
//     576 queries, fp32), above the 48 KB static limit, opted in at each
//     launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kR = 512;            // latent rank
constexpr int kDR = 64;            // RoPE width
constexpr int kW = kR + kDR;       // values of one cached position
constexpr int kT = 16;             // positions per tile
constexpr int kWarps = 4;
constexpr int kHW = 4;             // heads per warp
constexpr int kHB = kWarps * kHW;  // heads per block
constexpr int kStride = kW + 4;    // padded tile row, keeps 16-byte rows
constexpr int kAcc = kR / 32;      // accumulator columns per lane
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes = sizeof(float) * (kT * kStride + kHB * kW);

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// p rounded to the cache dtype (the Pallas kernel's p.astype(ckv.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// max / sum over the 16 lanes of a half warp (each half holds one copy)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows: S (contiguous: ckv (B, S, 512)) or N (paged: pool blocks)
template <typename T, bool kPaged>
__global__ void __launch_bounds__(kWarps * 32)
mla_decode_kernel(const T* __restrict__ qa, const T* __restrict__ qr,
                  const T* __restrict__ ckv, const T* __restrict__ kr,
                  const int* __restrict__ tables,
                  const int* __restrict__ lens, float* __restrict__ out,
                  int H, int rows, int bs, int MB, float scale) {
  extern __shared__ __align__(16) float smem[];
  float (*tile)[kStride] = reinterpret_cast<float (*)[kStride]>(smem);
  float (*q_s)[kW] = reinterpret_cast<float (*)[kW]>(smem + kT * kStride);

  const int b = blockIdx.y, h0 = blockIdx.x * kHB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the block's queries [q_abs | q_r] in fp32; heads past H are zeros
  for (int i = tid; i < kHB * (kW / 4); i += kWarps * 32) {
    const int w = i / (kW / 4), c = (i % (kW / 4)) * 4, h = h0 + w;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h < H)
      x = c < kR ? load4(qa + ((size_t)b * H + h) * kR + c)
                 : load4(qr + ((size_t)b * H + h) * kDR + (c - kR));
    *reinterpret_cast<float4*>(&q_s[w][c]) = x;
  }

  const int len = min(lens[b], kPaged ? MB * bs : rows);
  const int t = lane & (kT - 1), half = lane >> 4;
  float m[kHW], l[kHW], acc[kHW][kAcc];
#pragma unroll
  for (int i = 0; i < kHW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] = 0.f;
  }

  for (int t0 = 0; t0 < len; t0 += kT) {
    __syncthreads();                  // previous tile consumed, q staged
    // warp w stages positions w, w + 4, ...; 4 values a lane per load
    for (int rr = warp; rr < kT; rr += kWarps) {
      const int pos = t0 + rr;
      const T* crow = nullptr;
      const T* krow = nullptr;
      if (pos < len) {
        size_t row = 0;
        bool mapped = true;
        if (kPaged) {
          const int blk = tables[(size_t)b * MB + pos / bs];
          mapped = blk >= 0 && blk < rows;      // NULL / out of pool
          if (mapped) row = (size_t)blk * bs + pos % bs;
        } else {
          row = (size_t)b * rows + pos;
        }
        if (mapped) {
          crow = ckv + row * kR;
          krow = kr + row * kDR;
        }
      }
      for (int c = lane * 4; c < kW; c += 128) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (crow != nullptr)
          x = c < kR ? load4(crow + c) : load4(krow + (c - kR));
        *reinterpret_cast<float4*>(&tile[rr][c]) = x;
      }
    }
    __syncthreads();

    // scores of position t for the warp's heads, this half's columns
    float s[kHW];
#pragma unroll
    for (int i = 0; i < kHW; ++i) s[i] = 0.f;
#pragma unroll 3
    for (int k = 0; k < kW / 32; ++k) {
      const int c0 = k * 32 + half * 16;
#pragma unroll
      for (int u = 0; u < 16; u += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&tile[t][c0 + u]);
#pragma unroll
        for (int i = 0; i < kHW; ++i) {
          const float4 q =
              *reinterpret_cast<const float4*>(&q_s[warp * kHW + i][c0 + u]);
          s[i] = fmaf(q.x, x.x, s[i]);
          s[i] = fmaf(q.y, x.y, s[i]);
          s[i] = fmaf(q.z, x.z, s[i]);
          s[i] = fmaf(q.w, x.w, s[i]);
        }
      }
    }

    // online softmax over the tile; p in the cache dtype for the values
    const bool live = t0 + t < len;
    float pc[kHW];
#pragma unroll
    for (int i = 0; i < kHW; ++i) {
      float si = s[i] + __shfl_xor_sync(0xffffffffu, s[i], 16);
      si = live ? si * scale : kNegInf;
      const float m_new = fmaxf(m[i], half_max(si));
      const float p = expf(si - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_sum(p);
      m[i] = m_new;
      pc[i] = round_to<T>(p);
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[i][j] *= corr;
    }

    // acc += p @ ckv tile, from the same shared-memory tile
#pragma unroll 4
    for (int tt = 0; tt < kT; ++tt) {
      float pt[kHW];
#pragma unroll
      for (int i = 0; i < kHW; ++i)
        pt[i] = __shfl_sync(0xffffffffu, pc[i], tt);
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const float v = tile[tt][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kHW; ++i) acc[i][j] = fmaf(pt[i], v, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kHW; ++i) {
    const int h = h0 + warp * kHW + i;
    if (h >= H) continue;             // uniform across the warp
    const float lc = fmaxf(l[i], 1e-30f);
    float* dst = out + ((size_t)b * H + h) * kR;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) dst[lane + 32 * j] = acc[i][j] / lc;
  }
}

template <typename T, bool kPaged>
int launch(const void* qa, const void* qr, const void* ckv, const void* kr,
           const void* tables, const void* lens, void* out, int B, int H,
           int rows, int bs, int MB, float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel<T, kPaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + kHB - 1) / kHB, B);
  mla_decode_kernel<T, kPaged><<<grid, kWarps * 32, kSmemBytes, s>>>(
      (const T*)qa, (const T*)qr, (const T*)ckv, (const T*)kr,
      (const int*)tables, (const int*)lens, (float*)out, H, rows, bs, MB,
      scale);
  return (int)cudaGetLastError();
}

template <bool kPaged>
int dispatch(const void* qa, const void* qr, const void* ckv, const void* kr,
             const void* tables, const void* lens, void* out, int B, int H,
             int rows, int bs, int MB, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, kPaged>(qa, qr, ckv, kr, tables, lens, out, B, H,
                                 rows, bs, MB, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kPaged>(qa, qr, ckv, kr, tables, lens, out,
                                         B, H, rows, bs, MB, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError()
// after the launch (0 = cudaSuccess); a configuration the kernels do
// not take returns cudaErrorInvalidValue without launching.
extern "C" int mla_decode_fwd(const void* q_abs, const void* q_r,
                              const void* ckv, const void* kr,
                              const void* kv_len, void* out, int B, int H,
                              int R, int DR, int S, float scale, int dtype,
                              void* stream) {
  if (R != kR || DR != kDR || B <= 0 || H <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(q_abs, q_r, ckv, kr, nullptr, kv_len, out, B, H, S,
                         0, 0, scale, dtype, stream);
}

extern "C" int mla_decode_paged_fwd(const void* q_abs, const void* q_r,
                                    const void* ckv_pool,
                                    const void* kr_pool, const void* tables,
                                    const void* kv_lens, void* out, int B,
                                    int H, int R, int DR, int N, int bs,
                                    int MB, float scale, int dtype,
                                    void* stream) {
  if (R != kR || DR != kDR || B <= 0 || H <= 0 || N <= 0 || bs <= 0 ||
      MB <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(q_abs, q_r, ckv_pool, kr_pool, tables, kv_lens, out,
                        B, H, N, bs, MB, scale, dtype, stream);
}
