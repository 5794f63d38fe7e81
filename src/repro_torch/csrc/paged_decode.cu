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
//   below kv_lens[b] score exactly 0 and count in the denominator while
//   adding nothing to the output, as the reference's mode="fill" gather
//   does. Such an entry is never dereferenced. An inactive slot (all
//   NULL, kv_lens = 1) gives exactly 0.
//   q (B, 1, H, D), pools (N, bs, Hkv, D), out (B, 1, H, D), one dtype
//   (fp32 or bf16); tables (B, MB) int32, kv_lens (B,) int32. fp32
//   softmax. One design for both dtypes, the head dim a template
//   parameter (64 built).
//
// What bounds it on the H100: memory. Each cached K and V element is
//   used by H/Hkv = 8 query heads for 2 flops each, ~4 flops per bf16
//   byte against the card's ~295 balance point, so the least time is
//   sum_b kv_lens[b] * Hkv * D * 2 bytes * 2 (K and V) over 3.35 TB/s.
//   At serving batch sizes that is well under a microsecond, so what
//   the kernel pays for is latency: global round trips and barriers in
//   series, and how many SMs have work.
//
// What this design does about it:
//   * The positions are split across blocks: grid (splits, Hkv, B), a
//     split kSplit positions long (a compile-time constant). The grid
//     comes from the shape MB*bs, so the host never reads kv_lens; a
//     split that starts at or past kv_lens[b] exits at once. At B=8,
//     Hkv=4 and windows of 512 that is 256 blocks where one block per
//     (sequence, kv head) gave 32 on the 132 SMs.
//   * A block serves all H/Hkv query heads of its kv head, so each K/V
//     row is read from device memory once. It stages its split's table
//     entries in shared memory (one load per page) and copies K and V
//     rows by 16-byte cp.async into a 2-stage ring of kTile-position
//     tiles (rows zero-filled for NULL pages and past kv_lens). Scores,
//     an online softmax per head (m, l in log2 units) and P V run in
//     fp32 on the CUDA cores: with one query there is no product large
//     enough for wgmma.
//   * A second small kernel merges each (sequence, head)'s partials
//     (m, l, acc) in split order, from split 0 up to the last split
//     below kv_lens[b].
//   * Batch invariance: the splits start at position 0 and have a fixed
//     length, and the merge reads only the splits that hold positions,
//     so a sequence's arithmetic depends on its own q, table row and
//     kv_lens[b] alone, never on B, MB or the other sequences; no atomics,
//     so the bits repeat from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

// positions a split (a block) and a ring stage: the fastest of the
// (split, stage) pairs timed at the serve and long-window shapes
// (PERF.md), keeping two stages a split
constexpr int kSplit = 64;
constexpr int kTile = 32;        // 32, 64 or 128
static_assert(kSplit % kTile == 0 && kTile % 32 == 0 && kTile <= 128,
              "paged_decode: tiles");
constexpr int kThreads = 128;
constexpr int kMaxGroup = 16;    // most query heads per kv head
constexpr float kLog2e = 1.4426950408889634f;

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
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a row of D values of T in shared memory (16-byte aligned) as fp32,
// by 16-byte loads
template <typename T, int D>
__device__ __forceinline__ void row_f32(const uint8_t* p, float (&out)[D]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < D * (int)sizeof(T) / 16; ++c) {
    const uint4 u = p4[c];
    if constexpr (sizeof(T) == 4) {
      out[4 * c] = __uint_as_float(u.x);
      out[4 * c + 1] = __uint_as_float(u.y);
      out[4 * c + 2] = __uint_as_float(u.z);
      out[4 * c + 3] = __uint_as_float(u.w);
    } else {
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(b2[j]);
        out[8 * c + 2 * j] = f.x;
        out[8 * c + 2 * j + 1] = f.y;
      }
    }
  }
}

template <typename T, int D>
struct SplitCfg {
  static constexpr int kChunks = D * sizeof(T) / 16;   // 16-byte chunks a row
  // a row padded by 16 bytes: 8 lanes reading 8 rows at one chunk hit 8
  // different bank groups
  static constexpr int kRowBytes = D * sizeof(T) + 16;
  static constexpr int kTileBytes = kTile * kRowBytes;   // K or V tile
  static constexpr int kRing = 2 * 2 * kTileBytes;       // 2 stages, K + V
  static constexpr int kSmem = kRing + kMaxGroup * D * 4      // q
                               + kMaxGroup * kTile * 4        // scores / p
                               + kMaxGroup * 4                // corrections
                               + (kSplit + 2) * 4;            // table slice
};

// partial of (b, h, split): acc[D], then m (log2 units) and l
template <int D>
__device__ __forceinline__ size_t part_off(int b, int h, int H, int split,
                                           int splits) {
  return (((size_t)b * H + h) * splits + split) * (D + 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ tables,
                   const int* __restrict__ kv_lens,
                   float* __restrict__ part, int H, int Hkv, int N, int bs,
                   int MB, int splits, float scale) {
  using C = SplitCfg<T, D>;
  constexpr int kC = C::kChunks;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t ring = sm90::smem_u32(smem);
  float* q_s = reinterpret_cast<float*>(smem + C::kRing);     // [G][D]
  float* s_s = q_s + kMaxGroup * D;                           // [G][kTile]
  float* corr_s = s_s + kMaxGroup * kTile;                    // [G]
  int* tbl_s = reinterpret_cast<int*>(corr_s + kMaxGroup);

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int window = MB * bs;
  const int s0 = split * kSplit;
  // kv_lens[b], q of the group's heads (fp32) and the split's table
  // entries: independent loads, one round trip
  const int len = min(kv_lens[b], window);
  for (int i = tid; i < group * D; i += kThreads)
    q_s[i] = to_f(q[((size_t)b * H + g * group) * D + i]);
  const int p0 = s0 / bs;
  const int n_pages = (min(s0 + kSplit, window) - 1) / bs - p0 + 1;
  for (int i = tid; i < n_pages; i += kThreads)
    tbl_s[i] = tables[(size_t)b * MB + p0 + i];
  __syncthreads();
  if (s0 >= len) return;                 // no positions: nothing to merge
  const int s1 = min(s0 + kSplit, len);
  const int n_t = (s1 - s0 + kTile - 1) / kTile;

  // tile t's K and V rows into ring stage t % 2; rows of NULL pages and
  // past kv_lens are zero-filled. Thread tid owns chunk tid % kC of rows
  // tid / kC + j * kThreads / kC.
  auto load_tile = [&](int t) {
    const uint32_t st = ring + (t & 1) * 2 * C::kTileBytes;
    const int c = tid % kC;
#pragma unroll
    for (int r = tid / kC; r < kTile; r += kThreads / kC) {
      const int pos = s0 + t * kTile + r;
      bool ok = pos < s1;
      size_t off = 0;
      if (ok) {
        const int blk = tbl_s[pos / bs - p0];
        ok = blk >= 0 && blk < N;
        off = (((size_t)blk * bs + pos % bs) * Hkv + g) * D;
      }
      const T* kp = ok ? k_pool + off + c * (16 / sizeof(T)) : k_pool;
      const T* vp = ok ? v_pool + off + c * (16 / sizeof(T)) : v_pool;
      const uint32_t dst = st + r * C::kRowBytes + c * 16;
      sm90::cp_async_16(dst, kp, ok);
      sm90::cp_async_16(dst + C::kTileBytes, vp, ok);
    }
  };

  load_tile(0);
  sm90::cp_async_commit();
  const float sl2 = scale * kLog2e;
  // phase B state: warp w owns heads w, w + 4, w + 8, w + 12
  float m_h[kMaxGroup / 4], l_h[kMaxGroup / 4];
#pragma unroll
  for (int i = 0; i < kMaxGroup / 4; ++i) { m_h[i] = -INFINITY; l_h[i] = 0.f; }
  // phase C state: thread owns dim tid % D of heads tid / D + j * (kThreads / D)
  constexpr int kHeadsPerThread = kMaxGroup * D / kThreads;
  float acc[kHeadsPerThread];
#pragma unroll
  for (int i = 0; i < kHeadsPerThread; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    if (t + 1 < n_t) load_tile(t + 1);     // its stage was freed by the last
    sm90::cp_async_commit();           // barrier of tile t - 1
    sm90::cp_async_wait<1>();          // tile t landed
    __syncthreads();
    const uint8_t* k_t = smem + (t & 1) * 2 * C::kTileBytes;
    const uint8_t* v_t = k_t + C::kTileBytes;
    const int t0 = s0 + t * kTile;

    // A: scores in log2 units; thread (position j, head parity)
    {
      const int j = tid % kTile;
      const bool live = t0 + j < s1;
      float kr[D];
      row_f32<T, D>(k_t + j * C::kRowBytes, kr);
      for (int hh = tid / kTile; hh < group; hh += kThreads / kTile) {
        const float4* qh = reinterpret_cast<const float4*>(q_s + hh * D);
        float s = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 qv = qh[d4];        // the warp's head: a broadcast
          s = fmaf(qv.x, kr[4 * d4], s);
          s = fmaf(qv.y, kr[4 * d4 + 1], s);
          s = fmaf(qv.z, kr[4 * d4 + 2], s);
          s = fmaf(qv.w, kr[4 * d4 + 3], s);
        }
        s_s[hh * kTile + j] = live ? s * sl2 : -INFINITY;
      }
    }
    __syncthreads();

    // B: online softmax of each head over the tile (a warp a head)
#pragma unroll
    for (int i = 0; i < kMaxGroup / 4; ++i) {
      const int hh = warp + 4 * i;
      if (hh >= group) break;
      float* row = s_s + hh * kTile;
      float x[kTile / 32], mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        x[u] = row[lane + 32 * u];
        mx = fmaxf(mx, x[u]);
      }
      const float mn = fmaxf(m_h[i], warp_max(mx));
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const float e = sm90::fast_exp2(x[u] - mn);
        row[lane + 32 * u] = e;
        sum += e;
      }
      const float c = sm90::fast_exp2(m_h[i] - mn);
      l_h[i] = l_h[i] * c + warp_sum(sum);
      m_h[i] = mn;
      if (lane == 0) corr_s[hh] = c;
    }
    __syncthreads();

    // C: acc = acc * corr + sum_j p_j v_j, positions in order
    {
      const int d = tid % D;
      const int n = min(kTile, s1 - t0);
#pragma unroll
      for (int i = 0; i < kHeadsPerThread; ++i) {
        const int hh = tid / D + i * (kThreads / D);
        if (hh < group) acc[i] *= corr_s[hh];
      }
      for (int j = 0; j < n; ++j) {
        const float vj = to_f(
            reinterpret_cast<const T*>(v_t + j * C::kRowBytes)[d]);
#pragma unroll
        for (int i = 0; i < kHeadsPerThread; ++i) {
          const int hh = tid / D + i * (kThreads / D);
          if (hh < group) acc[i] = fmaf(s_s[hh * kTile + j], vj, acc[i]);
        }
      }
    }
    __syncthreads();                   // stage t and s_s free
  }

  const int d = tid % D;
#pragma unroll
  for (int i = 0; i < kHeadsPerThread; ++i) {
    const int hh = tid / D + i * (kThreads / D);
    if (hh < group)
      part[part_off<D>(b, g * group + hh, H, split, splits) + d] = acc[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kMaxGroup / 4; ++i) {
      const int hh = warp + 4 * i;
      if (hh >= group) break;
      float* pm = part + part_off<D>(b, g * group + hh, H, split, splits) + D;
      pm[0] = m_h[i];
      pm[1] = l_h[i];
    }
  }
}

// One block per (head, sequence), a thread per dim: the live splits'
// partials merged in split order, then acc / l in the output dtype.
template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_decode_merge(const float* __restrict__ part,
                   const int* __restrict__ kv_lens, T* __restrict__ o,
                   int H, int window, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(kv_lens[b], window);
  const int n = len > 0 ? (len + kSplit - 1) / kSplit : 0;
  float m = 0.f, l = 1.f, acc = 0.f;
  if (n > 0) {
    const float* p = part + part_off<D>(b, h, H, 0, splits);
    acc = p[d];
    m = p[D];
    l = p[D + 1];
  }
  for (int s = 1; s < n; ++s) {
    const float* p = part + part_off<D>(b, h, H, s, splits);
    const float ms = p[D];
    const float mn = fmaxf(m, ms);
    const float c0 = sm90::fast_exp2(m - mn), c1 = sm90::fast_exp2(ms - mn);
    acc = acc * c0 + p[d] * c1;
    l = l * c0 + p[D + 1] * c1;
    m = mn;
  }
  o[((size_t)b * H + h) * D + d] = from_f<T>(acc * (1.f / l));
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* kv_lens, void* o, float* part,
           int B, int H, int Hkv, int N, int bs, int MB, int splits,
           float scale, cudaStream_t s) {
  using C = SplitCfg<T, D>;
  static bool smem_set[64] = {};
  cudaError_t err = sm90::allow_smem(paged_decode_split<T, D>, C::kSmem,
                                     smem_set);
  if (err != cudaSuccess) return (int)err;
  paged_decode_split<T, D><<<dim3(splits, Hkv, B), kThreads, C::kSmem, s>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, tables, kv_lens,
      part, H, Hkv, N, bs, MB, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge<T, D><<<dim3(H, B), D, 0, s>>>(part, kv_lens, (T*)o,
                                                    H, MB * bs, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part is fp32 scratch of (B, H,
// splits, D + 2) for the partials, splits = ceil(MB * bs / split length)
// (paged_decode_split_len). Returns cudaGetLastError() after the
// launches (0 = cudaSuccess); a configuration the kernel does not take,
// or a scratch of another number of splits, returns cudaErrorInvalidValue
// without launching.
extern "C" int paged_decode_fwd(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* kv_lens, void* o, void* part,
                                int B, int H, int Hkv, int D, int N, int bs,
                                int MB, int splits, float scale, int dtype,
                                void* stream) {
  if (D != 64 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup ||
      B <= 0 || bs <= 0 || MB <= 0 || N <= 0 ||
      splits != (MB * bs + kSplit - 1) / kSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* t = (const int*)tables;
  const int* lens = (const int*)kv_lens;
  float* p = (float*)part;
  if (dtype == 0)
    return launch<float, 64>(q, k_pool, v_pool, t, lens, o, p, B, H, Hkv, N,
                             bs, MB, splits, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, t, lens, o, p, B, H,
                                     Hkv, N, bs, MB, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Positions a split of paged_decode_fwd: what flash_decode_paged_split_plain
// models (DECODE_SPLIT in kernels/flash_attention/flash_attention.py).
extern "C" int paged_decode_split_len() { return kSplit; }
