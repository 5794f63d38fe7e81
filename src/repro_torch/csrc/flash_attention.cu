// Causal GQA flash-attention forward for prefill and training, written
// for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   flash_attention_pallas (_fa_kernel, pallas_call at :125).
//
// Computes out = softmax(q k^T * scale + mask) v with
//   q (B, Sq, H, D), k/v (B, Skv, Hkv, D), out (B, Sq, H, D), all in
//   the same dtype (fp32 or bf16), contiguous, D in {64, 80, 128, 192}
//   (80: zamba2's shared attention block; 192: MLA prefill, q/k =
//   [nope | rope] and v zero-padded); q head h
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
//   (H=Hkv=16, D=128) training at S=1024 is bound by the tensor cores,
//   and so is deepseek-v2's MLA prefill (H=Hkv=128, D=192) from S of
//   about 300 on.
//
// Two designs, by dtype (flash_attention_fwd dispatches; there is no
// other switch):
//
// bf16: the tensor cores (wgmma) over a cp.async ring. One consumer
//   warpgroup owns 64 q rows; a block holds one or two (Sm90Tiles: the
//   tiling each head dim takes, timed at the path's shapes).
//   * The q tile is staged once; K and V tiles of 32 or 64 positions go
//     through a 2-stage ring of 16-byte cp.async copies (zero-filled past
//     Skv or Sq) into 128-byte-swizzled tiles (sm90.cuh): the copies of
//     tile t+1 run while tile t is computed. Each thread fences the
//     async proxy after its copies landed and before the barrier ahead
//     of the wgmma that reads them.
//   * S = Q K^T by wgmma with both operands K-major from shared memory,
//     in k16 steps over D; the scale is applied to the fp32 accumulator
//     (in log2 units), never to a bf16 q. The online softmax runs on the
//     accumulator fragment: a thread holds two rows, the row max takes
//     two quad shuffles, the row sum stays per thread until the end. The
//     mask is applied only on tiles that cross Skv or the diagonal;
//     tiles above it are not visited.
//   * O += P V by wgmma with P from registers: the S fragment's k16
//     slice is the A fragment as it stands (FlashAttention-3's layout
//     identity), and V (pos, D) is read MN-major with the transpose
//     bit. P goes in as the bf16 pair hi = bf16(p), lo = bf16(p - hi),
//     two products on the same V tile, so P keeps ~2^-17 of its fp32
//     value where one rounding keeps 2^-9 (about 2e-3 rel L2 on the
//     output, above the bf16 limit; tests/test_torch_sm90_numerics.py).
//     The P V half costs twice the flops for it.
//   * D=80: shared-memory tiles are padded to 128 columns (two 64-column
//     swizzle blocks; global reads stay 80 wide), and the products are
//     n80. D=192: three column blocks; one warpgroup of 64 rows with
//     32-position kv tiles stays under 255 registers with no spill and
//     takes 73 KB, three blocks an SM.
//   * q tiles run last first, so the causal rows with the most keys
//     start first.
//   What bounds it now: each warpgroup runs S, softmax and P V in turn
//   (no overlap inside a warpgroup, a barrier a tile); the tensor cores
//   idle while the softmax runs unless another block's warpgroup fills
//   them. TMA, warp specialisation and ping-pong warpgroups are next.
//
// fp32: the first, CUDA-core version, unchanged (wgmma has no fp32
//   operands, and TF32 keeps about 3 digits). It keeps from the TPU
//   kernel what matters for memory: no (Sq, Skv) score matrix and no
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
//     rows at D=64 and 32 rows at D=80 and D=128 (72-80 registers, no
//     spills), 16 rows at D=192 (72 registers). Every width takes its
//     tiles as dynamic shared memory (opted in at each launch).
//   * D=80 (not a multiple of the 32 lanes): a lane holds ceil(D/32) = 3
//     accumulator columns a row, lane + 32c, and the third is live only
//     on lanes 0..15 (a compile-time guard).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int kBKV = 32;         // kv positions per tile (one per lane)
constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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
  return D == 192 ? 16 : (D == 128 || D == 80) ? 32 : 64;
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
  constexpr int kC = (D + 31) / 32;  // accumulator columns per lane
  constexpr bool kTail = D % 32 != 0;  // the last column is partial
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
        for (int c = 0; c < kC; ++c)
          if (!kTail || lane + 32 * c < D)
            a[c] = fmaf(pj, v_s[j][lane + 32 * c], a[c]);
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
    for (int c = 0; c < kC; ++c)
      if (!kTail || lane + 32 * c < D)
        dst[lane + 32 * c] = from_f<T>(acc[i][c] * inv);
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


// ---------------------------------------------------------------------
// bf16: tensor cores (wgmma) over a cp.async ring
// ---------------------------------------------------------------------

template <int D, int kWG_, int kBKV_>
struct Sm90Cfg {
  static constexpr int kWG = kWG_;                 // consumer warpgroups
  static constexpr int kBKV = kBKV_;               // kv positions a tile
  static constexpr int kDP = (D + 63) / 64 * 64;   // tile columns in smem
  static constexpr int kBQ = 64 * kWG;             // q rows a block
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kQBytes = kBQ * kDP * 2;
  static constexpr int kKVBytes = kBKV * kDP * 2;  // one K or V tile
  // the q tile, a 2-stage ring of K and V tiles, 1 KB to align the base
  static constexpr int kSmem = kQBytes + 2 * 2 * kKVBytes + 1024;
};

template <int D, class C>
__global__ void __launch_bounds__(C::kThreads)
flash_fwd_sm90(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
               int Sq, int Skv, int H, int Hkv, int causal, int q_offset,
               float scale) {
  constexpr int kBQ = C::kBQ, kBKV = C::kBKV, kT = C::kThreads;
  constexpr int kC = D / 8;                        // 16-byte chunks a row
  constexpr int kStageBytes = 2 * C::kKVBytes;     // K then V
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + C::kQBytes;

  // q tiles in reverse: the causal rows with the most keys start first
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int q0 = qt * kBQ;
  const size_t q_ld = (size_t)H * D, kv_ld = (size_t)Hkv * D;
  const __nv_bfloat16* qg = q + ((size_t)b * Sq + q0) * q_ld + (size_t)h * D;
  const __nv_bfloat16* kg = k + (size_t)b * Skv * kv_ld + (size_t)hk * D;
  const __nv_bfloat16* vg = v + (size_t)b * Skv * kv_ld + (size_t)hk * D;

  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + kBQ, Sq) + q_offset);
  const int n_t = kv_end > 0 ? (kv_end + kBKV - 1) / kBKV : 0;

  // the ring's first group: the q tile and tile 0
  sm90::load_rows<kBQ, kC, kT>(q_s, qg, q_ld, Sq - q0, kC, tid);
  if (n_t > 0) {
    sm90::load_rows<kBKV, kC, kT>(kv_s, kg, kv_ld, Skv, kC, tid);
    sm90::load_rows<kBKV, kC, kT>(kv_s + C::kKVBytes, vg, kv_ld, Skv, kC,
                                  tid);
  }
  sm90::cp_async_commit();

  // this thread's two rows (r, r + 8) of its warpgroup's 64
  const int wq0 = q0 + wg * 64;                    // warpgroup's first row
  const int row0 = wq0 + warp * 16 + lane / 4;
  const int qpos0 = row0 + q_offset, qpos1 = qpos0 + 8;
  const bool wg_live = wq0 < Sq;
  const int wg_first = wq0 + q_offset;
  const int wg_last = min(wq0 + 64, Sq) - 1 + q_offset;
  const float sl2 = scale * kLog2e;                // scores in log2 units

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max (log2 units) and sum of this thread's columns, per row
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_t; ++t) {
    const int k0 = t * kBKV;
    sm90::cp_async_wait<0>();          // tile t (and q) landed
    sm90::fence_proxy_async();
    __syncthreads();                   // ... for every thread; and tile
                                       // t-1's stage is no longer read
    if (t + 1 < n_t) {                 // tile t+1 into that stage
      const uint32_t st = kv_s + ((t + 1) & 1) * kStageBytes;
      const size_t off = (size_t)(k0 + kBKV) * kv_ld;
      const int rows = Skv - k0 - kBKV;
      sm90::load_rows<kBKV, kC, kT>(st, kg + off, kv_ld, rows, kC, tid);
      sm90::load_rows<kBKV, kC, kT>(st + C::kKVBytes, vg + off, kv_ld,
                                    rows, kC, tid);
    }
    sm90::cp_async_commit();
    // a warpgroup whose rows see none of this tile skips it (uniform)
    if (!wg_live || (causal && k0 > wg_last)) continue;
    const uint32_t k_s = kv_s + (t & 1) * kStageBytes;
    const uint32_t v_s = k_s + C::kKVBytes;

    // S = Q K^T (64 x kBKV), K-major both, in k16 steps over D
    float s[kBKV / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t blk = kk / 4, off = (kk % 4) * 32;
      sm90::wgmma_ss<kBKV, 0>(
          s, sm90::desc_sw128(q_s + blk * kBQ * 128 + wg * 64 * 128 + off,
                              16, 1024),
          sm90::desc_sw128(k_s + blk * kBKV * 128 + off, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // scale, mask (only where the tile crosses Skv or the diagonal)
    const bool edge = k0 + kBKV > Skv || (causal && k0 + kBKV - 1 > wg_first);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * (lane % 4) + e;
        float x0 = s[4 * j + e] * sl2, x1 = s[4 * j + 2 + e] * sl2;
        if (edge) {
          const bool in = col < Skv;
          if (!in || (causal && col > qpos0)) x0 = -INFINITY;
          if (!in || (causal && col > qpos1)) x1 = -INFINITY;
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {        // the quad shares a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = sm90::fast_exp2(m0 - mn0);
    const float c1 = sm90::fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p in fp32, then as the A fragment of a bf16 pair hi + lo (P to
    // ~2^-17, not 2^-9): k16 slice ks of S is registers 8 ks .. 8 ks + 7
    uint32_t phi[kBKV / 16][4], plo[kBKV / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBKV / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 8 * ks + 2 * i;              // row r for i even
        const float mm = (i & 1) ? mn1 : mn0;
        const float p0 = sm90::fast_exp2(s[a] - mm);
        const float p1 = sm90::fast_exp2(s[a + 1] - mm);
        if (i & 1) ps1 += p0 + p1; else ps0 += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        phi[ks][i] = *reinterpret_cast<const uint32_t*>(&hi);
        plo[ks][i] = sm90::pack_bf16(p0 - hf.x, p1 - hf.y);
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= c0;
      acc[4 * j + 1] *= c0;
      acc[4 * j + 2] *= c1;
      acc[4 * j + 3] *= c1;
    }
    // O += P V: V is (pos, D), read MN-major (the transpose bit)
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBKV / 16; ++ks) {
      const uint64_t db = sm90::desc_sw128(v_s + ks * 16 * 128,
                                           kBKV * 128, 1024);
      sm90::wgmma_rs<D, 1>(acc, phi[ks], db, 1);
      sm90::wgmma_rs<D, 1>(acc, plo[ks], db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kBKV / 16; ++ks) {
      sm90::fence_regs(phi[ks]);
      sm90::fence_regs(plo[ks]);
    }
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Sq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* dst = o + ((size_t)(b * Sq + row) * H + h) * D +
                         2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * inv,
                                acc[4 * j + 2 * half + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)(b * Sq + row) * H + h] =
          (half ? m1 : m0) * kLn2 + logf(half ? lc1 : lc0);
  }
}

template <int D, class C>
int launch_sm90(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Skv, int H, int Hkv,
                int causal, int q_offset, float scale, cudaStream_t s) {
  static bool smem_set[64] = {};               // one set per kernel
  cudaError_t err = sm90::allow_smem(flash_fwd_sm90<D, C>, C::kSmem,
                                     smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + C::kBQ - 1) / C::kBQ, H, B);
  flash_fwd_sm90<D, C><<<grid, C::kThreads, C::kSmem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, Sq, Skv, H, Hkv,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

// The tiling each head dim takes (warpgroups, kv tile), the
// fastest of those timed at the path's shapes (PERF.md): the most
// warpgroups an SM holds, in independent blocks where that costs none.
template <int D> struct Sm90Tiles;
template <> struct Sm90Tiles<64> { using C = Sm90Cfg<64, 1, 64>; };
template <> struct Sm90Tiles<80> { using C = Sm90Cfg<80, 2, 64>; };
template <> struct Sm90Tiles<128> { using C = Sm90Cfg<128, 1, 64>; };
template <> struct Sm90Tiles<192> { using C = Sm90Cfg<192, 1, 32>; };

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
  if ((D != 64 && D != 80 && D != 128 && D != 192) || Hkv <= 0 ||
      H % Hkv != 0 ||
      B <= 0 || Sq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
#define REPRO_FWD(T, DD)                                                  \
  if (D == DD)                                                            \
    return launch<T, DD>(q, k, v, o, l, B, Sq, Skv, H, Hkv, causal,      \
                         q_offset, scale, s)
  if (dtype == 0) {
    REPRO_FWD(float, 64);
    REPRO_FWD(float, 80);
    REPRO_FWD(float, 128);
    REPRO_FWD(float, 192);
  }
#undef REPRO_FWD
#define REPRO_FWD_SM90(DD)                                                \
  if (D == DD)                                                            \
    return launch_sm90<DD, Sm90Tiles<DD>::C>(q, k, v, o, l, B, Sq, Skv, H, \
                                             Hkv, causal, q_offset, scale, s)
  if (dtype == 1) {
    REPRO_FWD_SM90(64);
    REPRO_FWD_SM90(80);
    REPRO_FWD_SM90(128);
    REPRO_FWD_SM90(192);
  }
#undef REPRO_FWD_SM90
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a bf16 launch of flash_attention_fwd asks for
// (bytes), or -1 for a head dim it does not take.
extern "C" int flash_attention_fwd_sm90_smem(int D) {
  if (D == 64) return Sm90Tiles<64>::C::kSmem;
  if (D == 80) return Sm90Tiles<80>::C::kSmem;
  if (D == 128) return Sm90Tiles<128>::C::kSmem;
  if (D == 192) return Sm90Tiles<192>::C::kSmem;
  return -1;
}

// kv positions a tile of a bf16 launch of flash_attention_fwd, or -1 for
// a head dim it does not take: what flash_attention_tiled_plain models
// (KV_TILES in kernels/flash_attention/flash_attention.py).
extern "C" int flash_attention_fwd_sm90_kv_tile(int D) {
  if (D == 64) return Sm90Tiles<64>::C::kBKV;
  if (D == 80) return Sm90Tiles<80>::C::kBKV;
  if (D == 128) return Sm90Tiles<128>::C::kBKV;
  if (D == 192) return Sm90Tiles<192>::C::kBKV;
  return -1;
}
