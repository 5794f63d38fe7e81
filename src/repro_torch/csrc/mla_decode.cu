// Absorbed-MLA single-token decode attention, over a contiguous latent
// cache and over a paged latent pool, written for sm_90a.
//
// Replaces: src/repro/kernels/mla_decode/mla_decode.py,
//   mla_decode_pallas (_kernel, pallas_call at :94) and
//   mla_decode_paged_pallas (_paged_kernel, pallas_call at :217).
//
// Computes, for each sequence b and head h (all heads share the cache):
//   s[j] = (q_abs[b,h] . ckv[b,j] + q_r[b,h] . kr[b,j]) * scale,
//   masked at positions j >= kv_len[b],
//   out[b,h] = sum_j softmax(s)[j] * ckv[b,j]          (latent space)
// with q_abs (B, H, 512), q_r (B, H, 64), ckv rows of 512, kr rows of
// 64, all in one dtype (fp32 or bf16), out (B, H, 512) fp32. The
// contiguous kernel reads position j at ckv[b, j] (B, S, 512) and has
// positions j < S; the paged kernels read it in pool block
// tables[b, j / bs] at row j % bs (pools (N, bs, 512) and (N, bs, 64),
// tables (B, MB) int32) and have positions j < MB*bs. A table entry
// outside [0, N) (the NULL sentinel is N) is a block of zeros: its live
// positions score exactly 0 and count in the denominator, and it is
// never dereferenced; the all-NULL inactive slot gives exactly 0.
// kv_len[b] >= 1 (the serving path passes cached + 1). As in the Pallas
// kernels: the softmax state (m, l, acc) is fp32, scores are fp32 sums
// of the inputs' exact products, p is rounded to the cache dtype before
// the value product (mla_decode.py:67-71, :163-167), and out = acc /
// max(l, 1e-30).
//
// What bounds it on the H100: memory. Each cached position (576 values)
// is used by all H = 128 heads, 2 flops per value for the scores and 2
// per latent value for the output: ~250 flops per bf16 byte of cache at
// H = 128, under the card's ~295 balance point, so the least time is
// the bytes (cache rows below kv_len, q, out) over 3.35 TB/s: ~1.5 us
// at the serve shape, where what the kernel pays for is latency and
// how many SMs have work.
//
// Two designs, by dtype (mla_decode_fwd and mla_decode_paged_fwd
// dispatch; there is no other switch):
//
// bf16: the tensor cores, positions split across blocks. One kernel,
// mla_split_sm90<kPaged>, serves both caches; they differ only in where
// position pos of sequence b lives (the paged kernel: row blk * bs + pos
// % bs, blk = tables[b, pos / bs]; the contiguous one: row b * S + pos,
// read as a pool of B blocks of S rows with no table).
//   * Grid (splits, ceil(H/64), B), a split kSplit positions long (a
//     compile-time constant). The grid comes from the shape (MB*bs, or
//     S), so the host never reads kv_len; a split that starts at or past
//     kv_len[b] exits at once. At the paged serve shape (B=8, H=128,
//     MB*bs=512) that is 4 x 2 x 8 = 64 blocks; at the longer window
//     (MB*bs=2048) 256; contiguous at the generate shape (B=4, S=1088)
//     9 x 2 x 4 = 72.
//   * One block for 64 heads, two warpgroups. The block's [q_abs | q_r]
//     tile (64 x 576 bf16, heads >= H zero-filled) is copied once into
//     128-byte-swizzled shared memory (9 column blocks of 64). The
//     split's rows are looked up once (through its slice of the table
//     row when paged); position tiles (kTile x 576) are gathered row by
//     row from the two caches by 16-byte cp.async into a 2-stage ring,
//     rows of NULL, out-of-pool and dead positions zero-filled: the
//     copies of tile t+1 run while tile t is computed.
//   * S = Q K^T (M = 64 heads, N = kTile positions, K = 576) by wgmma
//     with both operands K-major: fp32 sums of exact bf16 products. Both
//     warpgroups compute it (the same instructions on the same tiles,
//     so the same bits) and run the same online softmax (log2 units) on
//     its fragment: no shared-memory hand-off and no barrier between
//     them. p is rounded to bf16 once and fed from registers.
//   * O_half = O_half * corr + P ckv_tile[:, half]: warpgroup w owns
//     latent columns [256 w, 256 w + 256), an n256 wgmma whose B operand
//     is the SAME shared-memory tile as the scores, read MN-major through
//     the transpose bit: each cached row is read from device memory once,
//     the TPU kernel's point. The accumulator is 128 registers a thread.
//   * A second small kernel (mla_merge) merges the partials (m, l, acc)
//     of the splits below kv_len[b] in split order and writes acc /
//     max(l, 1e-30). Batch invariance: splits start at position 0 with a
//     fixed length and the merge reads only the live ones, so a
//     sequence's bits depend on its own q, rows and kv_len alone; no
//     atomics, so the bits repeat from run to run.
//
// fp32 (both caches): the first, CUDA-core version (wgmma has no fp32
// operands).
//   * One block owns one (sequence, group of 16 heads) and loops over
//     tiles of 16 positions (staged once in shared memory as fp32, used
//     for the scores and the values); m, l and acc live in registers. A
//     warp owns 4 heads; a lane owns 16 latent columns of each head's
//     accumulator (lane + 32 j). Lanes t and t + 16 own position t of the
//     tile and half of its columns for the scores; one shuffle joins the
//     halves. The tile's row stride is 580 floats, so the float4 reads of
//     8 lanes on 8 rows fall on 32 different banks.
//   * H/16 x B blocks (64 at B = 8) leave half the SMs idle; the serving
//     paths run fp32 only in their gates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

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

// fp32 only. rows: S (contiguous: ckv (B, S, 512)) or N (paged: pool
// blocks)
template <bool kPaged>
__global__ void __launch_bounds__(kWarps * 32)
mla_decode_kernel(const float* __restrict__ qa, const float* __restrict__ qr,
                  const float* __restrict__ ckv, const float* __restrict__ kr,
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
      const float* crow = nullptr;
      const float* krow = nullptr;
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

    // online softmax over the tile (p in the cache dtype, fp32, for the
    // values)
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
      pc[i] = p;
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

template <bool kPaged>
int launch(const void* qa, const void* qr, const void* ckv, const void* kr,
           const void* tables, const void* lens, void* out, int B, int H,
           int rows, int bs, int MB, float scale, cudaStream_t s) {
  static bool smem_set[64] = {};               // one set per kernel
  cudaError_t err = sm90::allow_smem(mla_decode_kernel<kPaged>,
                                     (int)kSmemBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + kHB - 1) / kHB, B);
  mla_decode_kernel<kPaged><<<grid, kWarps * 32, kSmemBytes, s>>>(
      (const float*)qa, (const float*)qr, (const float*)ckv, (const float*)kr,
      (const int*)tables, (const int*)lens, (float*)out, H, rows, bs, MB,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16: tensor cores (wgmma), positions split across blocks
// ---------------------------------------------------------------------

// positions a split (a block) and a ring stage: the fastest of the
// (split, stage) pairs timed at the paged serve and long-window shapes
// (PERF.md)
constexpr int kSplit = 128;
constexpr int kTile = 64;
static_assert(kSplit % kTile == 0 && kTile % 16 == 0 && kTile <= 64,
              "mla_decode: tiles");
constexpr int kHT = 64;                  // heads a block (wgmma M)
constexpr int kChunks = kW / 8;          // 16-byte chunks of a 576 row
constexpr int kRChunks = kR / 8;         // ... of which the latent's
constexpr int kSm90Threads = 256;        // two warpgroups
constexpr int kQBytes = kHT * kW * 2;    // the q tile
constexpr int kTileBytes = kTile * kW * 2;
// the q tile, a 2-stage ring, the split's rows, 1 KB to align
constexpr int kSm90Smem = kQBytes + 2 * kTileBytes + kSplit * 4 + 1024;
// a partial of (b, h, split): acc[512], m (log2 units), l, 2 floats of
// padding (16-byte rows)
constexpr int kPart = kR + 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ size_t part_off(int b, int h, int H, int split,
                                           int splits) {
  return (((size_t)b * H + h) * splits + split) * kPart;
}

// kPaged: rows through tables (B, MB) into a pool of N blocks of bs
// rows; otherwise sequence b's rows b * bs + pos of a (B, bs, .) cache
// (bs = S, MB = 1, no table)
template <bool kPaged>
__global__ void __launch_bounds__(kSm90Threads, 1)
mla_split_sm90(const __nv_bfloat16* __restrict__ qa,
               const __nv_bfloat16* __restrict__ qr,
               const __nv_bfloat16* __restrict__ ckv,
               const __nv_bfloat16* __restrict__ kr,
               const int* __restrict__ tables, const int* __restrict__ lens,
               float* __restrict__ part, int H, int N, int bs, int MB,
               int splits, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t ring = base + kQBytes;
  int* row_s = reinterpret_cast<int*>(smem_raw + (base - raw) + kQBytes +
                                      2 * kTileBytes);

  const int split = blockIdx.x, h0 = blockIdx.y * kHT, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int len = min(lens[b], MB * bs);
  const int s0 = split * kSplit;
  if (s0 >= len) return;                 // no positions: nothing to merge
  const int s1 = min(s0 + kSplit, len);
  const int n_t = (s1 - s0 + kTile - 1) / kTile;

  // the split's rows (-1: a NULL or out-of-pool entry) and the q tile
  // [q_abs | q_r] of heads h0 .. h0 + 63 (past H: zeros)
  for (int i = tid; i < s1 - s0; i += kSm90Threads) {
    const int pos = s0 + i;
    if (kPaged) {
      const int blk = tables[(size_t)b * MB + pos / bs];
      row_s[i] = blk >= 0 && blk < N ? blk * bs + pos % bs : -1;
    } else {
      row_s[i] = b * bs + pos;
    }
  }
  for (int i = tid; i < kHT * kChunks; i += kSm90Threads) {
    const int r = i / kChunks, c = i % kChunks, h = h0 + r;
    const bool ok = h < H;
    const __nv_bfloat16* src =
        c < kRChunks ? qa + ((size_t)b * H + h) * kR + c * 8
                     : qr + ((size_t)b * H + h) * kDR + (c - kRChunks) * 8;
    sm90::cp_async_16(q_s + sm90::tile_off(kHT, r, c), ok ? src : qa, ok);
  }
  __syncthreads();                       // row_s

  // tile t's rows into ring stage t % 2, 72 chunks a row: 64 from the
  // latent cache, 8 from the RoPE cache; dead and unmapped rows
  // zero-filled
  auto load_tile = [&](int t) {
    const uint32_t st = ring + (t & 1) * kTileBytes;
    const int p0 = t * kTile;
    for (int i = tid; i < kTile * kChunks; i += kSm90Threads) {
      const int r = i / kChunks, c = i % kChunks;
      const int row = s0 + p0 + r < s1 ? row_s[p0 + r] : -1;
      const bool ok = row >= 0;
      const __nv_bfloat16* src =
          c < kRChunks ? ckv + (size_t)row * kR + c * 8
                       : kr + (size_t)row * kDR + (c - kRChunks) * 8;
      sm90::cp_async_16(st + sm90::tile_off(kTile, r, c), ok ? src : ckv,
                        ok);
    }
  };
  load_tile(0);
  sm90::cp_async_commit();               // group 0: q and tile 0

  float o[kR / 4];                       // 64 heads x 256 columns
#pragma unroll
  for (int i = 0; i < kR / 4; ++i) o[i] = 0.f;
  // this thread's two heads (rows r, r + 8 of the 64): running max (log2
  // units) and the sum over its columns
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_t; ++t) {
    sm90::cp_async_wait<0>();            // tile t (and q) landed
    sm90::fence_proxy_async();
    __syncthreads();                     // ... for every thread; and
                                         // tile t-1's stage is free
    if (t + 1 < n_t) load_tile(t + 1);
    sm90::cp_async_commit();
    const uint32_t k_s = ring + (t & 1) * kTileBytes;

    // S = Q K^T (64 x kTile), K-major both, 36 k16 steps over 576
    float s[kTile / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk) {
      const uint32_t blk = kk / 4, off = (kk % 4) * 32;
      sm90::wgmma_ss<kTile, 0>(
          s, sm90::desc_sw128(q_s + blk * kHT * 128 + off, 16, 1024),
          sm90::desc_sw128(k_s + blk * kTile * 128 + off, 16, 1024),
          kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // scale after the sum; dead positions -inf (p = 0)
    const int t0 = s0 + t * kTile;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = t0 + 8 * j + 2 * (lane % 4) + e < s1;
        const float x0 = live ? s[4 * j + e] * sl2 : -INFINITY;
        const float x1 = live ? s[4 * j + 2 + e] * sl2 : -INFINITY;
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {      // the quad shares a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = sm90::fast_exp2(m0 - mn0);
    const float c1 = sm90::fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p in fp32 for l; rounded to bf16 once as the A fragment of P V:
    // k16 slice ks of S is registers 8 ks .. 8 ks + 7
    uint32_t pa[kTile / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 8 * ks + 2 * i;            // row r for i even
        const float mm = (i & 1) ? mn1 : mn0;
        const float p0 = sm90::fast_exp2(s[a] - mm);
        const float p1 = sm90::fast_exp2(s[a + 1] - mm);
        if (i & 1) ps1 += p0 + p1; else ps0 += p0 + p1;
        pa[ks][i] = sm90::pack_bf16(p0, p1);
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < kR / 16; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
    // O_half += P V_half: the latent columns of the same tile, read
    // MN-major (positions are K); the half's four 64-column blocks are
    // a block size apart
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const uint64_t db = sm90::desc_sw128(
          k_s + (wg * 4) * kTile * 128 + ks * 16 * 128, kTile * 128, 1024);
      sm90::wgmma_rs<256, 1>(o, pa[ks], db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) sm90::fence_regs(pa[ks]);
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const int h_a = h0 + warp * 16 + lane / 4, h_b = h_a + 8;
  float* pa_ = h_a < H ? part + part_off(b, h_a, H, split, splits) : nullptr;
  float* pb_ = h_b < H ? part + part_off(b, h_b, H, split, splits) : nullptr;
  const int col0 = wg * (kR / 2) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kR / 16; ++j) {
    if (pa_ != nullptr)
      *reinterpret_cast<float2*>(pa_ + col0 + 8 * j) =
          make_float2(o[4 * j], o[4 * j + 1]);
    if (pb_ != nullptr)
      *reinterpret_cast<float2*>(pb_ + col0 + 8 * j) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
  if (wg == 0 && lane % 4 == 0) {
    if (pa_ != nullptr) { pa_[kR] = m0; pa_[kR + 1] = l0; }
    if (pb_ != nullptr) { pb_[kR] = m1; pb_[kR + 1] = l1; }
  }
}

// One block per (head, sequence), 4 latent columns a thread: the live
// splits' partials merged in split order, then acc / max(l, 1e-30).
__global__ void __launch_bounds__(kR / 4)
mla_merge(const float* __restrict__ part, const int* __restrict__ lens,
          float* __restrict__ out, int H, int window, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x * 4;
  const int len = min(lens[b], window);
  const int n = len > 0 ? (len + kSplit - 1) / kSplit : 0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = 0.f, l = 0.f;
  if (n > 0) {
    const float* p = part + part_off(b, h, H, 0, splits);
    acc = *reinterpret_cast<const float4*>(p + c);
    m = p[kR];
    l = p[kR + 1];
  }
  for (int s = 1; s < n; ++s) {
    const float* p = part + part_off(b, h, H, s, splits);
    const float ms = p[kR];
    const float mn = fmaxf(m, ms);
    const float c0 = sm90::fast_exp2(m - mn), c1 = sm90::fast_exp2(ms - mn);
    const float4 a = *reinterpret_cast<const float4*>(p + c);
    acc.x = acc.x * c0 + a.x * c1;
    acc.y = acc.y * c0 + a.y * c1;
    acc.z = acc.z * c0 + a.z * c1;
    acc.w = acc.w * c0 + a.w * c1;
    l = l * c0 + p[kR + 1] * c1;
    m = mn;
  }
  const float lc = fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(out + ((size_t)b * H + h) * kR + c) =
      make_float4(acc.x / lc, acc.y / lc, acc.z / lc, acc.w / lc);
}

template <bool kPaged>
int launch_sm90(const void* qa, const void* qr, const void* ckv,
                const void* kr, const void* tables, const void* lens,
                void* out, float* part, int B, int H, int N, int bs, int MB,
                int splits, float scale, cudaStream_t s) {
  static bool smem_set[64] = {};
  cudaError_t err = sm90::allow_smem(mla_split_sm90<kPaged>, kSm90Smem,
                                     smem_set);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  mla_split_sm90<kPaged><<<dim3(splits, (H + kHT - 1) / kHT, B),
                           kSm90Threads, kSm90Smem, s>>>(
      (const bf*)qa, (const bf*)qr, (const bf*)ckv, (const bf*)kr,
      (const int*)tables, (const int*)lens, part, H, N, bs, MB, splits,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_merge<<<dim3(H, B), kR / 4, 0, s>>>(part, (const int*)lens,
                                          (float*)out, H, MB * bs, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError()
// after its launches (0 = cudaSuccess); a configuration the kernels do
// not take returns cudaErrorInvalidValue without launching.
//
// part: fp32 scratch of (B, H, splits, mla_decode_paged_part_len())
// for the bf16 kernel's partials, splits = ceil(S / split length)
// (mla_decode_paged_split_len); unused (may be null) in fp32. A bf16
// call with another number of splits, or no scratch, returns
// cudaErrorInvalidValue without launching.
extern "C" int mla_decode_fwd(const void* q_abs, const void* q_r,
                              const void* ckv, const void* kr,
                              const void* kv_len, void* out, void* part,
                              int B, int H, int R, int DR, int S, int splits,
                              float scale, int dtype, void* stream) {
  if (R != kR || DR != kDR || B <= 0 || H <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<false>(q_abs, q_r, ckv, kr, nullptr, kv_len, out, B, H,
                         S, 0, 0, scale, s);
  if (dtype == 1) {
    if (part == nullptr || splits != (S + kSplit - 1) / kSplit)
      return (int)cudaErrorInvalidValue;
    return launch_sm90<false>(q_abs, q_r, ckv, kr, nullptr, kv_len, out,
                              (float*)part, B, H, B, S, 1, splits, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// part: fp32 scratch of (B, H, splits, mla_decode_paged_part_len())
// for the bf16 kernel's partials, splits = ceil(MB * bs / split length)
// (mla_decode_paged_split_len); unused (may be null) in fp32. A bf16
// call with another number of splits, or no scratch, returns
// cudaErrorInvalidValue without launching.
extern "C" int mla_decode_paged_fwd(const void* q_abs, const void* q_r,
                                    const void* ckv_pool,
                                    const void* kr_pool, const void* tables,
                                    const void* kv_lens, void* out,
                                    void* part, int B, int H, int R, int DR,
                                    int N, int bs, int MB, int splits,
                                    float scale, int dtype, void* stream) {
  if (R != kR || DR != kDR || B <= 0 || H <= 0 || N <= 0 || bs <= 0 ||
      MB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<true>(q_abs, q_r, ckv_pool, kr_pool, tables, kv_lens,
                        out, B, H, N, bs, MB, scale, s);
  if (dtype == 1) {
    if (part == nullptr || splits != (MB * bs + kSplit - 1) / kSplit)
      return (int)cudaErrorInvalidValue;
    return launch_sm90<true>(q_abs, q_r, ckv_pool, kr_pool, tables, kv_lens,
                             out, (float*)part, B, H, N, bs, MB, splits,
                             scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Positions a split and a tile of the bf16 kernels (both caches): what
// mla_decode_split_plain and mla_decode_paged_split_plain model (SPLIT
// and TILE in kernels/mla_decode/mla_decode.py).
extern "C" int mla_decode_paged_split_len() { return kSplit; }
extern "C" int mla_decode_paged_tile() { return kTile; }
// Floats a partial of the bf16 kernels takes in their scratch, and the
// dynamic shared memory their split kernel asks for (bytes).
extern "C" int mla_decode_paged_part_len() { return kPart; }
extern "C" int mla_decode_paged_sm90_smem() { return kSm90Smem; }
