// The bucketed int8 gradient exchange's kernels, written for sm_90a. Built
// without fast math: every kernel gives the bits of its plain version
// (kernels/quantize/ref.py) and the codes, scales and wire bytes of the
// JAX package.
//
// Two kernels keep the TPU kernels' own contract (compression.compress_leaf
// and the card tests call them):
//
// quantize_int8_fwd replaces: src/repro/kernels/quantize/quantize.py,
//   quantize_int8_pallas (_quant_kernel, pallas_call at :73). For x
//   (rows, 256) fp32 and optional noise (rows, 256) fp32 in [0, 1) it
//   writes, per row (block),
//     scale = max(absmax / 127, 1e-12)            (IEEE division)
//     q     = clip(rint(x / scale [+ (noise - 0.5)]), -127, 127)
//   in that order of operations: division and not a product with the
//   reciprocal, round half to even, no fused multiply-add. q (rows, 256)
//   int8, s (rows,) fp32. A warp owns a row: each lane reads two float4
//   (elements 4l..4l+3 and 128+4l..128+4l+3, so each load instruction of
//   the warp is one contiguous 512-byte span), the absmax is a shuffle
//   reduction.
//
// dequant_accum_fwd replaces: quantize.py, dequant_accum_pallas
//   (_dequant_accum_kernel, pallas_call at :127). For q (R, rows, 256)
//   int8 and s (R, rows) fp32 it writes out = sum_r q[r] * s[r] (rows,
//   256) fp32, accumulated from 0 in rank order, one rounded product and
//   one rounded sum per rank.
//
// The exchange itself (core/buckets.py) runs three fused legs, one launch
// each, which read and write the wire format directly: a wire row is a
// block's 256 codes followed by its scale's 4 bytes (compression.py's
// fuse_payload, 260 bytes). An exchange chunk x is (nbc, p, shard) fp32 over
// p ranks, ns = shard / 256 blocks a shard; its stream row (k, j, b) is
// block b of rank j's slot of bucket k, and the data rows (stream row <
// d_rows) are a prefix of the stream. Message j (to rank j) holds the data
// rows (k, j, b) in (k, b) order, lens[j] of them, and the wire is the
// messages in rank order: row (k, j, b) at prefix(lens)[j] + k ns + b.
//
// exchange_send_int8 (kernel 4's fused form, the send leg): per data row,
//   corrected = x + e, its scale and codes as quantize_int8_fwd computes
//   them, the stage-1 residual e = corrected - q s (rounded product, then
//   rounded difference: no fused multiply-add) and the wire row; e's
//   padding rows (stream row >= d_rows) zeroed. x is not written: the
//   decode leg overwrites all of it. Moves 4 (x) + 4 (e) + 4 (e) + 260/256
//   (wire) = 13.0 bytes an element (17.0 with noise), where the legs as
//   PyTorch passes moved ~49.
// exchange_receive_int8 (kernel 5's fused form, the receive leg): for the
//   received messages rx (p, L, 260), L = lens[me], per row the sum over
//   ranks in rank order as dequant_accum_fwd computes it, its re-quantize
//   (no noise), the stage-2 residual added into my slot of e in three
//   roundings, e + (sum - q2 s2), and the row's 260 bytes written p times
//   (the gather leg's input, one copy a rank). Moves p 260/256 (rx) + 4 + 4
//   (my slot of e) + p 260/256 (out) bytes an element of my shard: 6.0 an
//   element of the chunk at p = 2.
// exchange_decode_int8 (kernel 5 at one rank, the decode): for the gathered
//   wire (sum lens, 260), x's row (k, j, b) = q s where k ns + b < lens[j],
//   0 past it, over every slot in one launch. Moves 260/256 + 4 = 5.0
//   bytes an element.
//
// What bounds the legs on the H100: bytes, at a handful of operations an
// element (3.35 TB/s: 1.9 ms for the three legs over one 40-bucket chunk
// of olmo-1b at p = 2, 0.05 ms over one 25-MiB bucket). The design keeps
// every intermediate in registers and shared memory. A warp owns a block
// (its fp32 rows are 1 KB and 16-byte aligned: float4 loads and stores
// straight from device memory); a block of 8 warps owns 8 consecutive rows
// of the wire. A wire row is 260 bytes, so its start is only 4-byte
// aligned, but 8 rows (2080 bytes) are a multiple of 16: the block stages
// its rows in shared memory and moves the span with 16-byte accesses (4-byte
// ones only for the ends of a span that does not start or end on 16 bytes:
// a received message starts wherever the one before it ended). The grid is
// persistent, the SMs times the blocks an SM holds, each block striding
// over the 8-row groups, so no partial last wave; the x, e and noise loads
// of a row are all issued before its absmax shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;          // elements per quantization block
constexpr int kRowBytes = kBlock + 4;  // a wire row: codes, scale bytes
constexpr int kRowsPerCta = 8;       // one warp per row
constexpr int kThreads = kRowsPerCta * 32;
constexpr int kSpan = kRowsPerCta * kRowBytes;   // 2080: 16-byte multiple
constexpr int kMaxRanks = 64;
constexpr int kRankBatch = 8;        // receive: rank spans staged at once

// where each message starts in the wire, then its end (lens' prefix)
struct Prefix {
  long long at[kMaxRanks + 1];
};

__device__ __forceinline__ void load8(const float* row, int lane,
                                      float (&v)[8]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 a = r4[lane];
  const float4 b = r4[lane + 32];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* row, int lane,
                                       const float (&v)[8]) {
  float4* r4 = reinterpret_cast<float4*>(row);
  r4[lane] = make_float4(v[0], v[1], v[2], v[3]);
  r4[lane + 32] = make_float4(v[4], v[5], v[6], v[7]);
}

// kernel 4's arithmetic on a warp's row (lane l holds elements 4l..4l+3
// and 128+4l..128+4l+3): the scale by a shuffle absmax, then the codes
__device__ __forceinline__ float quantize8(const float (&v)[8],
                                           const float (&n)[8], bool noisy,
                                           int8_t (&c)[8]) {
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float scale = __fdiv_rn(m, 127.0f);
  scale = fmaxf(scale, 1e-12f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float t = __fdiv_rn(v[i], scale);
    if (noisy) t = __fadd_rn(t, __fsub_rn(n[i], 0.5f));
    t = rintf(t);
    t = fminf(fmaxf(t, -127.0f), 127.0f);
    c[i] = (int8_t)(int)t;
  }
  return scale;
}

// a warp's wire row into shared memory at ``row`` (4-byte aligned)
__device__ __forceinline__ void put_row(char* row, int lane,
                                        const int8_t (&c)[8], float scale) {
  *reinterpret_cast<char4*>(row + 4 * lane) =
      make_char4(c[0], c[1], c[2], c[3]);
  *reinterpret_cast<char4*>(row + 128 + 4 * lane) =
      make_char4(c[4], c[5], c[6], c[7]);
  if (lane == 0) *reinterpret_cast<float*>(row + kBlock) = scale;
}

// a wire row's codes (this lane's 8) and scale from shared memory
__device__ __forceinline__ float get_row(const char* row, int lane,
                                         float (&c)[8]) {
  const char4 a = *reinterpret_cast<const char4*>(row + 4 * lane);
  const char4 b = *reinterpret_cast<const char4*>(row + 128 + 4 * lane);
  c[0] = (float)a.x; c[1] = (float)a.y; c[2] = (float)a.z; c[3] = (float)a.w;
  c[4] = (float)b.x; c[5] = (float)b.y; c[6] = (float)b.z; c[7] = (float)b.w;
  return *reinterpret_cast<const float*>(row + kBlock);
}

__device__ __forceinline__ int misalign(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Copies bytes [shift, shift + n) from src to dst, two 16-byte aligned
// bases (one in device memory, one a shared buffer of shift + n bytes or
// more; shift and n multiples of 4): 16 bytes an access where an aligned
// chunk lies inside the span, 4 at its ends. Every thread of the block
// takes part. A span at global address a sits at shift misalign(a) of
// its shared copy, so the two agree mod 16.
__device__ __forceinline__ void copy_span(char* dst, const char* src,
                                          int shift, int n) {
  const int end = shift + n;
  for (int c = threadIdx.x; c < (end + 15) >> 4; c += blockDim.x) {
    const int lo = c << 4;
    if (lo >= shift && lo + 16 <= end) {
      *reinterpret_cast<uint4*>(dst + lo) =
          *reinterpret_cast<const uint4*>(src + lo);
    } else {
      for (int w = max(lo, shift); w < min(lo + 16, end); w += 4)
        *reinterpret_cast<uint32_t*>(dst + w) =
            *reinterpret_cast<const uint32_t*>(src + w);
    }
  }
}

// n bytes at src into the shared buffer dst (at dst + misalign(src))
__device__ __forceinline__ void span_load(const int8_t* src, int n,
                                          char* dst) {
  const int shift = misalign(src);
  copy_span(dst, reinterpret_cast<const char*>(src) - shift, shift, n);
}

// n bytes from the shared buffer src (at src + misalign(dst)) to dst
__device__ __forceinline__ void span_store(int8_t* dst, int n,
                                           const char* src) {
  const int shift = misalign(dst);
  copy_span(reinterpret_cast<char*>(dst) - shift, src, shift, n);
}

// The stream row of wire row w: (k, j, b) with w = pre[j] + k ns + b.
__device__ __forceinline__ long long stream_row(long long w, int p,
                                                long long ns,
                                                const Prefix& pre) {
  int j = 0;
  while (w >= pre.at[j + 1]) ++j;
  const long long t = w - pre.at[j];
  return ((t / ns) * p + j) * ns + t % ns;
}

__global__ void quantize_int8_kernel(const float* __restrict__ x,
                                     const float* __restrict__ noise,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ s,
                                     long long rows) {
  const long long row =
      (long long)blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long base = row * kBlock;
  float v[8], n[8];
  load8(x + base, lane, v);
  if (noise != nullptr) load8(noise + base, lane, n);
  int8_t c[8];
  const float scale = quantize8(v, n, noise != nullptr, c);
  char4* q4 = reinterpret_cast<char4*>(q + base);
  q4[lane] = make_char4(c[0], c[1], c[2], c[3]);
  q4[lane + 32] = make_char4(c[4], c[5], c[6], c[7]);
  if (lane == 0) s[row] = scale;
}

__global__ void dequant_accum_kernel(const int8_t* __restrict__ q,
                                     const float* __restrict__ s,
                                     float* __restrict__ out, int ranks,
                                     long long rows) {
  const long long quads = rows * (kBlock / 4);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const long long row = i / (kBlock / 4);
  const char4* q4 = reinterpret_cast<const char4*>(q);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = 0; r < ranks; ++r) {
    const char4 c = q4[(long long)r * quads + i];
    const float sc = s[(long long)r * rows + row];
    acc.x = __fadd_rn(acc.x, __fmul_rn((float)c.x, sc));
    acc.y = __fadd_rn(acc.y, __fmul_rn((float)c.y, sc));
    acc.z = __fadd_rn(acc.z, __fmul_rn((float)c.z, sc));
    acc.w = __fadd_rn(acc.w, __fmul_rn((float)c.w, sc));
  }
  reinterpret_cast<float4*>(out)[i] = acc;
}

// The send leg. Items: the wire's 8-row groups, then (with e) 8-row groups
// of e's padding rows.
__global__ void __launch_bounds__(kThreads) exchange_send_kernel(
    const float* __restrict__ x, float* __restrict__ e,
    const float* __restrict__ noise, int8_t* __restrict__ wire,
    long long rows, long long d_rows, int p, long long ns, Prefix pre) {
  __shared__ __align__(16) char stage[kSpan + 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long groups = (d_rows + kRowsPerCta - 1) / kRowsPerCta;
  const long long items =
      groups + (e != nullptr
                    ? (rows - d_rows + kRowsPerCta - 1) / kRowsPerCta : 0);
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    if (it >= groups) {                       // e's padding rows: zero
      const long long r = d_rows + (it - groups) * kRowsPerCta + warp;
      const float z[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (r < rows) store8(e + r * kBlock, lane, z);
      continue;
    }
    const long long w0 = it * kRowsPerCta;
    const int n = (int)min((long long)kRowsPerCta, d_rows - w0);
    int8_t* dst = wire + w0 * kRowBytes;
    if (warp < n) {
      const long long r = stream_row(w0 + warp, p, ns, pre) * kBlock;
      float v[8], ev[8], nv[8];
      load8(x + r, lane, v);
      if (e != nullptr) load8(e + r, lane, ev);
      if (noise != nullptr) load8(noise + r, lane, nv);
      if (e != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], ev[i]);
      }
      int8_t c[8];
      const float scale = quantize8(v, nv, noise != nullptr, c);
      if (e != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ev[i] = __fsub_rn(v[i], __fmul_rn((float)c[i], scale));
        store8(e + r, lane, ev);
      }
      put_row(stage + misalign(dst) + warp * kRowBytes, lane, c, scale);
    }
    __syncthreads();
    span_store(dst, n * kRowBytes, stage);
    __syncthreads();
  }
}

// The receive leg. Items: 8-row groups of my shard's L rows.
__global__ void __launch_bounds__(kThreads) exchange_receive_kernel(
    const int8_t* __restrict__ rx, int8_t* __restrict__ out,
    float* __restrict__ e, long long L, int p, int me, long long ns) {
  __shared__ __align__(16) char in[kRankBatch][kSpan + 16];
  // the re-quantized rows at each 4-byte offset mod 16 (a copy's span
  // starts at any of them)
  __shared__ __align__(16) char staged[4][kSpan + 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long groups = (L + kRowsPerCta - 1) / kRowsPerCta;
  for (long long it = blockIdx.x; it < groups; it += gridDim.x) {
    const long long i0 = it * kRowsPerCta;
    const int n = (int)min((long long)kRowsPerCta, L - i0);
    const bool mine = warp < n;
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int r0 = 0; r0 < p; r0 += kRankBatch) {
      const int rb = min(kRankBatch, p - r0);
      for (int r = 0; r < rb; ++r)
        span_load(rx + ((long long)(r0 + r) * L + i0) * kRowBytes,
                  n * kRowBytes, in[r]);
      __syncthreads();
      if (mine) {
        for (int r = 0; r < rb; ++r) {        // rank order
          const int8_t* src = rx + ((long long)(r0 + r) * L + i0) * kRowBytes;
          float c[8];
          const float sc = get_row(in[r] + misalign(src) + warp * kRowBytes,
                                   lane, c);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            acc[k] = __fadd_rn(acc[k], __fmul_rn(c[k], sc));
        }
      }
      __syncthreads();
    }
    if (mine) {
      // my slot's error row, loaded before the absmax shuffles (held
      // across the rank loop it spilled)
      const long long i = i0 + warp;
      const long long er = ((i / ns) * p + me) * ns + i % ns;
      float ev[8];
      if (e != nullptr) load8(e + er * kBlock, lane, ev);
      int8_t c[8];
      const float scale = quantize8(acc, acc, false, c);
      if (e != nullptr) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          ev[k] = __fadd_rn(ev[k], __fsub_rn(
              acc[k], __fmul_rn((float)c[k], scale)));
        store8(e + er * kBlock, lane, ev);
      }
#pragma unroll
      for (int sh = 0; sh < 4; ++sh)
        put_row(staged[sh] + 4 * sh + warp * kRowBytes, lane, c, scale);
    }
    __syncthreads();
    for (int r = 0; r < p; ++r) {
      int8_t* dst = out + ((long long)r * L + i0) * kRowBytes;
      span_store(dst, n * kRowBytes, staged[misalign(dst) >> 2]);
    }
    __syncthreads();
  }
}

// The decode. Items: the gathered wire's 8-row groups, then 8-row groups
// of the slots' rows past their message (zeros).
__global__ void __launch_bounds__(kThreads) exchange_decode_kernel(
    const int8_t* __restrict__ g, float* __restrict__ x, long long rows_in,
    int p, long long ns, long long per_slot, Prefix pre) {
  __shared__ __align__(16) char in[kSpan + 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long groups = (rows_in + kRowsPerCta - 1) / kRowsPerCta;
  const long long pads = (long long)p * per_slot - rows_in;
  const long long items = groups + (pads + kRowsPerCta - 1) / kRowsPerCta;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    if (it >= groups) {
      // pad z of the slots in rank order: slot j's rows lens[j].. end,
      // and j * per_slot - pre[j] pads come before slot j's
      const long long z = (it - groups) * kRowsPerCta + warp;
      if (z < pads) {
        int j = 0;
        while ((j + 1) * per_slot - pre.at[j + 1] <= z) ++j;
        const long long t =
            pre.at[j + 1] - pre.at[j] + z - (j * per_slot - pre.at[j]);
        const float zero[8] = {0.0f, 0.0f, 0.0f, 0.0f,
                               0.0f, 0.0f, 0.0f, 0.0f};
        store8(x + (((t / ns) * p + j) * ns + t % ns) * kBlock, lane, zero);
      }
      continue;
    }
    const long long w0 = it * kRowsPerCta;
    const int n = (int)min((long long)kRowsPerCta, rows_in - w0);
    const int8_t* src = g + w0 * kRowBytes;
    span_load(src, n * kRowBytes, in);
    __syncthreads();
    if (warp < n) {
      float c[8];
      const float sc = get_row(in + misalign(src) + warp * kRowBytes, lane,
                               c);
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = __fmul_rn(c[k], sc);
      store8(x + stream_row(w0 + warp, p, ns, pre) * kBlock, lane, c);
    }
    __syncthreads();
  }
}

// Blocks for a persistent launch of ``kernel`` over ``items`` items: the
// SMs times the blocks an SM holds (computed once a kernel), at most one
// an item. 0 on an error of the runtime (returned in *err).
template <typename Kernel>
long long persistent_grid(Kernel kernel, long long items, int* slot,
                          int* err) {
  if (*slot == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess || sms * per_sm <= 0) {
      *err = e != cudaSuccess ? (int)e : (int)cudaErrorInvalidConfiguration;
      return 0;
    }
    *slot = sms * per_sm;
  }
  return items < *slot ? items : *slot;
}

int prefix_of(const long long* lens, int p, Prefix* pre) {
  pre->at[0] = 0;
  for (int j = 0; j < p; ++j) {
    if (lens[j] < 0) return (int)cudaErrorInvalidValue;
    pre->at[j + 1] = pre->at[j] + lens[j];
  }
  return 0;
}

int send_grid = 0, receive_grid = 0, decode_grid = 0;

}  // namespace

// x (rows, 256) fp32, noise (rows, 256) fp32 or null; q (rows, 256) int8,
// s (rows,) fp32. All 16-byte aligned (fresh PyTorch allocations).
extern "C" int quantize_int8_fwd(const void* x, const void* noise, void* q,
                                 void* s, long long rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quantize_int8_kernel<<<(unsigned)grid, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)x, (const float*)noise, (int8_t*)q, (float*)s, rows);
  return (int)cudaGetLastError();
}

// q (ranks, rows, 256) int8, s (ranks, rows) fp32; out (rows, 256) fp32.
extern "C" int dequant_accum_fwd(const void* q, const void* s, void* out,
                                 int ranks, long long rows, void* stream) {
  if (rows <= 0 || ranks <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long grid = (rows * (kBlock / 4) + threads - 1) / threads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dequant_accum_kernel<<<(unsigned)grid, threads, 0,
                         (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)s, (float*)out, ranks, rows);
  return (int)cudaGetLastError();
}

// The send leg of a chunk x (rows = nbc p ns blocks of 256) fp32, e (same)
// or null, noise (same) or null; lens (p entries, host memory) the data
// rows of each message, summing to d_rows; wire (d_rows, 260) int8. x, e,
// noise and wire 16-byte aligned.
extern "C" int exchange_send_int8(const void* x, void* e, const void* noise,
                                  void* wire, long long rows,
                                  long long d_rows, int p, long long ns,
                                  const long long* lens, void* stream) {
  Prefix pre;
  if (p < 1 || p > kMaxRanks || ns <= 0 || rows != rows / (p * ns) * p * ns
      || d_rows < 0 || d_rows > rows || prefix_of(lens, p, &pre) != 0
      || pre.at[p] != d_rows)
    return (int)cudaErrorInvalidValue;
  const long long items =
      (d_rows + kRowsPerCta - 1) / kRowsPerCta
      + (e != nullptr ? (rows - d_rows + kRowsPerCta - 1) / kRowsPerCta : 0);
  if (items == 0) return 0;
  int err = 0;
  const long long grid =
      persistent_grid(exchange_send_kernel, items, &send_grid, &err);
  if (grid == 0) return err;
  exchange_send_kernel<<<(unsigned)grid, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)x, (float*)e, (const float*)noise, (int8_t*)wire, rows,
      d_rows, p, ns, pre);
  return (int)cudaGetLastError();
}

// The receive leg: rx (p, L, 260) int8, the messages from each rank;
// out (p, L, 260) int8; e (nbc, p, ns, 256) fp32 or null, my slot me
// updated (L <= nbc ns rows of it). rx and out 16-byte aligned.
extern "C" int exchange_receive_int8(const void* rx, void* out, void* e,
                                     long long L, int p, int me,
                                     long long ns, void* stream) {
  if (p < 1 || p > kMaxRanks || me < 0 || me >= p || ns <= 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  const long long items = (L + kRowsPerCta - 1) / kRowsPerCta;
  if (items == 0) return 0;
  int err = 0;
  const long long grid =
      persistent_grid(exchange_receive_kernel, items, &receive_grid, &err);
  if (grid == 0) return err;
  exchange_receive_kernel<<<(unsigned)grid, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int8_t*)rx, (int8_t*)out, (float*)e, L, p, me, ns);
  return (int)cudaGetLastError();
}

// The decode: g (sum lens, 260) int8, the gathered messages; x (nbc, p,
// ns, 256) fp32, every row written. lens (p entries, host memory), each
// at most nbc ns. g and x 16-byte aligned.
extern "C" int exchange_decode_int8(const void* g, void* x, long long nbc,
                                    int p, long long ns,
                                    const long long* lens, void* stream) {
  Prefix pre;
  if (p < 1 || p > kMaxRanks || ns <= 0 || nbc <= 0
      || prefix_of(lens, p, &pre) != 0)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < p; ++j)
    if (lens[j] > nbc * ns) return (int)cudaErrorInvalidValue;
  const long long rows_in = pre.at[p];
  const long long items =
      (rows_in + kRowsPerCta - 1) / kRowsPerCta
      + (p * nbc * ns - rows_in + kRowsPerCta - 1) / kRowsPerCta;
  int err = 0;
  const long long grid =
      persistent_grid(exchange_decode_kernel, items, &decode_grid, &err);
  if (grid == 0) return err;
  exchange_decode_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int8_t*)g, (float*)x, rows_in, p, ns, nbc * ns, pre);
  return (int)cudaGetLastError();
}
