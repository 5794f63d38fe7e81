// Per-block int8 quantization and the fused dequantize-accumulate of the
// bucketed int8 gradient exchange, written for sm_90a. Built without
// fast math: both kernels must give the bits of their plain versions
// (kernels/quantize/ref.py) and of the JAX package.
//
// quantize_int8_fwd replaces: src/repro/kernels/quantize/quantize.py,
//   quantize_int8_pallas (_quant_kernel, pallas_call at :73), the send
//   side of the exchange and the re-quantize of the shard sum. For x
//   (rows, 256) fp32 and optional noise (rows, 256) fp32 in [0, 1) it
//   writes, per row (block),
//     scale = max(absmax / 127, 1e-12)            (IEEE division)
//     q     = clip(rint(x / scale [+ (noise - 0.5)]), -127, 127)
//   in that order of operations: division and not a product with the
//   reciprocal, round half to even, no fused multiply-add. q (rows, 256)
//   int8, s (rows,) fp32.
//   Bound on this card: bytes (4 read + 1 + 4/256 written per element,
//   a handful of operations each). A warp owns a row: each lane reads
//   two float4 (elements 4l..4l+3 and 128+4l..128+4l+3, so each load
//   instruction of the warp is one contiguous 512-byte span), the absmax
//   is a shuffle reduction, and each lane stores two char4. The TPU
//   kernel tiled 256 rows into VMEM; here eight rows (eight warps) make a
//   block and the grid covers the rows, with no shared memory.
//
// dequant_accum_fwd replaces: quantize.py, dequant_accum_pallas
//   (_dequant_accum_kernel, pallas_call at :127), the receive side. For
//   q (R, rows, 256) int8 and s (R, rows) fp32 it writes
//     out = sum_{r = 0..R-1} q[r] * s[r]          (rows, 256) fp32,
//   accumulated from 0 in rank order, one rounded product and one
//   rounded sum per rank. The TPU unrolled the (static) rank loop; here
//   R is a runtime argument. Bound: bytes (R (1 + 4/256) read + 4
//   written per output element). A thread owns four consecutive outputs:
//   one char4 load per rank, one float4 store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;          // elements per quantization block
constexpr int kRowsPerCta = 8;       // one warp per row

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
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  float v[8];
  {
    const float4 a = x4[lane];
    const float4 b = x4[lane + 32];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float scale = __fdiv_rn(m, 127.0f);
  scale = fmaxf(scale, 1e-12f);
  float n[8];
  if (noise != nullptr) {
    const float4* n4 = reinterpret_cast<const float4*>(noise + base);
    const float4 a = n4[lane];
    const float4 b = n4[lane + 32];
    n[0] = a.x; n[1] = a.y; n[2] = a.z; n[3] = a.w;
    n[4] = b.x; n[5] = b.y; n[6] = b.z; n[7] = b.w;
  }
  int8_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float t = __fdiv_rn(v[i], scale);
    if (noise != nullptr) t = __fadd_rn(t, __fsub_rn(n[i], 0.5f));
    t = rintf(t);
    t = fminf(fmaxf(t, -127.0f), 127.0f);
    c[i] = (int8_t)(int)t;
  }
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

}  // namespace

// x (rows, 256) fp32, noise (rows, 256) fp32 or null; q (rows, 256) int8,
// s (rows,) fp32. All 16-byte aligned (fresh PyTorch allocations).
extern "C" int quantize_int8_fwd(const void* x, const void* noise, void* q,
                                 void* s, long long rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quantize_int8_kernel<<<(unsigned)grid, kRowsPerCta * 32, 0,
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
