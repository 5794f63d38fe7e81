// Mamba2 SSD chunked scan from zero state for prefill, written for sm_90a.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, ssd_scan_pallas
//   (_ssd_kernel, pallas_call at :138).
//
// Computes, for x (B, S, H, P) and B/C (B, S, G, N) in T (fp32 or bf16),
//   dt (B, S, H), A (H,) and D (H,) (or null) in fp32, head h reading
//   group h / (H / G), chunks of Q = min(chunk_size, S) rows:
//     A_cum = inclusive cumsum over the chunk of dt * A
//     y_i   = sum_{j<=i} (C_i . B_j) exp(A_cum_i - A_cum_j) dt_j x_j
//             + exp(A_cum_i) C_i . state + D x_i
//     state = exp(A_cum_last) state
//             + sum_q exp(A_cum_last - A_cum_q) dt_q x_q B_q^T
//   with the fp32 (P, N) state carried from chunk to chunk, starting at
//   zero; y (B, S, H, P) in T, the final state (B, H, P, N) in fp32. A
//   ragged last chunk reads its rows past S as dt = x = B = C = 0: they
//   keep the state and add nothing, as the Pallas wrapper's padding
//   does (ssd_scan.py:113), and their y is not written. Held against
//   ref.py::ssd_chunked.
//
// What bounds it on the H100: at zamba2's prefill (B=4, S=1024, H=80,
//   P=64, N=64, Q=256, bf16) the work is ~16 GFLOP (the causal half of
//   the two (Q, Q) products, the state read and the state update), and
//   the bytes are ~92 MB (x and y 42 MB each, the final fp32 state 5 MB,
//   dt, B and C): ~170 operations a byte, under the card's ~295, so it
//   is bound by bytes at 3.35 TB/s (~27 us a layer).
//
// What this design does about it: this first version is the simple,
//   right one and does NOT reach that bound: it computes in fp32 on the
//   CUDA cores (no wgmma, no TMA), and it is one kernel (the GPU-style
//   split into chunk-state, state-passing and chunk-scan kernels, which
//   puts the chunks of one sequence on many SMs, is later speed work).
//   What it keeps from the TPU kernel: x, B, C and dt are read once, y
//   is written once, and no (Q, Q) matrix or per-chunk state reaches
//   device memory.
//   * On the TPU the chunk axis was the sequential grid axis, the state
//     in VMEM scratch. Blocks on the GPU run in no order, so one block
//     owns one (b, h, 32-column slice of P) and loops over the chunks
//     itself; its (32, N) state slice lives in shared memory. The P
//     rows of the state are independent, so slicing P gives
//     2 x 80 x 4 = 640 blocks at B=4 instead of 320; each slice
//     recomputes C_i . B_j.
//   * A chunk's B tile (Q, N) and dt x tile (Q, 32) are staged in
//     shared memory as fp32. Thread i owns chunk row i: C_i in 64
//     registers and 32 accumulators. It walks j = 0..i, so all lanes of
//     a warp read the same B_j and dt_j x_j (broadcasts, no bank
//     conflicts), and exp(A_cum_i - A_cum_j) is only ever taken with
//     j <= i, where the exponent is <= 0 (above the diagonal it is
//     positive and could overflow; the TPU kernel hides that behind
//     `where`).
//   * A_cum is a block scan: a warp shuffle scan, then the warp totals.
//   * The state update maps a thread to one state column n and 8 of
//     the 32 rows, summing over the chunk's rows in order.
//   * Shared memory: 109,696 bytes (B tile 64 KiB, dt x tile 32 KiB,
//     the state slice 8 KiB, A_cum, dt and decay rows), as dynamic
//     shared memory (opted in at each launch).
//   * Registers (ptxas -v, the card's nvcc): 167 a thread in both
//     instantiations, no spills. 167 x 256 threads leaves room for one
//     block an SM (the shared memory would take two), so zamba2's 640
//     blocks run in about five waves; capping the kernel at 128
//     registers for two blocks an SM is the first speed step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;    // one chunk row per thread: Q <= 256
constexpr int kMaxQ = kThreads;
constexpr int kN = 64;           // state dim the kernel is built for
constexpr int kPS = 32;          // P columns one block owns
constexpr int kRowsPerThread = kPS / (kThreads / kN);   // state update

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

constexpr size_t smem_floats() {
  return (size_t)kMaxQ * kN + (size_t)kMaxQ * kPS + 3 * kMaxQ + 32 +
         (size_t)kPS * kN;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ fin, int S, int H,
                int P, int G, int Q) {
  extern __shared__ float smem[];
  float (*b_s)[kN] = reinterpret_cast<float (*)[kN]>(smem);
  float (*dx_s)[kPS] = reinterpret_cast<float (*)[kPS]>(smem + kMaxQ * kN);
  float* acum_s = smem + kMaxQ * kN + kMaxQ * kPS;
  float* dt_s = acum_s + kMaxQ;
  float* w_s = dt_s + kMaxQ;             // exp(A_cum_last - A_cum_q)
  float* warp_tot = w_s + kMaxQ;         // 32 floats (one a warp)
  float (*st_s)[kN] = reinterpret_cast<float (*)[kN]>(warp_tot + 32);

  const int p0 = blockIdx.x * kPS, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a_h = A[h];
  const float d_h = D != nullptr ? D[h] : 0.f;

  for (int i = tid; i < kPS * kN; i += kThreads) st_s[i / kN][i % kN] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    __syncthreads();                     // last chunk's state update done

    // dt of this thread's row (rows past the chunk or past S: 0), and
    // the warp-level inclusive scan of dt * A
    float dtv = 0.f;
    if (tid < Q && t0 + tid < S)
      dtv = dt[((size_t)b * S + t0 + tid) * H + h];
    float v = dtv * a_h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    dt_s[tid] = dtv;
    for (int i = tid; i < Q * kN; i += kThreads) {
      const int r = i / kN, n = i % kN;
      float bv = 0.f;
      if (t0 + r < S) bv = to_f(Bm[(((size_t)b * S + t0 + r) * G + g) * kN + n]);
      b_s[r][n] = bv;
    }
    __syncthreads();                     // dt_s, warp totals

    for (int i = tid; i < Q * kPS; i += kThreads) {
      const int r = i / kPS, pp = i % kPS;
      float xv = 0.f;
      if (t0 + r < S) xv = to_f(x[(((size_t)b * S + t0 + r) * H + h) * P + p0 + pp]);
      dx_s[r][pp] = dt_s[r] * xv;
    }
    float off = 0.f;
    for (int w = 0; w < warp; ++w) off += warp_tot[w];
    acum_s[tid] = v + off;
    __syncthreads();                     // dx_s, acum_s

    const float a_last = acum_s[Q - 1];
    if (tid < Q) w_s[tid] = expf(a_last - acum_s[tid]);

    // y of chunk row i = tid: the carried state's term, the causal
    // intra-chunk sum (j <= i only), then D x
    const int i = tid;
    if (i < Q && t0 + i < S) {
      const size_t row = ((size_t)b * S + t0 + i);
      float c_r[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) c_r[n] = to_f(Cm[(row * G + g) * kN + n]);
      const float ai = acum_s[i];
      const float e_i = expf(ai);
      float acc[kPS];
#pragma unroll
      for (int p = 0; p < kPS; ++p) {
        float s = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) s = fmaf(c_r[n], st_s[p][n], s);
        acc[p] = e_i * s;
      }
      for (int j = 0; j <= i; ++j) {
        float s = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) s = fmaf(c_r[n], b_s[j][n], s);
        const float wgt = s * expf(ai - acum_s[j]);
#pragma unroll
        for (int p = 0; p < kPS; ++p) acc[p] = fmaf(wgt, dx_s[j][p], acc[p]);
      }
      const T* xr = x + (row * H + h) * P + p0;
      T* yr = y + (row * H + h) * P + p0;
#pragma unroll
      for (int p = 0; p < kPS; ++p)
        yr[p] = from_f<T>(acc[p] + d_h * to_f(xr[p]));
    }
    __syncthreads();                     // every row read the old state

    // state update: column n, rows pg*8 .. pg*8+7 of the slice
    {
      const int n = tid % kN, r0 = (tid / kN) * kRowsPerThread;
      float acc[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
      for (int q = 0; q < Q; ++q) {
        const float bw = b_s[q][n] * w_s[q];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r] = fmaf(bw, dx_s[q][r0 + r], acc[r]);
      }
      const float decay = expf(a_last);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        st_s[r0 + r][n] = fmaf(decay, st_s[r0 + r][n], acc[r]);
    }
  }
  __syncthreads();
  for (int i = tid; i < kPS * kN; i += kThreads) {
    const int p = i / kN, n = i % kN;
    fin[(((size_t)b * H + h) * P + p0 + p) * kN + n] = st_s[p][n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* fin, int B, int S,
           int H, int P, int G, int Q, cudaStream_t s) {
  const size_t smem = smem_floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(P / kPS, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)D, (T*)y, (float*)fin, S, H, P, G, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. D may be null.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess); a
// configuration the kernel is not built for returns
// cudaErrorInvalidValue without launching.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            void* y, void* fin, int B, int S, int H, int P,
                            int G, int N, int Q, int dtype, void* stream) {
  if (N != kN || P <= 0 || P % kPS != 0 || Q <= 0 || Q > kMaxQ || B <= 0 ||
      S <= 0 || G <= 0 || H <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, D, y, fin, B, S, H, P, G, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, fin, B, S, H, P,
                                 G, Q, s);
  return (int)cudaErrorInvalidValue;
}
