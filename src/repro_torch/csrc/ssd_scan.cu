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
//   does (ssd_scan.py:113), and their y is not written. N = 64, P a
//   multiple of 32, Q <= 256. Held against ref.py::ssd_chunked.
//
// What bounds it on the H100: at zamba2's prefill (B=4, S=1024, H=80,
//   P=64, N=64, Q=256, bf16) the work is ~16 GFLOP (the causal half of
//   the two (Q, Q) products, the state read and the state update), and
//   the bytes are ~92 MB (x and y 42 MB each, the final fp32 state 5 MB,
//   dt, B and C): ~170 operations a byte, under the card's ~295, so it
//   is bound by bytes at 3.35 TB/s (~27 us a layer).
//
// Two designs, by dtype (ssd_scan_fwd dispatches; there is no other
// switch):
//
// bf16: the GPU form of SSD on the tensor cores, three kernels in order
//   on one stream (one wrapper call):
//   1. Chunk state, grid (chunks x P slices of 64, H, B), one warpgroup:
//      the chunk's A_cum as a block scan (written to the scratch for the
//      other two), and the chunk's own state from zero, S_c (P x N) =
//      x^T (w dt B), w = exp(A_last - A_cum), over the chunk's 64-row
//      pieces through a 2-stage cp.async ring (52 KB, four blocks an
//      SM): x (bf16, exact) is the A operand read MN-major through its
//      transpose bit, the fp32 weighted B the B operand as a bf16 pair
//      hi = bf16(v), lo = bf16(v - hi) (two products into one fp32
//      accumulator).
//   2. State passing, grid (P N / 1024, H, B): state_in[0] = 0,
//      state_in[c + 1] = exp(A_last[c]) state_in[c] + S_c in chunk
//      order, fp32 on the CUDA cores (4 elements a thread, the loads of
//      4 chunks ahead of their updates), each chunk's state_in written
//      over its S_c, the final state to its output.
//   3. Chunk scan, grid (64-row tiles of a chunk x P slices, chunks,
//      B H), one warpgroup a tile, the heaviest tiles first; the (B_j,
//      x_j) tiles go through a 2-stage cp.async ring (59 KB, three
//      blocks an SM):
//      y = exp(A_i) (C_i state_in^T) with the state as a bf16 pair of
//      K-major tiles, then for each 64-row tile j at or below i's, in
//      order, G = C_i B_j^T (exact bf16 operands), M = G exp(A_i - A_j)
//      dt_j on the fp32 fragment (0 above the diagonal, set before the
//      exponent, which is positive there), M as a bf16 pair from
//      registers times x_j (MN-major); + D x_i in fp32; y rounded once,
//      staged in shared memory and written by 16-byte rows.
//   One bf16 rounding of those three fp32 operands would read ~1.5e-3
//   relative L2 on y, TF32 ~5e-4 (tests/test_torch_sm90_numerics.py),
//   over the limit of 4e-4; the pairs read ~6e-5. Rows past S or past Q
//   are zero-filled by the 16-byte cp.async loads; dt = 0 there, so
//   they add nothing and keep A_cum flat. No float atomics: every sum
//   has a fixed order, and two runs give equal bits. The scratch holds
//   the per-chunk states (B H nc P N fp32, ~21 MB of writes and reads at
//   zamba2's shape) and A_cum (B H nc Q fp32).
//
// fp32: the first, CUDA-core version (wgmma has no fp32 operands; the
//   zamba2 fp32 gate rests on it), one kernel:
//   * One block owns one (b, h, 32-column slice of P) and loops over the
//     chunks itself; its (32, N) state slice lives in shared memory (the
//     TPU kernel's sequential chunk axis). A chunk's B tile and dt x tile
//     are staged in shared memory as fp32; thread i owns chunk row i (C_i
//     in registers, 32 accumulators) and walks j = 0..i, so
//     exp(A_cum_i - A_cum_j) is only taken where its exponent is <= 0.
//   * A_cum is a block scan; the state update maps a thread to one state
//     column n and 8 of the 32 rows, summing over the chunk in order.
//   * 167 registers and 109,696 bytes of shared memory: one block an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;    // one chunk row per thread: Q <= 256
constexpr int kMaxQ = kThreads;
constexpr int kN = 64;           // state dim the kernel is built for
constexpr int kPS = 32;          // P columns one block owns
constexpr int kRowsPerThread = kPS / (kThreads / kN);   // state update

// (the CUDA-core kernel is built for fp32 only: bf16 takes the
// tensor-core kernels below)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* fin, int B, int S,
           int H, int P, int G, int Q, cudaStream_t s) {
  static bool smem_set[64] = {};
  const int smem = (int)(smem_floats() * sizeof(float));
  cudaError_t err = sm90::allow_smem(ssd_scan_kernel<float>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(P / kPS, H, B);
  ssd_scan_kernel<float><<<grid, kThreads, smem, s>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)D, (float*)y, (float*)fin, S, H, P, G,
      Q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16: tensor cores (wgmma), chunk states / state passing / chunk scan
// ---------------------------------------------------------------------

constexpr int kRowTile = 64;     // rows a tile of the chunk scan
constexpr int kPTile = 64;       // columns of P a block takes
constexpr int kWg = 128;         // one warpgroup
constexpr int kRTBytes = kRowTile * 128;       // 64 rows x 64 bf16
// a 2-stage ring of 64-row pieces (x, the weighted B's hi over B, its
// lo); A_cum, w; warp totals; 1 KB to align: 52 KB, four blocks an SM
constexpr int kStateSmem = 2 * 3 * kRTBytes + 2 * kMaxQ * 4 + 16 + 1024;
// a 2-stage ring of (B_j, x_j) tiles, C_i, the state's hi and lo tiles,
// A_cum and dt rows; 1 KB to align: 59 KB, three blocks an SM
constexpr int kScanSmem = 2 * 2 * kRTBytes + 3 * kRTBytes + 2 * kMaxQ * 4 +
                          1024;

__device__ __forceinline__ size_t bh_chunk(int b, int h, int H, int c,
                                           int nc) {
  return ((size_t)b * H + h) * nc + c;
}

// 1. the chunk's A_cum (to the scratch) and its state from zero, S_c,
// over the chunk's 64-row pieces through a 2-stage ring
__global__ void __launch_bounds__(kWg)
ssd_chunk_state_sm90(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const __nv_bfloat16* __restrict__ Bm,
                     float* __restrict__ states, float* __restrict__ acum_g,
                     int S, int H, int P, int G, int Q, int nc) {
  constexpr int kStage = 3 * kRTBytes;         // x, B (then hi), lo
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* acum_s = reinterpret_cast<float*>(gbase + 2 * kStage);
  float* w_s = acum_s + kMaxQ;
  float* tot_s = w_s + kMaxQ;                  // the 4 warps' totals

  const int n_ps = (P + kPTile - 1) / kPTile;
  const int c = blockIdx.x / n_ps, ps = blockIdx.x % n_ps;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int p0 = ps * kPTile, pc = min(kPTile, P - p0) / 8;
  const size_t row0 = (size_t)b * S + t0;
  const int n_pc = (rows + kRowTile - 1) / kRowTile;   // live pieces

  // piece k's x and B rows into stage k % 2 (zero past `rows`)
  auto load_piece = [&](int k) {
    const uint32_t st = base + (k & 1) * kStage;
    const int r0 = k * kRowTile;
    sm90::load_rows<kRowTile, 8, kWg>(
        st, x + (row0 + r0) * H * P + (size_t)h * P + p0, (size_t)H * P,
        rows - r0, pc, tid);
    sm90::load_rows<kRowTile, 8, kWg>(
        st + kRTBytes, Bm + ((row0 + r0) * G + g) * kN, (size_t)G * kN,
        rows - r0, 8, tid);
  };
  load_piece(0);
  sm90::cp_async_commit();

  // A_cum: thread t owns rows 2t, 2t + 1; rows past the chunk or S have
  // dt = 0
  const float a_h = A[h];
  const int r0 = 2 * tid;
  const float d0 = r0 < rows ? dt[(row0 + r0) * H + h] : 0.f;
  const float d1 = r0 + 1 < rows ? dt[(row0 + r0 + 1) * H + h] : 0.f;
  const float v0 = d0 * a_h, v1 = d1 * a_h;
  float incl = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) tot_s[warp] = incl;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += tot_s[w];
  const float a0 = (off + excl) + v0, a1 = a0 + v1;
  acum_s[r0] = a0;
  acum_s[r0 + 1] = a1;
  __syncthreads();
  const float a_last = acum_s[Q - 1];
  if (ps == 0) {
    float* ag = acum_g + bh_chunk(b, h, H, c, nc) * Q;
    if (r0 < Q) ag[r0] = a0;
    if (r0 + 1 < Q) ag[r0 + 1] = a1;
  }
  w_s[r0] = __expf(a_last - a0) * d0;
  w_s[r0 + 1] = __expf(a_last - a1) * d1;

  // S_c (P slice x N) += x^T Bw piece by piece: both operands MN-major
  // (rows are q), the weighted B as hi + lo
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int k = 0; k < n_pc; ++k) {
    sm90::cp_async_wait<0>();                  // piece k landed
    __syncthreads();                           // ... for every thread; w;
                                               // stage k-1 is free
    if (k + 1 < n_pc) load_piece(k + 1);
    sm90::cp_async_commit();
    const uint32_t x_s = base + (k & 1) * kStage;
    const uint32_t bh_s = x_s + kRTBytes, bl_s = bh_s + kRTBytes;
    for (int i = tid; i < kRowTile * 8; i += kWg) {
      const int r = i / 8, ch = i % 8;
      const uint32_t o = sm90::tile_off(kRowTile, r, ch);
      const uint4 u = *reinterpret_cast<const uint4*>(gbase + (bh_s - base) +
                                                      o);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float w = w_s[k * kRowTile + r];
      float v[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(b2[e]);
        v[2 * e] = f.x * w;
        v[2 * e + 1] = f.y * w;
      }
      uint4 hi, lo;
      sm90::split8(v, hi, lo);
      *reinterpret_cast<uint4*>(gbase + (bh_s - base) + o) = hi;
      *reinterpret_cast<uint4*>(gbase + (bl_s - base) + o) = lo;
    }
    sm90::fence_proxy_async();
    __syncthreads();
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      sm90::wgmma_ss<64, 1, 1>(
          acc, sm90::desc_sw128(x_s + ks * 2048, kRTBytes, 1024),
          sm90::desc_sw128(bh_s + ks * 2048, kRTBytes, 1024), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      sm90::wgmma_ss<64, 1, 1>(
          acc, sm90::desc_sw128(x_s + ks * 2048, kRTBytes, 1024),
          sm90::desc_sw128(bl_s + ks * 2048, kRTBytes, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }

  float* st = states + bh_chunk(b, h, H, c, nc) * P * kN;
  const int pr = p0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * (lane % 4);
    if (pr < P)
      *reinterpret_cast<float2*>(st + (size_t)pr * kN + n) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (pr + 8 < P)
      *reinterpret_cast<float2*>(st + (size_t)(pr + 8) * kN + n) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// 2. state passing in chunk order: each chunk's S_c replaced by the
// state it starts from; the final state out. A thread owns 4 elements
// of (P, N); the loads of 4 chunks are issued before their dependent
// updates.
__global__ void __launch_bounds__(256)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ acum_g,
               float* __restrict__ fin, int H, int P, int Q, int nc) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= P * kN) return;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 sc[4];
    float dec[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= nc) break;
      const size_t bc = bh_chunk(b, h, H, c0 + k, nc);
      sc[k] = *reinterpret_cast<const float4*>(states + bc * P * kN + e);
      dec[k] = acum_g[bc * Q + Q - 1];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= nc) break;
      const size_t bc = bh_chunk(b, h, H, c0 + k, nc);
      *reinterpret_cast<float4*>(states + bc * P * kN + e) = st;
      const float d = __expf(dec[k]);
      st.x = fmaf(d, st.x, sc[k].x);
      st.y = fmaf(d, st.y, sc[k].y);
      st.z = fmaf(d, st.z, sc[k].z);
      st.w = fmaf(d, st.w, sc[k].w);
    }
  }
  *reinterpret_cast<float4*>(fin + ((size_t)b * H + h) * P * kN + e) = st;
}

// 3. the chunk scan of one 64-row tile i of one chunk (and P slice):
// the (B_j, x_j) tiles j = 0..i go through a 2-stage ring, the copies of
// tile j+1 running while tile j is computed
__global__ void __launch_bounds__(kWg)
ssd_chunk_scan_sm90(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const float* __restrict__ D,
                    const float* __restrict__ states,
                    const float* __restrict__ acum_g,
                    __nv_bfloat16* __restrict__ y, int S, int H, int P,
                    int G, int Q, int nc) {
  constexpr int kStage = 2 * kRTBytes;         // B_j, then x_j
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base, c_s = base + 2 * kStage;
  const uint32_t sh_s = c_s + kRTBytes, sl_s = sh_s + kRTBytes;
  uint8_t* gbase = smem_raw + (base - raw);
  float* acum_s = reinterpret_cast<float*>(gbase + 2 * kStage +
                                           3 * kRTBytes);
  float* dt_s = acum_s + kMaxQ;

  const int n_ps = (P + kPTile - 1) / kPTile;
  const int n_rt = (Q + kRowTile - 1) / kRowTile;
  const int it = n_rt - 1 - (int)blockIdx.x / n_ps;    // heaviest first
  const int ps = blockIdx.x % n_ps, c = blockIdx.y;
  const int b = blockIdx.z / H, h = blockIdx.z % H, g = h / (H / G);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = c * Q, rows = min(Q, S - t0);
  const int i0 = it * kRowTile;
  if (i0 >= rows) return;                      // a tile wholly past S
  const int p0 = ps * kPTile, pc = min(kPTile, P - p0) / 8;
  const size_t bc = bh_chunk(b, h, H, c, nc);
  const size_t row0 = (size_t)b * S + t0;      // the chunk's first row

  // tile j's B and x rows into ring stage j % 2 (zero past `rows`)
  auto load_tile = [&](int jt) {
    const uint32_t st = ring + (jt & 1) * kStage;
    const int j0 = jt * kRowTile;
    sm90::load_rows<kRowTile, 8, kWg>(
        st, Bm + ((row0 + j0) * G + g) * kN, (size_t)G * kN, rows - j0, 8,
        tid);
    sm90::load_rows<kRowTile, 8, kWg>(
        st + kRTBytes, x + (row0 + j0) * H * P + (size_t)h * P + p0,
        (size_t)H * P, rows - j0, pc, tid);
  };
  // group 0: C_i and tile 0
  sm90::load_rows<kRowTile, 8, kWg>(
      c_s, Cm + ((row0 + i0) * G + g) * kN, (size_t)G * kN, rows - i0, 8,
      tid);
  load_tile(0);
  sm90::cp_async_commit();
  // A_cum (flat past the chunk) and dt (0 past `rows`) of rows [0,
  // i0+64), and the state_in slice (rows p, columns n): every load
  // issued before the first use, one round trip
  constexpr int kRowsPer = kMaxQ / kWg;        // A_cum / dt rows a thread
  constexpr int kStPer = kPTile * 8 / kWg;     // 8-value state pieces
  const int nj = i0 + kRowTile;
  const float* sp = states + bc * P * kN + (size_t)p0 * kN;
  float av[kRowsPer], dv[kRowsPer];
  float4 su[kStPer][2];
#pragma unroll
  for (int k = 0; k < kRowsPer; ++k) {
    const int r = tid + k * kWg;
    av[k] = r < nj ? acum_g[bc * Q + min(r, Q - 1)] : 0.f;
    dv[k] = r < nj && r < rows ? dt[(row0 + r) * H + h] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kStPer; ++k) {
    const int i = tid + k * kWg, r = i / 8, ch = i % 8;
    const bool ok = p0 + r < P;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    su[k][0] = ok ? *reinterpret_cast<const float4*>(sp + r * kN + ch * 8)
                  : z;
    su[k][1] = ok ? *reinterpret_cast<const float4*>(sp + r * kN + ch * 8 +
                                                     4)
                  : z;
  }
#pragma unroll
  for (int k = 0; k < kRowsPer; ++k) {
    const int r = tid + k * kWg;
    if (r < nj) {
      acum_s[r] = av[k];
      dt_s[r] = dv[k];
    }
  }
  // the state as a bf16 pair of K-major tiles
#pragma unroll
  for (int k = 0; k < kStPer; ++k) {
    const int i = tid + k * kWg, r = i / 8, ch = i % 8;
    const float v[8] = {su[k][0].x, su[k][0].y, su[k][0].z, su[k][0].w,
                        su[k][1].x, su[k][1].y, su[k][1].z, su[k][1].w};
    uint4 hi, lo;
    sm90::split8(v, hi, lo);
    const uint32_t o = sm90::tile_off(kPTile, r, ch);
    *reinterpret_cast<uint4*>(gbase + (sh_s - base) + o) = hi;
    *reinterpret_cast<uint4*>(gbase + (sl_s - base) + o) = lo;
  }

  // this thread's rows of the tile (r, r + 8)
  const int lr = warp * 16 + lane / 4;
  const int ri0 = i0 + lr, ri1 = ri0 + 8;
  float yv[32];
  for (int jt = 0; jt <= it; ++jt) {
    sm90::cp_async_wait<0>();                  // tile jt (and C_i) landed
    sm90::fence_proxy_async();
    __syncthreads();                           // ... for every thread;
                                               // stage jt-1 is free
    if (jt < it) load_tile(jt + 1);
    sm90::cp_async_commit();
    const float ai0 = acum_s[ri0], ai1 = acum_s[ri1];
    if (jt == 0) {
      // y = exp(A_i) (C_i state_in^T), the state as hi + lo
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<64, 0>(yv, sm90::desc_sw128(c_s + kk * 32, 16, 1024),
                              sm90::desc_sw128(sh_s + kk * 32, 16, 1024),
                              kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<64, 0>(yv, sm90::desc_sw128(c_s + kk * 32, 16, 1024),
                              sm90::desc_sw128(sl_s + kk * 32, 16, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(yv);
      const float e0 = __expf(ai0), e1 = __expf(ai1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        yv[4 * j] *= e0;
        yv[4 * j + 1] *= e0;
        yv[4 * j + 2] *= e1;
        yv[4 * j + 3] *= e1;
      }
    }
    const uint32_t b_s = ring + (jt & 1) * kStage, x_s = b_s + kRTBytes;
    const int j0 = jt * kRowTile;
    // G = C_i B_j^T, both K-major
    float gv[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss<64, 0>(gv, sm90::desc_sw128(c_s + kk * 32, 16, 1024),
                            sm90::desc_sw128(b_s + kk * 32, 16, 1024),
                            kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(gv);
    // M = G exp(A_i - A_j) dt_j, 0 above the diagonal (before the
    // exponent), as the A fragments of a bf16 pair: k16 slice ks is
    // registers 8 ks .. 8 ks + 7
    uint32_t mh[4][4], ml[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 8 * ks + 2 * i;
        const int ri = (i & 1) ? ri1 : ri0;
        const float ai = (i & 1) ? ai1 : ai0;
        const int jc = j0 + 16 * ks + 8 * (i >> 1) + 2 * (lane % 4);
        float m2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          m2[e] = jc + e <= ri
                      ? gv[a + e] * __expf(ai - acum_s[jc + e]) *
                            dt_s[jc + e]
                      : 0.f;
        const __nv_bfloat162 hb = __floats2bfloat162_rn(m2[0], m2[1]);
        const float2 hf = __bfloat1622float2(hb);
        mh[ks][i] = *reinterpret_cast<const uint32_t*>(&hb);
        ml[ks][i] = sm90::pack_bf16(m2[0] - hf.x, m2[1] - hf.y);
      }
    }
    // y += M_hi x_j + M_lo x_j, x_j MN-major (rows are K)
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = sm90::desc_sw128(x_s + ks * 2048, kRTBytes, 1024);
      sm90::wgmma_rs<64, 1>(yv, mh[ks], db, 1);
      sm90::wgmma_rs<64, 1>(yv, ml[ks], db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(yv);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm90::fence_regs(mh[ks]);
      sm90::fence_regs(ml[ks]);
    }
  }

  // + D x_i in fp32 (x_i is the last tile's x), y rounded once and
  // staged over C_i
  const uint32_t xi_s = ring + (it & 1) * kStage + kRTBytes;
  const float dh = D != nullptr ? D[h] : 0.f;
  __syncthreads();                             // every product read C_i
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lr + 8 * half;
      const uint32_t in_chunk = (lane % 4) * 4;
      const uint32_t o = sm90::tile_off(kRowTile, r, j) + in_chunk;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(gbase + (xi_s - base) +
                                                   o));
      const float y0 = yv[4 * j + 2 * half] + dh * xv.x;
      const float y1 = yv[4 * j + 2 * half + 1] + dh * xv.y;
      *reinterpret_cast<__nv_bfloat162*>(gbase + (c_s - base) + o) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
  __syncthreads();
  for (int i = tid; i < kRowTile * 8; i += kWg) {
    const int r = i / 8, ch = i % 8, row = i0 + r;
    if (row < rows && ch < pc)
      *reinterpret_cast<uint4*>(
          y + ((row0 + row) * H + h) * P + p0 + ch * 8) =
          *reinterpret_cast<const uint4*>(gbase + (c_s - base) +
                                          sm90::tile_off(kRowTile, r, ch));
  }
}

int launch_sm90(const void* x, const void* dt, const void* A,
                const void* Bm, const void* Cm, const void* D, void* y,
                void* fin, void* work, int B, int S, int H, int P, int G,
                int Q, cudaStream_t s) {
  static bool set1[64] = {}, set3[64] = {};
  cudaError_t err = sm90::allow_smem(ssd_chunk_state_sm90, kStateSmem, set1);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(ssd_chunk_scan_sm90, kScanSmem, set3);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const int nc = (S + Q - 1) / Q;
  const int n_ps = (P + kPTile - 1) / kPTile;
  const int n_rt = (Q + kRowTile - 1) / kRowTile;
  float* states = (float*)work;
  float* acum = states + (size_t)B * H * nc * P * kN;
  ssd_chunk_state_sm90<<<dim3(nc * n_ps, H, B), kWg, kStateSmem, s>>>(
      (const bf*)x, (const float*)dt, (const float*)A, (const bf*)Bm, states,
      acum, S, H, P, G, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_state_pass<<<dim3((P * kN / 4 + 255) / 256, H, B), 256, 0, s>>>(
      states, acum, (float*)fin, H, P, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_sm90<<<dim3(n_rt * n_ps, nc, B * H), kWg, kScanSmem, s>>>(
      (const bf*)x, (const float*)dt, (const bf*)Bm, (const bf*)Cm,
      (const float*)D, states, acum, (bf*)y, S, H, P, G, Q, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. D may be null.
// work: fp32 scratch of B H nc (P N + Q) values, nc = ceil(S / Q), for
// the bf16 kernels (the per-chunk states, then A_cum); unused (may be
// null) in fp32. Returns cudaGetLastError() after the launches (0 =
// cudaSuccess); a configuration the kernels are not built for returns
// cudaErrorInvalidValue without launching.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            void* y, void* fin, void* work, int B, int S,
                            int H, int P, int G, int N, int Q, int dtype,
                            void* stream) {
  if (N != kN || P <= 0 || P % kPS != 0 || Q <= 0 || Q > kMaxQ || B <= 0 ||
      S <= 0 || G <= 0 || H <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch(x, dt, A, Bm, Cm, D, y, fin, B, S, H, P, G, Q, s);
  if (dtype == 1) {
    if (work == nullptr || (long long)B * H > 65535)
      return (int)cudaErrorInvalidValue;
    return launch_sm90(x, dt, A, Bm, Cm, D, y, fin, work, B, S, H, P, G, Q,
                       s);
  }
  return (int)cudaErrorInvalidValue;
}

// Rows a tile of the bf16 chunk scan: what ssd_scan_tiled_plain models
// (ROW_TILE in kernels/ssd_scan/ssd_scan.py).
extern "C" int ssd_scan_sm90_tile() { return kRowTile; }
// Dynamic shared memory (bytes) of the bf16 chunk-state kernel (0) and
// chunk-scan kernel (1); -1 otherwise.
extern "C" int ssd_scan_sm90_smem(int kernel) {
  return kernel == 0 ? kStateSmem : kernel == 1 ? kScanSmem : -1;
}
