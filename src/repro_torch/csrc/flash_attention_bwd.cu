// Causal GQA flash-attention backward (recompute), written for sm_90a.
//
// Held against: src/repro/kernels/flash_attention/ref.py::_flash_bwd
//   (:115-171), the custom_vjp backward of the JAX package's chunked
//   attention; the Pallas forward (flash_attention_pallas) has no
//   backward of its own. Plain version: repro_torch ref.flash_bwd_ref.
//
// Computes, from the forward's q, k, v, out and lse (B, Sq, H) fp32:
//   Dv   = rowsum(dout * out)                       (B, Sq, H) fp32
//   p    = exp(q k^T * scale - lse), masked (causal on qpos = row +
//          q_offset, kpos < Skv)
//   dv   = p^T dout, dp = dout v^T, ds = p * (dp - Dv) * scale
//   dq   = ds k, dk = ds^T q
//   GQA: q head h reads kv head h / (H / Hkv), and dk/dv of a kv head
//   sum over its H / Hkv query heads. dq, dk, dv come out in q's dtype
//   (fp32 or bf16) with fp32 accumulation; like the reference, p is
//   rounded to that dtype before the dv product and ds before the dq
//   and dk products. D in {64, 80, 128, 192}; all tensors contiguous.
//
// What bounds it on the H100: about 2.5x the forward's causal flops
//   (five products of the forward's size, one of them recomputing the
//   scores, counted once more in the dq pass), so at olmo-1b widths
//   (H = Hkv = 16, D = 128, S = 1024) the tensor cores' 989 TFLOP/s
//   bound it; bytes (q, k, v, out, dout, lse read once, dq, dk, dv
//   written once) are far below.
//
// Two designs, by dtype (flash_attention_bwd dispatches; there is no
// other switch). Both keep one promise: HetSeq's results are identical
// from run to run, so there are no float atomics. Two launches, each
// output owned by exactly one block:
//   * dq pass: one block per (b, h, q tile) loops over the causally
//     visible kv tiles (as the forward does) and sums dq in registers.
//     It also computes Dv for its rows first and writes it out for the
//     second pass.
//   * dk/dv pass: one block per (b, kv head, key tile) loops over the
//     H / Hkv query heads of the group and over the q tiles that see its
//     keys, and sums dk and dv for the kv head itself. This folds GQA
//     with no repeated K/V and no atomics: the sum over the group's
//     heads runs in a fixed order inside one block.
//   Both passes rebuild p from the saved lse, so no (Sq, Skv) tile ever
//   reaches device memory.
//
// bf16: the tensor cores (wgmma) over cp.async rings, with the building
//   blocks of the forward (sm90.cuh). One consumer warpgroup owns 64 rows
//   of every product; BwdTiles gives the tiles each head dim takes.
//   * dq pass: the Q and dO tiles stay resident in 128-byte-swizzled
//     shared memory; K and V tiles stream through a 2-stage ring.
//     S = Q K^T and dP = dO V^T are wgmma with both operands K-major from
//     shared memory; p = exp2(S * scale * log2e - lse * log2e) and
//     ds = p (dP - Dv) scale are computed on the fp32 accumulator
//     fragment with the row's lse and Dv held in registers; dQ += bf16(dS)
//     K is wgmma with dS from registers (the accumulator fragment's k16
//     slice is the A fragment as it stands) and K read MN-major through
//     the transpose bit.
//   * dk/dv pass: the K and V tiles stay resident; the Q and dO tiles of
//     each (query head, q tile) and their lse and Dv rows (4-byte
//     cp.async: they are strided by H) stream through a 2-stage ring.
//     S^T = K Q^T and dP^T = V dO^T are wgmma from shared memory; p^T and
//     ds^T are computed on the fragment with lse and Dv indexed by column
//     from shared memory; dV += bf16(p^T) dO and dK += bf16(ds^T) Q are
//     wgmma with the A fragment from registers and dO, Q read MN-major.
//   * p is rounded to bf16 once before the dv product and ds before the
//     dq and dk products, as the reference does: a bf16 register A
//     fragment is exactly that rounding, so unlike the forward's P V no
//     hi/lo pair is needed (flash_attention_bwd_tiled_plain models this
//     arithmetic on the CPU).
//   * The causal mask is applied only on tiles that cross the diagonal
//     or the ragged end; tiles that no row sees are not visited.
//   * D = 80 (zamba2's shared attention block): the shared-memory tiles
//     are padded to 128 columns, two 64-column swizzle blocks, as the
//     forward pads them (the 16-byte global reads stay 80 wide and the
//     pad columns are never read); the products over D take five k16
//     steps, and dQ, dK and dV are n80 products. A 64 x 80 fp32
//     accumulator is 40 registers a thread, so the dk/dv pass keeps both
//     of its own in one warpgroup (the D <= 128 design).
//   * D = 192 (MLA training; v arrives zero-padded from 128): one
//     64 x 192 fp32 accumulator is 96 registers a thread, so the dk/dv
//     pass cannot hold both of its own. Its block's two warpgroups take
//     the same 64 keys and split the outputs instead: warpgroup 0 sums
//     dV, warpgroup 1 dK, each in one accumulator, each computing S^T and
//     dP^T itself from the shared K, V tiles and the shared ring of Q, dO
//     tiles (branch-free: warpgroup 0's dP^T is not used). The dq pass
//     keeps its design (one accumulator).
//   What bounds it now: each warpgroup runs its products, the
//   elementwise p/ds work and the next products in turn, with one
//   barrier a tile; the dq pass recomputes S and dP (7 products for the
//   function's 5; 8 at D = 192).
//
// fp32: the first, CUDA-core version, unchanged: fp32 arithmetic, one
//   key per lane, K and V tiles padded to D+1 floats in shared memory
//   where 32 lanes read 32 different keys. At D = 80 (not a multiple of
//   the 32 lanes) a lane of the dq pass holds ceil(D / 32) = 3 columns a
//   row, lane + 32 c, the third live on lanes 0..15 only, as the forward
//   does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBKV = 32;         // kv positions per tile (one per lane)
constexpr int kBQ2 = 32;         // dk/dv pass: q rows per staged tile
constexpr int kRows2 = kBQ2 / kWarps;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// the reference's .astype(q.dtype) on an fp32 value
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dq pass: q rows per block. 32 at D=128 halves the accumulators a
// lane holds (168 registers at 64 rows, 72 at 32); ptxas still reports
// a 32-byte local stack at D=128 with either tile, so that spill is
// not register pressure. D=192 takes 32 rows for the same reason.
template <int D>
__host__ __device__ constexpr int dq_tile() {
  return D >= 128 ? 32 : 64;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * dq_tile<D>() * D + 2 * kBKV * (D + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kBKV * (D + 1) + 2 * kBQ2 * D +
                          2 * kBQ2 * (kBKV + 1) + 2 * kBQ2);
}

// ---------------------------------------------------------------------
// dq pass (and Dv)
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dvec,
                    T* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
                    int causal, int q_offset, float scale) {
  constexpr int kC = (D + 31) / 32;
  constexpr int kBQ = dq_tile<D>();
  constexpr int kRowsPerWarp = kBQ / kWarps;
  extern __shared__ float smem[];
  float (*q_s)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*do_s)[D] = reinterpret_cast<float (*)[D]>(smem + kBQ * D);
  float (*k_s)[D + 1] =
      reinterpret_cast<float (*)[D + 1]>(smem + 2 * kBQ * D);
  float (*v_s)[D + 1] = reinterpret_cast<float (*)[D + 1]>(
      smem + 2 * kBQ * D + kBKV * (D + 1));

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * kBQ;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, row = q0 + r;
    float x = 0.f, g = 0.f;
    if (row < Sq) {
      const size_t off = ((size_t)(b * Sq + row) * H + h) * D + d;
      x = to_f(q[off]);
      g = to_f(dout[off]);
    }
    q_s[r][d] = x;
    do_s[r][d] = g;
  }

  // Dv = rowsum(dout * out) for this warp's rows, fp32
  float lse_r[kRowsPerWarp], dv_r[kRowsPerWarp], acc[kRowsPerWarp][kC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp * kRowsPerWarp + i;
    float part = 0.f, ls = 0.f;
    if (row < Sq) {
      const size_t base = ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = lane + 32 * c;
        if (D % 32 == 0 || d < D)
          part += to_f(dout[base + d]) * to_f(out[base + d]);
      }
      ls = lse[(size_t)(b * Sq + row) * H + h];
    }
    dv_r[i] = warp_sum(part);
    lse_r[i] = ls;
    if (row < Sq && lane == 0) dvec[(size_t)(b * Sq + row) * H + h] = dv_r[i];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  int kv_end = Skv;
  if (causal) {
    const int last_q = min(q0 + kBQ, Sq) - 1 + q_offset;
    kv_end = min(Skv, last_q + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kBKV - 1) / kBKV : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();                      // q/do staged; old tile consumed
    for (int i = tid; i < kBKV * D; i += kThreads) {
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
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[r][d], k_s[lane][d], s);
        dp = fmaf(do_s[r][d], v_s[lane][d], dp);
      }
      const float p = live ? expf(s * scale - lse_r[i]) : 0.f;
      const float ds = round_to<T>(p * (dp - dv_r[i]) * scale);
#pragma unroll
      for (int j = 0; j < kBKV; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (D % 32 == 0 || lane + 32 * c < D)
            acc[i][c] = fmaf(dsj, k_s[j][lane + 32 * c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp * kRowsPerWarp + i;
    if (row >= Sq) continue;
    T* dst = dq + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (D % 32 == 0 || lane + 32 * c < D)
        dst[lane + 32 * c] = from_f<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------
// dk/dv pass
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                     int causal, int q_offset, float scale) {
  constexpr int kC = D / kWarps;           // dims per thread: warp + 4c
  extern __shared__ float smem[];
  float* p_ = smem;
  float (*k_s)[D + 1] = reinterpret_cast<float (*)[D + 1]>(p_);
  p_ += kBKV * (D + 1);
  float (*v_s)[D + 1] = reinterpret_cast<float (*)[D + 1]>(p_);
  p_ += kBKV * (D + 1);
  float (*q_s)[D] = reinterpret_cast<float (*)[D]>(p_);
  p_ += kBQ2 * D;
  float (*do_s)[D] = reinterpret_cast<float (*)[D]>(p_);
  p_ += kBQ2 * D;
  float (*P_s)[kBKV + 1] = reinterpret_cast<float (*)[kBKV + 1]>(p_);
  p_ += kBQ2 * (kBKV + 1);
  float (*dS_s)[kBKV + 1] = reinterpret_cast<float (*)[kBKV + 1]>(p_);
  p_ += kBQ2 * (kBKV + 1);
  float* lse_s = p_;
  float* dv_s = p_ + kBQ2;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = kt * kBKV;
  const int kpos = k0 + lane;

  for (int i = tid; i < kBKV * D; i += kThreads) {
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

  float dk_acc[kC], dv_acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) { dk_acc[c] = 0.f; dv_acc[c] = 0.f; }

  // q rows that see any key of this tile: qpos >= k0
  int row_lo = 0;
  if (causal) row_lo = max(0, k0 - q_offset);
  const int t_lo = row_lo / kBQ2;
  const int n_qt = (Sq + kBQ2 - 1) / kBQ2;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = t_lo; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ2;
      __syncthreads();                    // previous q tile consumed
      for (int i = tid; i < kBQ2 * D; i += kThreads) {
        const int r = i / D, d = i % D, row = q0 + r;
        float x = 0.f, gg = 0.f;
        if (row < Sq) {
          const size_t off = ((size_t)(b * Sq + row) * H + h) * D + d;
          x = to_f(q[off]);
          gg = to_f(dout[off]);
        }
        q_s[r][d] = x;
        do_s[r][d] = gg;
      }
      for (int r = tid; r < kBQ2; r += kThreads) {
        const int row = q0 + r;
        const size_t o = (size_t)(b * Sq + row) * H + h;
        lse_s[r] = row < Sq ? lse[o] : 0.f;
        dv_s[r] = row < Sq ? dvec[o] : 0.f;
      }
      __syncthreads();

      // p and ds for (row, key = lane), this warp's rows of the tile
#pragma unroll
      for (int i = 0; i < kRows2; ++i) {
        const int r = warp * kRows2 + i;
        const int row = q0 + r;
        const int qpos = row + q_offset;
        const bool live =
            row < Sq && kpos < Skv && (!causal || qpos >= kpos);
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(q_s[r][d], k_s[lane][d], s);
          dp = fmaf(do_s[r][d], v_s[lane][d], dp);
        }
        const float p = live ? expf(s * scale - lse_s[r]) : 0.f;
        P_s[r][lane] = round_to<T>(p);
        dS_s[r][lane] = round_to<T>(p * (dp - dv_s[r]) * scale);
      }
      __syncthreads();

      // dv[key][d] += sum_r p[r][key] dout[r][d]; dk likewise with ds, q
#pragma unroll 4
      for (int r = 0; r < kBQ2; ++r) {
        const float pr = P_s[r][lane], dsr = dS_s[r][lane];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int d = warp + kWarps * c;
          dv_acc[c] = fmaf(pr, do_s[r][d], dv_acc[c]);
          dk_acc[c] = fmaf(dsr, q_s[r][d], dk_acc[c]);
        }
      }
    }
  }

  if (kpos < Skv) {
    const size_t base = ((size_t)(b * Skv + kpos) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = warp + kWarps * c;
      dk[base + d] = from_f<T>(dk_acc[c]);
      dv[base + d] = from_f<T>(dv_acc[c]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int Hkv,
           int causal, int q_offset, float scale, cudaStream_t s) {
  const size_t s1 = dq_smem_bytes<D>(), s2 = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((Sq + dq_tile<D>() - 1) / dq_tile<D>(), H, B);
  flash_bwd_dq_kernel<T, D><<<g1, kThreads, s1, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)out, (const T*)dout,
      lse, dvec, (T*)dq, Sq, Skv, H, Hkv, causal, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Skv <= 0) return 0;
  dim3 g2((Skv + kBKV - 1) / kBKV, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<g2, kThreads, s2, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dvec,
      (T*)dk, (T*)dv, Sq, Skv, H, Hkv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------
// bf16: tensor cores (wgmma) over cp.async rings
// ---------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// dq pass: kBQ q rows a block (64 a consumer warpgroup), kBKV kv
// positions a streamed tile
template <int D, int kBQ_, int kBKV_>
struct DqCfg {
  static constexpr int kBQ = kBQ_;
  static constexpr int kBKV = kBKV_;
  static constexpr int kThreads = 2 * kBQ;        // 128 a warpgroup
  static constexpr int kDP = (D + 63) / 64 * 64;  // tile columns in smem
  static constexpr int kQBytes = kBQ * kDP * 2;   // the Q or dO tile
  static constexpr int kKVBytes = kBKV * kDP * 2; // one K or V tile
  // Q, dO, a 2-stage ring of K and V, the rows' lse and Dv, 1 KB to
  // align the base
  static constexpr int kSmem = 2 * kQBytes + 2 * 2 * kKVBytes +
                               2 * kBQ * 4 + 1024;
};

// dk/dv pass: kBKV keys a block (64 a consumer warpgroup), kBQ q rows a
// streamed tile. Above D = 128 (kSplit) the block's two warpgroups take
// the same 64 keys, one output each (flash_bwd_dkv_split).
template <int D, int kBKV_, int kBQ_>
struct DkvCfg {
  static constexpr bool kSplit = D > 128;
  static constexpr int kBKV = kBKV_;
  static constexpr int kBQ = kBQ_;
  static constexpr int kThreads = kSplit ? 256 : 2 * kBKV;  // 128 a wg
  static constexpr int kDP = (D + 63) / 64 * 64;  // tile columns in smem
  static constexpr int kKBytes = kBKV * kDP * 2;  // the K or V tile
  static constexpr int kQBytes = kBQ * kDP * 2;   // one Q or dO tile
  // a stage: Q, dO, then lse and Dv of its rows, padded to 1 KB
  static constexpr int kStageBytes = 2 * kQBytes + (2 * kBQ * 4 + 1023) /
                                     1024 * 1024;
  static constexpr int kSmem = 2 * kKBytes + 2 * kStageBytes + 1024;
};

template <int D, class C>
__global__ void __launch_bounds__(C::kThreads)
flash_bwd_dq_sm90(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ out,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dvec,
                  __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                  int Hkv, int causal, int q_offset, float scale) {
  constexpr int kBQ = C::kBQ, kBKV = C::kBKV, kT = C::kThreads;
  constexpr int kC = D / 8;                        // 16-byte chunks a row
  constexpr int kStageBytes = 2 * C::kKVBytes;     // K then V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::kQBytes;
  const uint32_t kv_s = base + 2 * C::kQBytes;
  // lse (log2 units) and Dv of the block's rows
  float* row_s = reinterpret_cast<float*>(
      smem_raw + (base - raw) + 2 * C::kQBytes + 2 * kStageBytes);

  // q tiles in reverse: the causal rows with the most keys start first
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int q0 = qt * kBQ;
  const size_t q_ld = (size_t)H * D, kv_ld = (size_t)Hkv * D;
  const size_t q_off = ((size_t)b * Sq + q0) * q_ld + (size_t)h * D;
  const __nv_bfloat16* kg = k + (size_t)b * Skv * kv_ld + (size_t)hk * D;
  const __nv_bfloat16* vg = v + (size_t)b * Skv * kv_ld + (size_t)hk * D;

  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + kBQ, Sq) + q_offset);
  const int n_t = kv_end > 0 ? (kv_end + kBKV - 1) / kBKV : 0;

  // the ring's first group: the Q and dO tiles and kv tile 0
  sm90::load_rows<kBQ, kC, kT>(q_s, q + q_off, q_ld, Sq - q0, kC, tid);
  sm90::load_rows<kBQ, kC, kT>(do_s, dout + q_off, q_ld, Sq - q0, kC, tid);
  if (n_t > 0) {
    sm90::load_rows<kBKV, kC, kT>(kv_s, kg, kv_ld, Skv, kC, tid);
    sm90::load_rows<kBKV, kC, kT>(kv_s + C::kKVBytes, vg, kv_ld, Skv, kC,
                                  tid);
  }
  sm90::cp_async_commit();

  // meanwhile Dv = rowsum(dout * out) in fp32, two threads a row, and the
  // row's lse in log2 units; Dv also goes out for the dk/dv pass
  {
    const int r = tid / 2, part = tid % 2, row = q0 + r;
    float acc = 0.f, ls = 0.f;
    if (row < Sq) {
      const size_t off = ((size_t)(b * Sq + row) * H + h) * D + part * D / 2;
      const uint4* o4 = reinterpret_cast<const uint4*>(out + off);
      const uint4* g4 = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const uint4 ov = o4[i], gv = g4[i];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 of = __bfloat1622float2(o2[j]);
          const float2 gf = __bfloat1622float2(g2[j]);
          acc = fmaf(gf.x, of.x, acc);
          acc = fmaf(gf.y, of.y, acc);
        }
      }
      ls = lse[(size_t)(b * Sq + row) * H + h];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      row_s[r] = ls * kLog2e;
      row_s[kBQ + r] = acc;
      if (row < Sq) dvec[(size_t)(b * Sq + row) * H + h] = acc;
    }
  }
  __syncthreads();

  // this thread's two rows (r, r + 8) of its warpgroup's 64
  const int wq0 = q0 + wg * 64;
  const int rl = wg * 64 + warp * 16 + lane / 4;   // local row
  const int qpos0 = q0 + rl + q_offset, qpos1 = qpos0 + 8;
  const float lse0 = row_s[rl], lse1 = row_s[rl + 8];
  const float dv0 = row_s[kBQ + rl], dv1 = row_s[kBQ + rl + 8];
  const bool wg_live = wq0 < Sq;
  const int wg_first = wq0 + q_offset;
  const int wg_last = min(wq0 + 64, Sq) - 1 + q_offset;
  const float sl2 = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    const int k0 = t * kBKV;
    sm90::cp_async_wait<0>();          // tile t (and Q, dO) landed
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

    // S = Q K^T and dP = dO V^T (64 x kBKV each), K-major operands
    float s[kBKV / 2], dp[kBKV / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBQ * 128 + wg * 64 * 128 +
                             (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * kBKV * 128 + (kk % 4) * 32;
      sm90::wgmma_ss<kBKV, 0>(s, sm90::desc_sw128(q_s + a_off, 16, 1024),
                              sm90::desc_sw128(k_s + b_off, 16, 1024),
                              kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBQ * 128 + wg * 64 * 128 +
                             (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * kBKV * 128 + (kk % 4) * 32;
      sm90::wgmma_ss<kBKV, 0>(dp, sm90::desc_sw128(do_s + a_off, 16, 1024),
                              sm90::desc_sw128(v_s + b_off, 16, 1024),
                              kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // p and ds on the fragment; the mask only where the tile crosses Skv
    // or the diagonal. k16 slice ks of the fragment is registers 8 ks ..
    // 8 ks + 7: the A fragment of dS for that slice.
    const bool edge = k0 + kBKV > Skv || (causal && k0 + kBKV - 1 > wg_first);
    uint32_t dsf[kBKV / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBKV / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 8 * ks + 2 * i;              // row r for i even
        const bool hi = i & 1;
        const int col = k0 + 16 * ks + 8 * (i >> 1) + 2 * (lane % 4);
        float d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = fmaf(s[a + e], sl2, -(hi ? lse1 : lse0));
          if (edge && (col + e >= Skv ||
                       (causal && col + e > (hi ? qpos1 : qpos0))))
            x = -INFINITY;
          const float p = sm90::fast_exp2(x);
          d2[e] = p * (dp[a + e] - (hi ? dv1 : dv0)) * scale;
        }
        dsf[ks][i] = sm90::pack_bf16(d2[0], d2[1]);
      }
    }
    // dQ += dS K: K is (pos, D), read MN-major (the transpose bit)
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBKV / 16; ++ks)
      sm90::wgmma_rs<D, 1>(acc, dsf[ks],
                           sm90::desc_sw128(k_s + ks * 16 * 128,
                                            kBKV * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kBKV / 16; ++ks) sm90::fence_regs(dsf[ks]);
  }

  if (!wg_live) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + rl + 8 * half;
    if (row >= Sq) continue;
    __nv_bfloat16* dst = dq + ((size_t)(b * Sq + row) * H + h) * D +
                         2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                acc[4 * j + 2 * half + 1]);
  }
}

// each warpgroup owns 64 keys and sums both their dK and dV
template <int D, class C>
__device__ __forceinline__ void
flash_bwd_dkv_pair(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                   int Hkv, int causal, int q_offset, float scale) {
  constexpr int kBKV = C::kBKV, kBQ = C::kBQ, kT = C::kThreads;
  constexpr int kC = D / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + C::kKBytes;
  const uint32_t ring = base + 2 * C::kKBytes;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int k0 = kt * kBKV;
  const size_t q_ld = (size_t)H * D, kv_ld = (size_t)Hkv * D;
  const size_t kv_off = ((size_t)b * Skv + k0) * kv_ld + (size_t)hk * D;

  // q tiles that see a key of this tile (qpos >= k0), per query head
  const int row_lo = causal ? max(0, k0 - q_offset) : 0;
  const int t_lo = row_lo / kBQ;
  const int per_head = max(0, (Sq + kBQ - 1) / kBQ - t_lo);
  const int n_it = group * per_head;

  // the Q and dO tiles of (query head g, q tile) and their rows' lse and
  // Dv into a ring stage; heads in order, q tiles in order within one
  auto load_stage = [&](int it, uint32_t st) {
    const int h = hk * group + it / per_head;
    const int q0 = (t_lo + it % per_head) * kBQ;
    const size_t off = ((size_t)b * Sq + q0) * q_ld + (size_t)h * D;
    sm90::load_rows<kBQ, kC, kT>(st, q + off, q_ld, Sq - q0, kC, tid);
    sm90::load_rows<kBQ, kC, kT>(st + C::kQBytes, dout + off, q_ld,
                                 Sq - q0, kC, tid);
    for (int i = tid; i < 2 * kBQ; i += kT) {
      const int row = q0 + i % kBQ;
      const bool ok = row < Sq;
      const float* src = (i < kBQ ? lse : dvec) +
                         ((size_t)b * Sq + (ok ? row : 0)) * H + h;
      sm90::cp_async_4(st + 2 * C::kQBytes + i * 4, src, ok);
    }
  };

  // the ring's first group: K, V and the first (head, q tile)
  sm90::load_rows<kBKV, kC, kT>(k_s, k + kv_off, kv_ld, Skv - k0, kC, tid);
  sm90::load_rows<kBKV, kC, kT>(v_s, v + kv_off, kv_ld, Skv - k0, kC, tid);
  if (n_it > 0) load_stage(0, ring);
  sm90::cp_async_commit();

  // this thread's two keys (rows r, r + 8 of its warpgroup's 64 of S^T)
  const int key0 = k0 + wg * 64 + warp * 16 + lane / 4, key1 = key0 + 8;
  const float sl2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) { dk_acc[i] = 0.f; dv_acc[i] = 0.f; }

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (t_lo + it % per_head) * kBQ;
    sm90::cp_async_wait<0>();          // this stage (and K, V) landed
    sm90::fence_proxy_async();
    __syncthreads();                   // ... for every thread; and the
                                       // other stage is no longer read
    if (it + 1 < n_it) load_stage(it + 1, ring + ((it + 1) & 1) * C::kStageBytes);
    sm90::cp_async_commit();
    const uint32_t q_s = ring + (it & 1) * C::kStageBytes;
    const uint32_t do_s = q_s + C::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(
        ring_ptr + (it & 1) * C::kStageBytes + 2 * C::kQBytes);
    const float* dv_s = lse_s + kBQ;

    // S^T = K Q^T and dP^T = V dO^T (kBKV x kBQ each), K-major operands
    float st[kBQ / 2], dpt[kBQ / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBKV * 128 + wg * 64 * 128 +
                             (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
      sm90::wgmma_ss<kBQ, 0>(st, sm90::desc_sw128(k_s + a_off, 16, 1024),
                             sm90::desc_sw128(q_s + b_off, 16, 1024),
                             kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBKV * 128 + wg * 64 * 128 +
                             (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
      sm90::wgmma_ss<kBQ, 0>(dpt, sm90::desc_sw128(v_s + a_off, 16, 1024),
                             sm90::desc_sw128(do_s + b_off, 16, 1024),
                             kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // p^T and ds^T on the fragment: columns are q rows, so lse and Dv are
    // read by column; the mask only where the tile crosses Sq or the
    // diagonal
    const bool edge = q0 + kBQ > Sq ||
                      (causal && k0 + kBKV - 1 > q0 + q_offset);
    uint32_t pf[kBQ / 16][4], dsf[kBQ / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 8 * ks + 2 * i;              // key r for i even
        const int key = (i & 1) ? key1 : key0;
        const int cl = 16 * ks + 8 * (i >> 1) + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + cl);
        const float2 d2 = *reinterpret_cast<const float2*>(dv_s + cl);
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = q0 + cl + e;
          float x = fmaf(st[a + e], sl2, -((e ? l2.y : l2.x) * kLog2e));
          if (edge && (row >= Sq || (causal && key > row + q_offset)))
            x = -INFINITY;
          p[e] = sm90::fast_exp2(x);
          ds[e] = p[e] * (dpt[a + e] - (e ? d2.y : d2.x)) * scale;
        }
        pf[ks][i] = sm90::pack_bf16(p[0], p[1]);
        dsf[ks][i] = sm90::pack_bf16(ds[0], ds[1]);
      }
    }
    // dV += P^T dO and dK += dS^T Q: dO and Q are (q row, D), read
    // MN-major (the transpose bit)
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks)
      sm90::wgmma_rs<D, 1>(dv_acc, pf[ks],
                           sm90::desc_sw128(do_s + ks * 16 * 128,
                                            kBQ * 128, 1024), 1);
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks)
      sm90::wgmma_rs<D, 1>(dk_acc, dsf[ks],
                           sm90::desc_sw128(q_s + ks * 16 * 128,
                                            kBQ * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv_acc);
    sm90::fence_regs(dk_acc);
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks) {
      sm90::fence_regs(pf[ks]);
      sm90::fence_regs(dsf[ks]);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    if (key >= Skv) continue;
    const size_t off = ((size_t)(b * Skv + key) * Hkv + hk) * D +
                       2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * half],
                                dk_acc[4 * j + 2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * half],
                                dv_acc[4 * j + 2 * half + 1]);
    }
  }
}

// the two warpgroups take the block's 64 keys; warpgroup 0 sums their dV,
// warpgroup 1 their dK, each in one accumulator (the D = 192 design)
template <int D, class C>
__device__ __forceinline__ void
flash_bwd_dkv_split(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                    int Hkv, int causal, int q_offset, float scale) {
  constexpr int kBKV = C::kBKV, kBQ = C::kBQ, kT = C::kThreads;
  static_assert(kBKV == 64 && kT == 256, "split: 64 keys, two warpgroups");
  constexpr int kC = D / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + C::kKBytes;
  const uint32_t ring = base + 2 * C::kKBytes;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const bool sums_dk = wg == 1;
  const int k0 = kt * kBKV;
  const size_t q_ld = (size_t)H * D, kv_ld = (size_t)Hkv * D;
  const size_t kv_off = ((size_t)b * Skv + k0) * kv_ld + (size_t)hk * D;

  // q tiles that see a key of this tile (qpos >= k0), per query head
  const int row_lo = causal ? max(0, k0 - q_offset) : 0;
  const int t_lo = row_lo / kBQ;
  const int per_head = max(0, (Sq + kBQ - 1) / kBQ - t_lo);
  const int n_it = group * per_head;

  // as flash_bwd_dkv_pair's: heads in order, q tiles in order within one
  auto load_stage = [&](int it, uint32_t st) {
    const int h = hk * group + it / per_head;
    const int q0 = (t_lo + it % per_head) * kBQ;
    const size_t off = ((size_t)b * Sq + q0) * q_ld + (size_t)h * D;
    sm90::load_rows<kBQ, kC, kT>(st, q + off, q_ld, Sq - q0, kC, tid);
    sm90::load_rows<kBQ, kC, kT>(st + C::kQBytes, dout + off, q_ld,
                                 Sq - q0, kC, tid);
    for (int i = tid; i < 2 * kBQ; i += kT) {
      const int row = q0 + i % kBQ;
      const bool ok = row < Sq;
      const float* src = (i < kBQ ? lse : dvec) +
                         ((size_t)b * Sq + (ok ? row : 0)) * H + h;
      sm90::cp_async_4(st + 2 * C::kQBytes + i * 4, src, ok);
    }
  };

  sm90::load_rows<kBKV, kC, kT>(k_s, k + kv_off, kv_ld, Skv - k0, kC, tid);
  sm90::load_rows<kBKV, kC, kT>(v_s, v + kv_off, kv_ld, Skv - k0, kC, tid);
  if (n_it > 0) load_stage(0, ring);
  sm90::cp_async_commit();

  // this thread's two keys (rows r, r + 8 of the block's 64 of S^T)
  const int key0 = k0 + warp * 16 + lane / 4, key1 = key0 + 8;
  const float sl2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (t_lo + it % per_head) * kBQ;
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_it) load_stage(it + 1, ring + ((it + 1) & 1) * C::kStageBytes);
    sm90::cp_async_commit();
    const uint32_t q_s = ring + (it & 1) * C::kStageBytes;
    const uint32_t do_s = q_s + C::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(
        ring_ptr + (it & 1) * C::kStageBytes + 2 * C::kQBytes);
    const float* dv_s = lse_s + kBQ;

    // S^T = K Q^T and dP^T = V dO^T (64 x kBQ each), in both warpgroups
    float st[kBQ / 2], dpt[kBQ / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBKV * 128 + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
      sm90::wgmma_ss<kBQ, 0>(st, sm90::desc_sw128(k_s + a_off, 16, 1024),
                             sm90::desc_sw128(q_s + b_off, 16, 1024),
                             kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kBKV * 128 + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
      sm90::wgmma_ss<kBQ, 0>(dpt, sm90::desc_sw128(v_s + a_off, 16, 1024),
                             sm90::desc_sw128(do_s + b_off, 16, 1024),
                             kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // p^T (warpgroup 0) or ds^T (warpgroup 1) on the fragment, rounded
    // to bf16 as flash_bwd_dkv_pair rounds them
    const bool edge = q0 + kBQ > Sq ||
                      (causal && k0 + kBKV - 1 > q0 + q_offset);
    uint32_t af[kBQ / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 8 * ks + 2 * i;
        const int key = (i & 1) ? key1 : key0;
        const int cl = 16 * ks + 8 * (i >> 1) + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + cl);
        const float2 d2 = *reinterpret_cast<const float2*>(dv_s + cl);
        float x2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = q0 + cl + e;
          float x = fmaf(st[a + e], sl2, -((e ? l2.y : l2.x) * kLog2e));
          if (edge && (row >= Sq || (causal && key > row + q_offset)))
            x = -INFINITY;
          const float p = sm90::fast_exp2(x);
          const float ds = p * (dpt[a + e] - (e ? d2.y : d2.x)) * scale;
          x2[e] = sums_dk ? ds : p;
        }
        af[ks][i] = sm90::pack_bf16(x2[0], x2[1]);
      }
    }
    // dV += P^T dO or dK += dS^T Q: dO and Q are (q row, D), read
    // MN-major (the transpose bit)
    const uint32_t b_s = sums_dk ? q_s : do_s;
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks)
      sm90::wgmma_rs<D, 1>(acc, af[ks],
                           sm90::desc_sw128(b_s + ks * 16 * 128,
                                            kBQ * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks) sm90::fence_regs(af[ks]);
  }

  __nv_bfloat16* const out = sums_dk ? dk : dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    if (key >= Skv) continue;
    const size_t off = ((size_t)(b * Skv + key) * Hkv + hk) * D +
                       2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + off + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                acc[4 * j + 2 * half + 1]);
  }
}

template <int D, class C>
__global__ void __launch_bounds__(C::kThreads)
flash_bwd_dkv_sm90(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                   int Hkv, int causal, int q_offset, float scale) {
  if constexpr (C::kSplit)
    flash_bwd_dkv_split<D, C>(q, k, v, dout, lse, dvec, dk, dv, Sq, Skv, H,
                              Hkv, causal, q_offset, scale);
  else
    flash_bwd_dkv_pair<D, C>(q, k, v, dout, lse, dvec, dk, dv, Sq, Skv, H,
                             Hkv, causal, q_offset, scale);
}

// The tiles each head dim takes: the dq pass's (q rows, kv positions a
// tile) and the dk/dv pass's (keys, q rows a tile), chosen by timing at
// the train path's shape (PERF.md).
template <int D> struct BwdTiles;
template <> struct BwdTiles<64> {
  using Dq = DqCfg<64, 64, 64>;
  using Dkv = DkvCfg<64, 64, 64>;
};
template <> struct BwdTiles<80> {
  using Dq = DqCfg<80, 64, 64>;
  using Dkv = DkvCfg<80, 64, 64>;
};
template <> struct BwdTiles<128> {
  using Dq = DqCfg<128, 64, 64>;
  using Dkv = DkvCfg<128, 64, 64>;
};
template <> struct BwdTiles<192> {
  using Dq = DqCfg<192, 64, 64>;
  using Dkv = DkvCfg<192, 64, 64>;
};

template <int D>
int launch_sm90(const void* q, const void* k, const void* v,
                const void* out, const void* dout, const float* lse,
                float* dvec, void* dq, void* dk, void* dv, int B, int Sq,
                int Skv, int H, int Hkv, int causal, int q_offset,
                float scale, cudaStream_t s) {
  using C1 = typename BwdTiles<D>::Dq;
  using C2 = typename BwdTiles<D>::Dkv;
  using bf = __nv_bfloat16;
  static bool set1[64] = {}, set2[64] = {};    // one set per kernel
  cudaError_t err = sm90::allow_smem(flash_bwd_dq_sm90<D, C1>, C1::kSmem,
                                     set1);
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(flash_bwd_dkv_sm90<D, C2>, C2::kSmem, set2);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((Sq + C1::kBQ - 1) / C1::kBQ, H, B);
  flash_bwd_dq_sm90<D, C1><<<g1, C1::kThreads, C1::kSmem, s>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)out,
      (const bf*)dout, lse, dvec, (bf*)dq, Sq, Skv, H, Hkv, causal,
      q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Skv <= 0) return 0;
  dim3 g2((Skv + C2::kBKV - 1) / C2::kBKV, Hkv, B);
  flash_bwd_dkv_sm90<D, C2><<<g2, C2::kThreads, C2::kSmem, s>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse,
      dvec, (bf*)dk, (bf*)dv, Sq, Skv, H, Hkv, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dvec is fp32 scratch (B, Sq, H)
// that the first launch fills and the second reads. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess); shapes are
// checked by the caller, other configurations return
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* dvec, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int H, int Hkv,
                                   int D, int causal, int q_offset,
                                   float scale, int dtype, void* stream) {
  if ((D != 64 && D != 80 && D != 128 && D != 192) || Hkv <= 0 ||
      H % Hkv != 0 ||
      B <= 0 || Sq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dvc = (float*)dvec;
#define REPRO_BWD(T, DD)                                                   \
  return launch<T, DD>(q, k, v, out, dout, l, dvc, dq, dk, dv, B, Sq, Skv, \
                       H, Hkv, causal, q_offset, scale, s)
  if (dtype == 0) {
    if (D == 64) REPRO_BWD(float, 64);
    if (D == 80) REPRO_BWD(float, 80);
    if (D == 128) REPRO_BWD(float, 128);
    REPRO_BWD(float, 192);
  }
#undef REPRO_BWD
#define REPRO_BWD(DD)                                                     \
  return launch_sm90<DD>(q, k, v, out, dout, l, dvc, dq, dk, dv, B, Sq,   \
                         Skv, H, Hkv, causal, q_offset, scale, s)
  if (dtype == 1) {
    if (D == 64) REPRO_BWD(64);
    if (D == 80) REPRO_BWD(80);
    if (D == 128) REPRO_BWD(128);
    REPRO_BWD(192);
  }
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

// A tile of a bf16 launch of flash_attention_bwd, or -1 for a head dim
// or axis it does not take: axis 0 the dq pass's q rows a block, 1 its kv
// positions a tile, 2 the dk/dv pass's keys a block, 3 its q rows a tile.
// What flash_attention_bwd_tiled_plain models (BWD_TILES in
// kernels/flash_attention/flash_attention.py).
extern "C" int flash_attention_bwd_sm90_tile(int D, int axis) {
#define REPRO_TILE(DD)                                                     \
  if (D == DD) {                                                           \
    const int t[4] = {BwdTiles<DD>::Dq::kBQ, BwdTiles<DD>::Dq::kBKV,       \
                      BwdTiles<DD>::Dkv::kBKV, BwdTiles<DD>::Dkv::kBQ};    \
    return axis >= 0 && axis < 4 ? t[axis] : -1;                           \
  }
  REPRO_TILE(64)
  REPRO_TILE(80)
  REPRO_TILE(128)
  REPRO_TILE(192)
#undef REPRO_TILE
  return -1;
}

// Dynamic shared memory a bf16 launch of flash_attention_bwd asks for
// (bytes) in pass 0 (dq) or 1 (dk/dv), or -1.
extern "C" int flash_attention_bwd_sm90_smem(int D, int pass) {
  if (pass != 0 && pass != 1) return -1;
  if (D == 64)
    return pass ? BwdTiles<64>::Dkv::kSmem : BwdTiles<64>::Dq::kSmem;
  if (D == 80)
    return pass ? BwdTiles<80>::Dkv::kSmem : BwdTiles<80>::Dq::kSmem;
  if (D == 128)
    return pass ? BwdTiles<128>::Dkv::kSmem : BwdTiles<128>::Dq::kSmem;
  if (D == 192)
    return pass ? BwdTiles<192>::Dkv::kSmem : BwdTiles<192>::Dq::kSmem;
  return -1;
}
