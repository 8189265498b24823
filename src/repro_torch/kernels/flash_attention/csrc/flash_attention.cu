// Flash attention, forward: online-softmax attention with causal,
// sliding-window and full masks, grouped-query heads, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:29
// (`flash_attention_pallas`, called through `ops.py:flash_attention_tpu`).
// Layout (the reference's ops.py:25): q [B, T, H, D], k and v [B, S, KV, D],
// KV dividing H; query head h reads KV head h / (H / KV) in place, with no
// repeated copy of K and V. Out: o [B, T, H, D] in q's dtype and the
// float32 log-sum-exp of every row, lse [B, H, T], which the backward uses.
// Masks, with qpos = q_offset + t and kpos = s:
//   kpos < S,  causal: qpos >= kpos,  window > 0: qpos - kpos < window.
// Masked scores are -1e30 (not -inf), V rows past S are zeroed, and the
// output is acc / max(l, 1e-37), as in the Pallas kernel.
//
// Bound: operations. At the training shape (T = S = 1024, D = 128) a
// query row does 2 * 2 * S * D flops (half of them under a causal mask)
// for 2 * D * 2 bytes of its own q and o, far above the card's
// operations-per-byte balance. This first version runs on the CUDA cores
// in fp32 (inputs converted on load), not on the tensor cores, so it sits
// far above the bf16 tensor-core bound; wgmma and TMA are later work.
//
// The products use explicit fmaf: the library is built with --fmad=false
// (for the bitwise kernels beside this one), which only stops the compiler
// from contracting a separate multiply and add.
//
// Design: one CTA of 256 threads (8 warps) per (block of 64 query rows,
// head, batch). The Q block stays in shared memory; K and V tiles of 64
// keys are staged in shared memory one after the other. Warp w owns query
// rows 8w..8w+7 through the whole tile: it computes their scores (lane l
// holds key columns l and l + 32), their online-softmax state (m, l in
// registers) and their output columns (lane l holds columns l + 32 j), so
// only the tile loads need a block-wide barrier. A KV tile is skipped only
// when every (query, key) pair in it is masked (the reference's
// attention.py:138 `_band_tiles` does the same).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <int D>
constexpr int shared_floats() {
  // sQ [BQ][D], sK [BK][D + 1] (padded: lanes read 32 different keys at
  // one d), sV [BK][D], sP [BQ][BK]
  return kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int T_len, int S, int H, int KV,
                 float scale, int causal, int window, int q_offset) {
  constexpr int NJ = (D + 31) / 32;  // output columns per lane (col < D)
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * D;
  float* sV = sK + kBK * (D + 1);
  float* sP = sV + kBK * D;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;  // first of this warp's rows

  const int64_t q_row_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_row_stride = static_cast<int64_t>(KV) * D;
  const T* qb = q + (static_cast<int64_t>(b) * T_len) * q_row_stride +
                static_cast<int64_t>(h) * D;
  const T* kb = k + (static_cast<int64_t>(b) * S) * kv_row_stride +
                static_cast<int64_t>(kvh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * S) * kv_row_stride +
                static_cast<int64_t>(kvh) * D;

  // stage the Q block (rows past T are zero and never written out)
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    sQ[i] = t < T_len ? to_f32(qb[t * q_row_stride + c]) : 0.0f;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp];
  float acc[kRowsPerWarp][NJ];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.0f;
  }

  // query positions of the block, for tile skipping
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBQ, T_len) - 1;
  const int n_tiles = (S + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const int k_hi = k0 + kBK - 1;
    if (causal && k0 > q_hi) break;            // every later tile too
    if (window > 0 && k_hi <= q_lo - window) continue;

    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int s = k0 + r;
      const bool ok = s < S;
      sK[r * (D + 1) + c] = ok ? to_f32(kb[s * kv_row_stride + c]) : 0.0f;
      sV[r * D + c] = ok ? to_f32(vb[s * kv_row_stride + c]) : 0.0f;
    }
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s_acc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s_acc[r][0] = s_acc[r][1] = 0.0f;
    const float* k_a = sK + lane * (D + 1);
    const float* k_b = sK + (lane + 32) * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float ka[4], kbv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ka[u] = k_a[d + u];
        kbv[u] = k_b[d + u];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (row0 + r) * D + d);
        s_acc[r][0] = fmaf(qv.x, ka[0], s_acc[r][0]);
        s_acc[r][0] = fmaf(qv.y, ka[1], s_acc[r][0]);
        s_acc[r][0] = fmaf(qv.z, ka[2], s_acc[r][0]);
        s_acc[r][0] = fmaf(qv.w, ka[3], s_acc[r][0]);
        s_acc[r][1] = fmaf(qv.x, kbv[0], s_acc[r][1]);
        s_acc[r][1] = fmaf(qv.y, kbv[1], s_acc[r][1]);
        s_acc[r][1] = fmaf(qv.z, kbv[2], s_acc[r][1]);
        s_acc[r][1] = fmaf(qv.w, kbv[3], s_acc[r][1]);
      }
    }

    // mask, online softmax (per row: warp-wide max and sum), P to shared
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q_offset + q0 + row0 + r;
      float sv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + lane + 32 * e;
        bool valid = kpos < S;
        if (causal) valid = valid && qpos >= kpos;
        if (window > 0) valid = valid && (qpos - kpos < window);
        sv[e] = valid ? s_acc[r][e] * scale : kNegInf;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float p0 = expf(sv[0] - m_new);
      const float p1 = expf(sv[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr + sum;
      m_i[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= corr;
      sP[(row0 + r) * kBK + lane] = p0;
      sP[(row0 + r) * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V over the tile's keys (V rows past S are zero)
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float vv[4][NJ];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = lane + 32 * j;
          vv[u][j] = col < D ? sV[(c + u) * D + col] : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(sP + (row0 + r) * kBK + c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[r][j] = fmaf(pv.x, vv[0][j], acc[r][j]);
          acc[r][j] = fmaf(pv.y, vv[1][j], acc[r][j]);
          acc[r][j] = fmaf(pv.z, vv[2][j], acc[r][j]);
          acc[r][j] = fmaf(pv.w, vv[3][j], acc[r][j]);
        }
      }
    }
    __syncwarp();  // sP is rewritten by the next tile
  }

  // epilogue: normalise, write o and the log-sum-exp
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + row0 + r;
    if (t >= T_len) continue;
    const float den = fmaxf(l_i[r], 1e-37f);
    T* orow = o + (static_cast<int64_t>(b) * T_len + t) * q_row_stride +
              static_cast<int64_t>(h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (col < D) orow[col] = from_f32<T>(acc[r][j] / den);
    }
    if (lane == 0)
      lse[(static_cast<int64_t>(b) * H + h) * T_len + t] =
          m_i[r] + logf(l_i[r]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int T_len, int S, int H, int KV, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  constexpr int smem_bytes = shared_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), T_len, S, H, KV, scale, causal, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int T_len, int S, int H, int KV,
               float scale, int causal, int window, int q_offset,
               cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, T_len, S, H, KV, scale,
                           causal, window, q_offset, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, T_len, S, H, KV, scale,
                           causal, window, q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, T_len, S, H, KV, scale,
                           causal, window, q_offset, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, lse, B, T_len, S, H, KV, scale,
                           causal, window, q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, T_len, S, H, KV, scale,
                            causal, window, q_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns the CUDA error code of the
// launch (0 on success). dtype: 0 float32, 1 bfloat16 (q, k, v and o).
// window <= 0 means no window. All tensors contiguous, device pointers.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int dtype, int B, int T_len,
                        int S, int H, int KV, int D, int causal, int window,
                        int q_offset, float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, lse, B, T_len, S, H, KV, scale,
                             causal, window, q_offset, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, T_len, S, H,
                                     KV, scale, causal, window, q_offset,
                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
