// Masked weighted FedAvg aggregation (eq. 11), one pass over the leaf.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/fedavg_agg/fedavg_agg.py:20 (`fedavg_agg_pallas`,
// called through `ops.py:fedavg_agg_tpu` and `fedavg_agg_tree`). With
// x [V, L] the vehicle-stacked flat parameters, w [V] the weights
// (mask * |D_m|) and old [L] the previous global parameters:
//   den    = sum_v w[v]                         (ascending v, fp32)
//   out[l] = sum_v w[v] x[v, l] / max(den, 1e-9)   if den > 0
//   out[l] = old[l]                                 otherwise
// accumulated in fp32 in ascending v, written in x's dtype (fp32 or bf16).
// den is computed on the device by every block from w, so the caller
// never synchronises with the host; old is read only when den == 0.
//
// Bound: bytes. Each element costs V reads of x and one write (plus one
// read of old when every upload failed) for 2V + 1 fp32 operations, far
// below the card's operations-per-byte balance. So: one pass, each thread
// on VEC neighbouring elements with 16-byte vector loads and stores where
// L and the pointers allow it (8 bf16 or 4 fp32 values; one element at a
// time otherwise), a grid-stride loop, nothing staged but the V weights.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxV = 1024;  // weights staged in shared memory

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
  return __float2bfloat16(x);
}

// VEC elements of T moved as one 16-byte word (or one element if VEC==1)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const T* __restrict__ old, T* __restrict__ out, int V,
                  int64_t L) {
  __shared__ float sw[kMaxV];
  for (int i = threadIdx.x; i < V; i += blockDim.x) sw[i] = w[i];
  __syncthreads();
  float den = 0.0f;
  for (int v = 0; v < V; ++v) den += sw[v];
  const float div = fmaxf(den, 1e-9f);
  const bool keep_old = !(den > 0.0f);

  using P = Pack<T, VEC>;
  const int64_t n_packs = L / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  for (int64_t i = first; i < n_packs; i += stride) {
    P res;
    if (keep_old) {
      res = reinterpret_cast<const P*>(old)[i];
    } else {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
      for (int v = 0; v < V; ++v) {
        const P xv = reinterpret_cast<const P*>(x + v * L)[i];
        const float wv = sw[v];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += wv * to_f32(xv.v[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) res.v[e] = from_f32<T>(acc[e] / div);
    }
    reinterpret_cast<P*>(out)[i] = res;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, const void* w, const void* old, void* out, int V,
           int64_t L, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = L % kVec == 0 && aligned16(x) && aligned16(old) &&
                   aligned16(out);
  const int64_t work = vec ? L / kVec : L;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  // a few waves of 132 SMs; the grid-stride loop covers the rest
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec)
    fedavg_agg_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const T*>(old), static_cast<T*>(out), V, L);
  else
    fedavg_agg_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const T*>(old), static_cast<T*>(out), V, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the aggregation on `stream` and returns the CUDA error code of
// the launch (0 on success). dtype: 0 float32, 1 bfloat16 (x, old, out);
// w is float32. x [V, L], old and out [L], contiguous device pointers.
int fedavg_agg(const void* x, const void* w, const void* old, void* out,
               int dtype, int V, int64_t L, void* stream) {
  if (L <= 0) return 0;
  if (V <= 0 || V > kMaxV) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, old, out, V, L, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, old, out, V, L, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
