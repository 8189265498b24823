// Direct-transmission (DT) candidate scoring for VEDS: Proposition 1's
// closed-form power and the objective (21a), one candidate per thread.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/veds_score/veds_score.py:25 (`veds_dt_score_pallas`).
// Over the flattened candidate grid, with a = g / noise:
//   p = clip(V w kappa bw / ln2 / max(q kappa, 1e-9) - 1 / max(a, 1e-30), 0, p_max)
//   z = kappa bw log1p(p a) / ln2
//   y = V w z - q kappa p
// and where !(e && g > 0): y = -1e30, p = z = 0.
//
// Bound: bytes. Each candidate reads 13 bytes (three fp32 and one bool
// byte) and writes 12 (three fp32) for some 20 fp32 operations, far
// below the card's operations-per-byte balance. The design follows from
// that: one pass, one thread per candidate in a grid-stride loop,
// neighbouring threads on neighbouring addresses so every load and store
// coalesces, nothing staged in shared memory.
//
// On the main path the grid is small: [B, S] = [3, 10] candidates a slot
// in the CNN block, [1, 4] in the VFL rounds. There the launch, not the
// bytes, is the cost, so the block shrinks to the candidates (one warp
// for up to 32) and the VEDS round replays the slot step, this launch
// included, from a CUDA graph (src/repro_torch/core/veds.py). The launch
// is capture-safe: it goes on the caller's stream and allocates nothing.
// A graph's replays do not pass through the host wrapper, so the kernel
// counts its own runs: where `count` is not null, one thread adds one to
// it each time the kernel runs, eagerly or as a graph's node.
//
// Numerics: the arithmetic runs in the order of the reference and of the
// plain PyTorch version, with IEEE division and log1pf. Build without
// --use_fast_math and with --fmad=false, so no multiply-add is contracted.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg = -1e30f;

__global__ void veds_score_kernel(const float* __restrict__ g,
                                  const float* __restrict__ q,
                                  const float* __restrict__ w,
                                  const uint8_t* __restrict__ e,
                                  float* __restrict__ y,
                                  float* __restrict__ p,
                                  float* __restrict__ z,
                                  int64_t n, float V, float kappa, float bw,
                                  float noise, float p_max,
                                  unsigned long long* __restrict__ count) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(count, 1ULL);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    const float qi = q[i];
    const float wi = w[i];
    const float a = gi / noise;
    const float cw = V * wi * kappa * bw / kLn2;
    const float q_eff = fmaxf(qi * kappa, 1e-9f);
    float pi = cw / q_eff - 1.0f / fmaxf(a, 1e-30f);
    pi = fminf(fmaxf(pi, 0.0f), p_max);
    const float rate = bw * log1pf(pi * a) / kLn2;
    const float zi = kappa * rate;
    const float yi = V * wi * zi - qi * kappa * pi;
    const bool valid = (e[i] != 0) && (gi > 0.0f);
    y[i] = valid ? yi : kNeg;
    p[i] = valid ? pi : 0.0f;
    z[i] = valid ? zi : 0.0f;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() of the
// launch (0 on success). Pointers are device pointers of n elements;
// `count` is a device counter of the kernel's runs, or null.
int veds_score_f32(const void* g, const void* q, const void* w,
                   const void* e, void* y, void* p, void* z, int64_t n,
                   float V, float kappa, float bw, float noise, float p_max,
                   void* count, void* stream) {
  if (n <= 0) return 0;
  // whole warps, no more than the candidates need, at most 256
  const int threads = n < 256 ? static_cast<int>((n + 31) / 32 * 32) : 256;
  int64_t blocks = (n + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest
  if (blocks > 132 * 64) blocks = 132 * 64;
  veds_score_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(q),
      static_cast<const float*>(w), static_cast<const uint8_t*>(e),
      static_cast<float*>(y), static_cast<float*>(p),
      static_cast<float*>(z), n, V, kappa, bw, noise, p_max,
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
