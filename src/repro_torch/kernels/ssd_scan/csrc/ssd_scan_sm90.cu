// The Mamba2/SSD chunked scan, forward, bf16, on the tensor cores: per
// (batch row, head) the scalar-decay linear recurrence
//   S_t = exp(la_t) S_{t-1} + b_t v_t^T,   y_t = c_t . S_t,
// in chunks of C steps, with the [N, P] float32 state carried from chunk to
// chunk. The bf16 counterpart of ssd_scan.cu (which keeps the fp32 inputs
// on CUDA cores).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/ssd_scan/ssd_scan.py:22 (`ssd_scan_pallas`, called
// through `ops.py:ssd_scan_tpu`), where the reference's model computes the
// same function with the jnp scan `_ssd_chunk_scan`
// (src/repro/models/blocks.py:322). Per chunk, as the Pallas kernel:
//   cum = cumsum(la)
//   W_ij = (c_i . b_j) exp(cum_i - cum_j) for j <= i, else 0 (a select)
//   y = W v + exp(cum) o (c S)
//   S <- exp(cum_C) S + sum_j (exp(cum_C - cum_j) b_j) v_j^T
// with every exponent of a decay between two steps clamped to <= 0. Layout,
// the model's: v [B, T, H, P], b and c [B, T, N] shared by the H heads of a
// batch row, log_a [B, T, H] float32, y [B, T, H, P] bf16, state0
// (optional) and the final state [B, H, N, P] float32. T is a multiple of
// C (the wrapper pads). N = P = 64, C in {32, 128}.
//
// Bound: bytes (v in, y out: 84 MB of 91.5 at the training shape, for
// 16 GFLOP, far below the tensor cores' balance). So the design keeps every
// byte on chip once loaded and the state on chip across chunks, and puts
// the products on the tensor cores so they do not become the limit:
//
// One CTA of 256 threads (8 warps) per (head, batch row), walking the
// chunks in order; 100,352 bytes of shared memory at C = 128 and at most
// 128 registers a thread, so two CTAs share an SM. v and b of the next
// chunk (and log_a) are loaded by cp.async into a second buffer while the
// current chunk computes; c, single-buffered, is loaded as soon as the
// current chunk's last product that reads it is done. v, b and c stay bf16
// in shared memory (they are exact bf16 inputs), in rows of 128 bytes with
// 16-byte chunks swizzled by the row, so that ldmatrix reads conflict-free.
// The four products run as mma.sync m16n8k16 (bf16 in, fp32 accumulate):
//   C B^T           both operands exact: one product. Warp w owns rows
//                   16w.. of the chunk (at C = 32 four warps share a row
//                   block and split P) and computes its row block of C B^T
//                   one 16-column block at a time, up to its diagonal;
//   W V             W = (C B^T) o decay, fp32, enters as A from registers
//                   (the accumulator layout of C B^T is the A fragment
//                   layout) split into hi = bf16(W) and lo = bf16(W - hi):
//                   two products, ~16 significant bits;
//   C S             S split the same way, from shared memory;
//   Beff^T V        Beff = b o exp(cum_C - cum_j), made in registers from
//                   b's ldmatrix fragments, split hi / lo; the state's
//                   accumulator stays in registers (16 entries a thread).
#include <cstdint>

#include "csrc/hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;  // 8 warps
constexpr int kN = 64;         // state size
constexpr int kP = 64;         // head dim
constexpr int kRow = 128;      // bytes of a 64-wide bf16 row in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of 16-byte chunk `ch` of row `r` in a swizzled tile
__device__ __forceinline__ int swz(int r, int ch) {
  return r * kRow + ((ch ^ (r & 7)) << 4);
}

// e^x for x <= 0 (or a decay that does not overflow), on the SFU
__device__ __forceinline__ float exp_e(float x) { return ex2(x * kLog2e); }

template <int C>
struct Layout {
  static constexpr int TILE = C * kRow;        // a chunk of v, b or c
  static constexpr int V = 0;                  // sV[2]
  static constexpr int B = V + 2 * TILE;       // sB[2]
  static constexpr int CC = B + 2 * TILE;      // sC
  static constexpr int S_HI = CC + TILE;       // state hi [N][P] bf16
  static constexpr int S_LO = S_HI + kN * kRow;
  static constexpr int LA = S_LO + kN * kRow;  // log_a [2][C]
  static constexpr int CUM = LA + 2 * C * 4;   // cumsum [C]
  static constexpr int TAIL = CUM + C * 4;     // exp(cum_C - cum_j) [C]
  static constexpr int BYTES = TAIL + C * 4;
};

// cp.async of one chunk's rows of a [rows][64] bf16 array (row stride
// `stride` elements) into a swizzled tile
template <int C>
__device__ __forceinline__ void load_rows(uint8_t* tile,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int tid) {
#pragma unroll
  for (int i = tid; i < C * 8; i += kThreads) {
    const int r = i / 8, ch = i % 8;
    cp_async16(tile + swz(r, ch), src + r * stride + ch * 8);
  }
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_sm90_kernel(const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ b,
                     const __nv_bfloat16* __restrict__ c,
                     const float* __restrict__ log_a,
                     const float* __restrict__ state0,
                     __nv_bfloat16* __restrict__ y,
                     float* __restrict__ state_out, int T_len, int H) {
  using L = Layout<C>;
  constexpr int RB = C / 16;      // row blocks of y
  constexpr int WPR = 8 / RB;     // warps a row block
  constexpr int PB = 4 / WPR;     // 16-column blocks of y a warp
  static_assert(C == 32 || C == 128, "C in {32, 128}");

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sV = smem + L::V;
  uint8_t* sB = smem + L::B;
  uint8_t* sC = smem + L::CC;
  uint8_t* sShi = smem + L::S_HI;
  uint8_t* sSlo = smem + L::S_LO;
  float* sLa = reinterpret_cast<float*>(smem + L::LA);
  float* sCum = reinterpret_cast<float*>(smem + L::CUM);
  float* sTail = reinterpret_cast<float*>(smem + L::TAIL);

  const int h = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q = lane / 8, r8 = lane % 8;  // ldmatrix: matrix, row
  const int64_t vstride = static_cast<int64_t>(H) * kP;  // v, y: per step
  const __nv_bfloat16* vb = v + static_cast<int64_t>(row) * T_len * vstride +
                            static_cast<int64_t>(h) * kP;
  __nv_bfloat16* yb = y + static_cast<int64_t>(row) * T_len * vstride +
                      static_cast<int64_t>(h) * kP;
  const __nv_bfloat16* bb = b + static_cast<int64_t>(row) * T_len * kN;
  const __nv_bfloat16* cb = c + static_cast<int64_t>(row) * T_len * kN;
  const float* lb = log_a + static_cast<int64_t>(row) * T_len * H + h;

  auto load_vb = [&](int k, int buf) {
    const int t0 = k * C;
    load_rows<C>(sV + buf * L::TILE, vb + t0 * vstride, vstride, tid);
    load_rows<C>(sB + buf * L::TILE, bb + static_cast<int64_t>(t0) * kN,
                 kN, tid);
    if (tid < C)
      cp_async4(sLa + buf * C + tid,
                lb + static_cast<int64_t>(t0 + tid) * H);
  };
  auto load_c = [&](int k) {
    load_rows<C>(sC, cb + static_cast<int64_t>(k) * C * kN, kN, tid);
  };

  // the state: rows n = 16 mb + g (+8) and columns p = 16 (pb0 + i) + 8 j
  // + 2 t4 (+1) of S, i, j in {0, 1}, as mma accumulators st[i][j][e]
  const int mb = warp % 4, pb0 = 2 * (warp / 4);
  float st[2][2][4];
  const int64_t soff = (static_cast<int64_t>(row) * H + h) * kN * kP;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * mb + g + 8 * (e >> 1);
        const int p = 16 * (pb0 + i) + 8 * j + 2 * t4 + (e & 1);
        st[i][j][e] = state0 ? state0[soff + n * kP + p] : 0.0f;
      }
  // S as hi and lo bf16 in shared memory, the B operand of C S
  auto store_state = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int n = 16 * mb + g + 8 * (e >> 1);
          const int p = 16 * (pb0 + i) + 8 * j + 2 * t4;
          uint32_t hi, lo;
          split_bf16(st[i][j][e], st[i][j][e + 1], hi, lo);
          const int off = swz(n, p / 8) + (p % 8) * 2;
          *reinterpret_cast<uint32_t*>(sShi + off) = hi;
          *reinterpret_cast<uint32_t*>(sSlo + off) = lo;
        }
  };
  store_state();

  load_vb(0, 0);
  load_c(0);
  cp_async_commit();

  const int n_chunks = T_len / C;
  const int rb = warp % RB;              // this warp's row block of y
  const int yp0 = (warp / RB) * PB;      // its first 16-column block
  for (int k = 0; k < n_chunks; ++k) {
    const int cur = k & 1;
    const uint8_t* vcur = sV + cur * L::TILE;
    const uint8_t* bcur = sB + cur * L::TILE;
    if (k + 1 < n_chunks) load_vb(k + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk k's v, b, log_a and c have landed
    __syncthreads();

    // ---- cumsum of the chunk's log decays, by warp 0: C / 32 steps a
    // lane, then a scan of the lanes' totals; and the tail decays
    if (warp == 0) {
      constexpr int E = C / 32;
      float part[E];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += sLa[cur * C + lane * E + e];
        part[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float cum = excl + part[e];
        sCum[lane * E + e] = cum;
        sTail[lane * E + e] = exp_e(fminf(total - cum, 0.0f));
      }
    }
    __syncthreads();
    const float cum_last = sCum[C - 1];

    // ---- y of rows 16 rb.. and columns 16 yp0..: c of the row block as
    // A fragments, one per 16 states
    uint32_t ca[4][4];
#pragma unroll
    for (int kn = 0; kn < 4; ++kn)
      ldmatrix_x4(ca[kn], sC + swz(16 * rb + (q % 2) * 8 + r8, 2 * kn + q / 2));
    float acc[PB][2][4];
#pragma unroll
    for (int i = 0; i < PB; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    // C S, S as hi + lo
#pragma unroll
    for (int kn = 0; kn < 4; ++kn)
#pragma unroll
      for (int i = 0; i < PB; ++i) {
        const int off = swz(16 * kn + (q % 2) * 8 + r8, 2 * (yp0 + i) + q / 2);
        uint32_t fh[4], fl[4];
        ldmatrix_x4_trans(fh, sShi + off);
        ldmatrix_x4_trans(fl, sSlo + off);
        mma_bf16_16816(acc[i][0], ca[kn], fh);
        mma_bf16_16816(acc[i][1], ca[kn], fh + 2);
        mma_bf16_16816(acc[i][0], ca[kn], fl);
        mma_bf16_16816(acc[i][1], ca[kn], fl + 2);
      }
    const int i0 = 16 * rb + g;  // this thread's rows: i0 and i0 + 8
    const float cum_i[2] = {sCum[i0], sCum[i0 + 8]};
    {
      const float e0 = exp_e(cum_i[0]), e1 = exp_e(cum_i[1]);
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[i][j][0] *= e0;
          acc[i][j][1] *= e0;
          acc[i][j][2] *= e1;
          acc[i][j][3] *= e1;
        }
    }
    // W V, one 16-column block of W at a time up to the diagonal
    for (int jk = 0; jk <= rb; ++jk) {
      float gacc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[j][e] = 0.0f;
#pragma unroll
      for (int kn = 0; kn < 4; ++kn) {
        uint32_t fb[4];
        ldmatrix_x4(fb, bcur + swz(16 * jk + (q / 2) * 8 + r8, 2 * kn + q % 2));
        mma_bf16_16816(gacc[0], ca[kn], fb);
        mma_bf16_16816(gacc[1], ca[kn], fb + 2);
      }
      // W = (c . b) exp(cum_i - cum_j) for j <= i, else 0 by a select
      uint32_t wh[4], wl[4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int ii = i0 + 8 * (e >> 1);
          float w[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int jj = 16 * jk + 8 * j + 2 * t4 + u;
            const float dec =
                exp_e(fminf(cum_i[e >> 1] - sCum[jj], 0.0f));
            w[u] = ii >= jj ? gacc[j][e + u] * dec : 0.0f;
          }
          // A fragment: a0 (row g, cols 0-7), a1 (row g + 8, cols 0-7),
          // a2 (row g, cols 8-15), a3 (row g + 8, cols 8-15)
          split_bf16(w[0], w[1], wh[2 * j + (e >> 1)], wl[2 * j + (e >> 1)]);
        }
#pragma unroll
      for (int i = 0; i < PB; ++i) {
        uint32_t fv[4];
        ldmatrix_x4_trans(
            fv, vcur + swz(16 * jk + (q % 2) * 8 + r8, 2 * (yp0 + i) + q / 2));
        mma_bf16_16816(acc[i][0], wh, fv);
        mma_bf16_16816(acc[i][1], wh, fv + 2);
        mma_bf16_16816(acc[i][0], wl, fv);
        mma_bf16_16816(acc[i][1], wl, fv + 2);
      }
    }
    __syncthreads();  // every read of c and of the state is done
    if (k + 1 < n_chunks) load_c(k + 1);
    cp_async_commit();

    {
      __nv_bfloat16* yrow = yb + static_cast<int64_t>(k * C + i0) * vstride;
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = 16 * (yp0 + i) + 8 * j + 2 * t4;
          *reinterpret_cast<uint32_t*>(yrow + p) =
              pack_bf16(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<uint32_t*>(yrow + 8 * vstride + p) =
              pack_bf16(acc[i][j][2], acc[i][j][3]);
        }
    }

    // ---- S <- exp(cum_C) S + Beff^T V, Beff = b o tail as hi + lo
    {
      const float decay = exp_e(cum_last);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][j][e] *= decay;
#pragma unroll 2
      for (int jk = 0; jk < C / 16; ++jk) {
        uint32_t fb[4];  // b^T: a0 (n 0-7, j 0-7), a1 (n 8-15, j 0-7), ...
        ldmatrix_x4_trans(fb,
                          bcur + swz(16 * jk + (q / 2) * 8 + r8, 2 * mb + q % 2));
        const int j0 = 16 * jk + 2 * t4;
        const float tl[4] = {sTail[j0], sTail[j0 + 1], sTail[j0 + 8],
                             sTail[j0 + 9]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float2 x = unpack(fb[a]);
          const int o = (a / 2) * 2;  // a0, a1: j0; a2, a3: j0 + 8
          split_bf16(x.x * tl[o], x.y * tl[o + 1], ah[a], al[a]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t fv[4];
          ldmatrix_x4_trans(
              fv, vcur + swz(16 * jk + (q % 2) * 8 + r8, 2 * (pb0 + i) + q / 2));
          mma_bf16_16816(st[i][0], ah, fv);
          mma_bf16_16816(st[i][1], ah, fv + 2);
          mma_bf16_16816(st[i][0], al, fv);
          mma_bf16_16816(st[i][1], al, fv + 2);
        }
      }
    }
    store_state();  // the state's old copy was last read before the barrier
    __syncthreads();  // the next chunk's loads reuse this chunk's buffers
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * mb + g + 8 * (e >> 1);
        const int p = 16 * (pb0 + i) + 8 * j + 2 * t4 + (e & 1);
        state_out[soff + n * kP + p] = st[i][j][e];
      }
}

// allows the kernel its dynamic shared memory (once)
template <int C>
cudaError_t configure() {
  static cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_sm90_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<C>::BYTES);
  return err;
}

template <int C>
int launch(const void* v, const void* b, const void* c, const float* log_a,
           const float* state0, void* y, float* state_out, int B, int T_len,
           int H, cudaStream_t stream) {
  if (configure<C>() != cudaSuccess) return static_cast<int>(configure<C>());
  const dim3 grid(H, B);
  ssd_scan_sm90_kernel<C><<<grid, kThreads, Layout<C>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), log_a, state0,
      static_cast<__nv_bfloat16*>(y), state_out, T_len, H);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int resources(int* smem_bytes, int* ctas_per_sm) {
  cudaError_t err = configure<C>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, ssd_scan_sm90_kernel<C>, kThreads, Layout<C>::BYTES);
  *smem_bytes = Layout<C>::BYTES;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The dynamic shared memory of the kernel for `chunk` and how many of its
// CTAs an SM holds; returns the CUDA error code.
int ssd_scan_bf16_sm90_resources(int chunk, int* smem_bytes,
                                 int* ctas_per_sm) {
  switch (chunk) {
    case 32: return resources<32>(smem_bytes, ctas_per_sm);
    case 128: return resources<128>(smem_bytes, ctas_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the bf16 scan on `stream` and returns the CUDA error code of the
// launch (0 on success). v, b, c and y bf16; log_a, state0 (may be null: a
// zero state) and state_out float32. N = P = 64, chunk in {32, 128}, T a
// multiple of the chunk. All tensors contiguous, device pointers 16-byte
// aligned.
int ssd_scan_fwd_bf16_sm90(const void* v, const void* b, const void* c,
                           const void* log_a, const void* state0, void* y,
                           void* state_out, int B, int T_len, int H, int N,
                           int P, int chunk, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (N != kN || P != kP || chunk <= 0 || T_len <= 0 || T_len % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  switch (chunk) {
    case 32:
      return launch<32>(v, b, c, la, s0, y, so, B, T_len, H, st);
    case 128:
      return launch<128>(v, b, c, la, s0, y, so, B, T_len, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
