// The Mamba2/SSD chunked scan, forward: per (batch row, head) the
// scalar-decay linear recurrence
//   S_t = exp(la_t) S_{t-1} + b_t v_t^T,   y_t = c_t . S_t,
// in chunks of C steps, with the [N, P] float32 state carried from chunk
// to chunk.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/ssd_scan/ssd_scan.py:22 (`ssd_scan_pallas`, called
// through `ops.py:ssd_scan_tpu`), and runs where the reference's model
// computes the same function with the jnp scan `_ssd_chunk_scan`
// (src/repro/models/blocks.py:322). Per chunk, as the Pallas kernel:
//   cum = cumsum(la)
//   W_ij = (c_i . b_j) exp(cum_i - cum_j) for j <= i, else 0
//   y = W v + exp(cum) o (c S)
//   S <- exp(cum_C) S + sum_j (exp(cum_C - cum_j) b_j) v_j^T
// Layout, the model's: v [B, T, H, P], b and c [B, T, N] shared by the H
// heads of a batch row (head h of row r reads b and c of row r in place;
// the Pallas layout [BH, T, N] is H = 1), log_a [B, T, H] float32, y
// [B, T, H, P] in v's dtype, state0 (optional) and the final state
// [B, H, N, P] float32. T is a multiple of C (the wrapper pads).
//
// Bound: bytes. At the training shape (B 4, T 1024, H 80, N = P = 64,
// C 128, bf16) the scan reads v and writes y (42 MB each) for about
// 6.3 MFLOP per (row, head, chunk), below the card's operations-per-byte
// balance at the bf16 tensor-core rate. This version runs fp32 inputs with
// fp32 FMAs on the CUDA cores, where the fp32 tolerances hold; bf16 inputs
// run on the tensor cores in ssd_scan_sm90.cu.
//
// Design: one CTA of 256 threads per (head, batch row), walking the
// chunks in order. A chunk's v, b and c (converted to fp32), its cumsum
// and the intra-chunk weights W live in shared memory (221,696 bytes at
// C = 128, one CTA per SM); the state lives in registers, 16 entries a thread, and
// is copied to shared memory for the next chunk's y. Three register-tiled
// products per chunk, each thread on a small output tile:
//   W [C, C] = C B^T (masked, decayed), 8 x 8 entries a thread;
//   y [C, P] = W V + exp(cum) (C S): two blocks of C / 32 rows a thread,
//     one from the top and one from the bottom of the chunk, so that the
//     causal loop over j costs every thread the same;
//   S [N, P] = exp(cum_C) S + Beff^T V, 4 x 4 entries a thread.
// The products use explicit fmaf (the library is built with --fmad=false
// for the bitwise kernels beside this one). No exponential of a positive
// number is evaluated: above the diagonal W is 0 by a select, where the
// exponent cum_i - cum_j would be >= 0 and, once a chunk's decays sum past
// ~88, exp would overflow (the reference model's jnp scan multiplies the
// mask after that exp and gets 0 * inf = NaN there; the Pallas kernel
// selects, as here).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// K consecutive floats of shared memory to registers and back, as one
// vector access where K allows (the address is K * 4 byte aligned)
template <int K>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (K == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = p[k];
  }
}
template <int K>
__device__ __forceinline__ void sts(float* p, const float* in) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = in[k];
  }
}

template <int C, int N, int P>
struct Shape {
  static constexpr int CP = C + 4;   // row of sBt, sCt, sWT (16 B aligned)
  static constexpr int NB = N + 8;   // row of sBeff (no bank conflicts on
                                     // the transposing store)
  // offsets in floats; every array starts 16 B aligned
  static constexpr int kV = 0;                    // sV    [C][P]
  static constexpr int kBt = kV + C * P;          // sBt   [N][CP]
  static constexpr int kCt = kBt + N * CP;        // sCt   [N][CP]
  static constexpr int kWT = kCt + N * CP;        // sWT   [C][CP]: W^T
  static constexpr int kS = kWT + C * CP;         // sS    [N][P]
  static constexpr int kBeff = kS + N * P;        // sBeff [C][NB]
  static constexpr int kCum = kBeff + C * NB;     // sCum  [C]
  static constexpr int floats = kCum + C;
  static constexpr int bytes = floats * 4;
};

template <int C, int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ v, const float* __restrict__ b,
                const float* __restrict__ c, const float* __restrict__ log_a,
                const float* __restrict__ state0, float* __restrict__ y,
                float* __restrict__ state_out, int T_len, int H) {
  using S = Shape<C, N, P>;
  static_assert(C % 32 == 0 && C <= 128, "C a multiple of 32, at most 128");
  static_assert(N % 16 == 0 && P % 16 == 0 && N <= 64 && P <= 64,
                "N, P multiples of 16, at most 64");
  // W tile: R x R entries a thread, in G groups of Q contiguous rows
  // (columns) spaced C / G apart, so that 16 threads read 16 * Q
  // contiguous floats
  constexpr int R = C / 16;
  constexpr int Q = R < 4 ? R : 4;
  constexpr int G = R / Q;
  constexpr int GS = C / G;
  constexpr int H2 = R / 2;    // y: rows per block (two blocks a thread)
  constexpr int PC = P / 16;   // y and S: columns a thread
  constexpr int NR = N / 16;   // S: rows a thread
  constexpr int CP = S::CP, NB = S::NB;

  extern __shared__ __align__(16) float smem[];
  float* sV = smem + S::kV;
  float* sBt = smem + S::kBt;
  float* sCt = smem + S::kCt;
  float* sWT = smem + S::kWT;
  float* sS = smem + S::kS;
  float* sBeff = smem + S::kBeff;
  float* sCum = smem + S::kCum;

  const int h = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int lo = tid % 16, hi = tid / 16;
  const int64_t vrow = static_cast<int64_t>(H) * P;  // v, y: per step
  const float* vb = v + static_cast<int64_t>(row) * T_len * vrow +
                    static_cast<int64_t>(h) * P;
  float* ybase = y + static_cast<int64_t>(row) * T_len * vrow +
                 static_cast<int64_t>(h) * P;
  const float* bb = b + static_cast<int64_t>(row) * T_len * N;
  const float* cb = c + static_cast<int64_t>(row) * T_len * N;
  const float* lb = log_a + static_cast<int64_t>(row) * T_len * H + h;

  // the state, S[n][p] for n = lo * NR + r, p = hi * PC + u
  float st[NR][PC];
  const int64_t soff = (static_cast<int64_t>(row) * H + h) * N * P;
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int u = 0; u < PC; ++u)
      st[r][u] = state0 ? state0[soff + (lo * NR + r) * P + hi * PC + u]
                        : 0.0f;
#pragma unroll
  for (int r = 0; r < NR; ++r) sts<PC>(sS + (lo * NR + r) * P + hi * PC,
                                       st[r]);

  const int n_chunks = T_len / C;
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * C;
    // ---- load the chunk: v row-major; b and c transposed, lanes on 8
    // states x 4 steps so that the transposing stores hit 32 banks; b
    // row-major too (scaled by the tail decay below); raw log_a
    for (int i = tid; i < C * P; i += kThreads) {
      const int t = i / P, p = i % P;
      sV[i] = vb[(t0 + t) * vrow + p];
    }
    for (int i = tid; i < C * N; i += kThreads) {
      const int blk = i / 32, lane = i % 32;
      const int n = (blk % (N / 8)) * 8 + lane % 8;
      const int t = (blk / (N / 8)) * 4 + lane / 8;
      const int64_t g = static_cast<int64_t>(t0 + t) * N + n;
      const float bv = bb[g];
      sBt[n * CP + t] = bv;
      sBeff[t * NB + n] = bv;
      sCt[n * CP + t] = cb[g];
    }
    for (int t = tid; t < C; t += kThreads)
      sCum[t] = lb[static_cast<int64_t>(t0 + t) * H];
    __syncthreads();

    // ---- cumsum of the chunk's log decays, by warp 0: C / 32
    // consecutive steps a lane, then a scan of the lanes' totals
    if (tid < 32) {
      constexpr int E = C / 32;
      float part[E];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += sCum[tid * E + e];
        part[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) sCum[tid * E + e] = excl + part[e];
    }
    __syncthreads();
    const float cum_last = sCum[C - 1];

    // ---- Beff[j][n] = b[j][n] exp(cum_C - cum_j)
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N, n = i % N;
      sBeff[t * NB + n] *= expf(fminf(cum_last - sCum[t], 0.0f));
    }

    // ---- W^T: thread (hi, lo) owns rows hi and columns lo of the tile
    {
      float acc[R][R];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < R; ++s) acc[r][s] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[R], bv[R];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          lds<Q>(sCt + n * CP + g * GS + hi * Q, cv + g * Q);
          lds<Q>(sBt + n * CP + g * GS + lo * Q, bv + g * Q);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int s = 0; s < R; ++s) acc[r][s] = fmaf(cv[r], bv[s],
                                                       acc[r][s]);
      }
      float cum_i[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        cum_i[r] = sCum[(r / Q) * GS + hi * Q + r % Q];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int j = (s / Q) * GS + lo * Q + s % Q;
        const float cum_j = sCum[j];
        float wcol[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = (r / Q) * GS + hi * Q + r % Q;
          // masked by a select, and the exponent clamped to <= 0: the
          // sequential cumsum never lets cum_i exceed cum_j for i >= j,
          // this parallel one may by an ulp
          wcol[r] = i >= j ? acc[r][s] * expf(fminf(cum_i[r] - cum_j, 0.0f))
                           : 0.0f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          sts<Q>(sWT + j * CP + g * GS + hi * Q, wcol + g * Q);
      }
    }
    __syncthreads();

    // ---- y = W v + exp(cum) o (c S): rows rA.. and rB.. (H2 each),
    // columns lo * PC..
    {
      const int rA = hi * H2, rB = C - (hi + 1) * H2;
      float ya[H2][PC], ybl[H2][PC], za[H2][PC], zb[H2][PC];
#pragma unroll
      for (int r = 0; r < H2; ++r)
#pragma unroll
        for (int u = 0; u < PC; ++u)
          ya[r][u] = ybl[r][u] = za[r][u] = zb[r][u] = 0.0f;
      // rA + H2 <= C / 2 <= rB: the first loop feeds both blocks
      for (int j = 0; j < rA + H2; ++j) {
        float wa[H2], wb[H2], vv[PC];
        lds<H2>(sWT + j * CP + rA, wa);
        lds<H2>(sWT + j * CP + rB, wb);
        lds<PC>(sV + j * P + lo * PC, vv);
#pragma unroll
        for (int r = 0; r < H2; ++r)
#pragma unroll
          for (int u = 0; u < PC; ++u) {
            ya[r][u] = fmaf(wa[r], vv[u], ya[r][u]);
            ybl[r][u] = fmaf(wb[r], vv[u], ybl[r][u]);
          }
      }
      for (int j = rA + H2; j < rB + H2; ++j) {
        float wb[H2], vv[PC];
        lds<H2>(sWT + j * CP + rB, wb);
        lds<PC>(sV + j * P + lo * PC, vv);
#pragma unroll
        for (int r = 0; r < H2; ++r)
#pragma unroll
          for (int u = 0; u < PC; ++u)
            ybl[r][u] = fmaf(wb[r], vv[u], ybl[r][u]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float ca[H2], cbv[H2], ss[PC];
        lds<H2>(sCt + n * CP + rA, ca);
        lds<H2>(sCt + n * CP + rB, cbv);
        lds<PC>(sS + n * P + lo * PC, ss);
#pragma unroll
        for (int r = 0; r < H2; ++r)
#pragma unroll
          for (int u = 0; u < PC; ++u) {
            za[r][u] = fmaf(ca[r], ss[u], za[r][u]);
            zb[r][u] = fmaf(cbv[r], ss[u], zb[r][u]);
          }
      }
#pragma unroll
      for (int r = 0; r < H2; ++r) {
        const float ea = expf(sCum[rA + r]), eb = expf(sCum[rB + r]);
        float* outa =
            ybase + static_cast<int64_t>(t0 + rA + r) * vrow + lo * PC;
        float* outb =
            ybase + static_cast<int64_t>(t0 + rB + r) * vrow + lo * PC;
#pragma unroll
        for (int u = 0; u < PC; ++u) {
          outa[u] = ya[r][u] + ea * za[r][u];
          outb[u] = ybl[r][u] + eb * zb[r][u];
        }
      }
    }

    // ---- S <- exp(cum_C) S + Beff^T V: rows lo * NR.., columns hi * PC..
    {
      float acc[NR][PC];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int u = 0; u < PC; ++u) acc[r][u] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        float be[NR], vv[PC];
        lds<NR>(sBeff + j * NB + lo * NR, be);
        lds<PC>(sV + j * P + hi * PC, vv);
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int u = 0; u < PC; ++u) acc[r][u] = fmaf(be[r], vv[u],
                                                        acc[r][u]);
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int u = 0; u < PC; ++u) st[r][u] = decay * st[r][u] + acc[r][u];
    }
    __syncthreads();  // every read of sS and of the chunk is done
#pragma unroll
    for (int r = 0; r < NR; ++r) sts<PC>(sS + (lo * NR + r) * P + hi * PC,
                                         st[r]);
  }

#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int u = 0; u < PC; ++u)
      state_out[soff + (lo * NR + r) * P + hi * PC + u] = st[r][u];
}

template <int C, int N, int P>
int launch(const void* v, const void* b, const void* c, const float* log_a,
           const float* state0, void* y, float* state_out, int B,
           int T_len, int H, cudaStream_t stream) {
  constexpr int smem_bytes = Shape<C, N, P>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<C, N, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(H, B);
  ssd_scan_kernel<C, N, P><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(v), static_cast<const float*>(b),
      static_cast<const float*>(c), log_a, state0, static_cast<float*>(y),
      state_out, T_len, H);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int chunk, const void* v, const void* b, const void* c,
             const float* log_a, const float* state0, void* y,
             float* state_out, int B, int T_len, int H,
             cudaStream_t stream) {
  switch (chunk) {
    case 32:
      return launch<32, 64, 64>(v, b, c, log_a, state0, y, state_out, B,
                                T_len, H, stream);
    case 128:
      return launch<128, 64, 64>(v, b, c, log_a, state0, y, state_out,
                                 B, T_len, H, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream` and returns the CUDA error code of the
// launch (0 on success). v, b, c and y float32 (bf16 inputs go to
// ssd_scan_sm90.cu's tensor-core kernel instead); log_a, state0 (may be
// null: a zero state) and state_out float32. The kernel is compiled for
// N = P = 64 and chunk in {32, 128}; T must be a multiple of the chunk.
// All tensors contiguous, device pointers.
int ssd_scan_fwd_f32(const void* v, const void* b, const void* c,
                     const void* log_a, const void* state0, void* y,
                     void* state_out, int B, int T_len, int H, int N, int P,
                     int chunk, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (N != 64 || P != 64 || chunk <= 0 || T_len <= 0 ||
      T_len % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(chunk, v, b, c, static_cast<const float*>(log_a),
                  static_cast<const float*>(state0), y,
                  static_cast<float*>(state_out), B, T_len, H,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
