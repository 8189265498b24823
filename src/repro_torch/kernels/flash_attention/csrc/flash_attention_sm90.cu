// Flash attention, forward, bf16, on Hopper's tensor cores: online-softmax
// attention with causal, sliding-window and full masks and grouped-query
// heads, fp32 accumulation. The bf16 counterpart of flash_attention.cu
// (which keeps the fp32 inputs on CUDA cores).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:29
// (`flash_attention_pallas`, called through `ops.py:flash_attention_tpu`).
// Layout (the reference's ops.py:25): q [B, T, H, D], k and v [B, S, KV, D],
// KV dividing H; query head h reads KV head h / (H / KV) in place. Out:
// o [B, T, H, D] bf16 and the float32 log-sum-exp lse [B, H, T], which the
// backward reads. Masks, with qpos = q_offset + t and kpos = s:
//   causal: qpos >= kpos,  window > 0: qpos - kpos < window.
// Masked scores are -1e30 as in the Pallas kernel, and the output is
// acc / max(l, 1e-37), rounded once to bf16. Keys past S carry no weight at
// all (the reference's ref.py has none; the Pallas kernel's padding of the
// last block would count them for a row that sees no key), so a row that
// sees no key averages v over the S keys, with lse = -1e30, as the plain
// version does. P is rounded to bf16 before the P V product: that is the
// one rounding the fp32 kernel does not make.
//
// Bound: operations at qwen3's shape (T = S = 1024, D = 128: a query row
// does 4 D flops per key it sees for 4 D bytes of its own q and o), bytes
// at zamba2's D = 80. Both need the tensor cores' rate, so:
//
// Design, after FlashAttention-3 without its ping-pong scheduling: one CTA
// of three warpgroups per (block of 128 query rows, head, batch row), the
// heaviest causal blocks launched first. Warpgroup 0 is the producer: one
// thread starts TMA loads of the Q block and of K and V tiles of 128 keys
// into a ring of two shared-memory stages, each guarded by a full and an
// empty mbarrier; the warpgroup gives its registers up (setmaxnreg 24).
// Warpgroups 1 and 2 each own 64 query rows (setmaxnreg 240). Per tile:
//   S = Q K^T       wgmma m64n128k16, Q and K K-major from shared memory;
//   mask (only on tiles that straddle a mask edge or the end of S), online
//   softmax in registers in base 2, P to bf16 in registers;
//   O += P V        wgmma m64nNk16 with P as the register A operand (the
//                   accumulator layout of S is the A fragment layout) and
//                   V MN-major from shared memory.
// K's stage is released as soon as S is computed, V's after P V. Tiles
// above the causal diagonal or wholly outside the window are never loaded.
//
// Shared-memory tiles: rows of D bf16 are cut into regions of 64 columns
// (128 bytes, the 128-byte swizzle that TMA writes and wgmma reads); at
// D = 80 the second region holds columns 64-79 and TMA fills 80-127 with
// zeros, which no product reads (S takes D / 16 = 5 k-steps, P V splits its
// N into 64 + 16). D = 16 and 32 use one region with the 32- and 64-byte
// swizzle. Tensor maps are 4-D (D, heads, rows, batch) so that rows past T
// or S read as zeros; they are encoded per call on the host with
// cuTensorMapEncodeTiled, found through the runtime.
#include <cstdint>

#include "csrc/hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;       // query rows a CTA: two warpgroups of 64
constexpr int kBK = 128;       // keys a tile
constexpr int kStages = 2;     // K and V stages in flight
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // a masked score, base 2

template <int D>
struct Cfg {
  static constexpr int COLS = D >= 64 ? 64 : D;      // columns a region
  static constexpr int REG = (D + COLS - 1) / COLS;  // regions a row
  static constexpr int ROWB = COLS * 2;              // bytes a region row
  static constexpr int SWIZZLE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int ATOM = 8 * ROWB;              // 8 swizzled rows
  static constexpr int Q_REGION = kBM * ROWB;
  static constexpr int KV_REGION = kBK * ROWB;
  static constexpr int Q_BYTES = REG * Q_REGION;
  static constexpr int KV_BYTES = REG * KV_REGION;   // one stage of K or V
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + kStages * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + kStages * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 16 * 8 + 1024;  // + alignment
  static constexpr int NO = D / 2;                   // O registers a thread
  static_assert(D % 16 == 0 && D <= 128, "D a multiple of 16, <= 128");
};

// whether the query at qpos sees no key at all
__device__ __forceinline__ bool sees_no_key(int qpos, int S, int causal,
                                            int window) {
  const int kmin = window > 0 ? max(0, qpos - window + 1) : 0;
  const int kmax = causal ? min(qpos, S - 1) : S - 1;
  return kmin > kmax;
}

// O[:, region R..] += P V for one k-step, one wgmma a region of columns
template <int D, int R>
__device__ __forceinline__ void pv_regions(float* o, const uint32_t* p,
                                           const uint8_t* v_rows) {
  using C = Cfg<D>;
  if constexpr (R < C::REG) {
    constexpr int N = D - R * C::COLS < C::COLS ? D - R * C::COLS : C::COLS;
    const uint64_t desc = make_desc(v_rows + R * C::KV_REGION, C::ATOM,
                                    C::ATOM, C::SWIZZLE);
    WgmmaRS<N>::run(o + R * C::COLS / 2, p, desc, 1);
    pv_regions<D, R + 1>(o, p, v_rows);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int T_len, int S, int H, int KV, float scale_log2,
                      int causal, int window, int q_offset) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = smem + C::OFF_K;
  uint8_t* sV = smem + C::OFF_V;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = bars + 1 + kStages;
  uint64_t* v_full = bars + 1 + 2 * kStages;
  uint64_t* v_empty = bars + 1 + 3 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // heaviest first
  const int kvh = h / (H / KV);
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBM, T_len) - 1;
  const int n_tiles = (S + kBK - 1) / kBK;
  // the tiles any row of the block sees; all of them when a row sees no
  // key, so that it averages v over every key as the plain version does
  int t_lo = 0, t_hi = n_tiles;
  if (!sees_no_key(q_lo, S, causal, window) &&
      !sees_no_key(q_hi, S, causal, window)) {
    if (causal) t_hi = min(n_tiles, q_hi / kBK + 1);
    if (window > 0) t_lo = max(0, q_lo - window + 1) / kBK;
  }
  const int n_iter = t_hi - t_lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // lane 0 of each consumer warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int r = 0; r < C::REG; ++r)
        tma_load_4d(sQ + r * C::Q_REGION, &tm_q, q_full, r * C::COLS, h, q0,
                    b);
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = (t_lo + it) * kBK;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&k_full[st], C::KV_BYTES);
        for (int r = 0; r < C::REG; ++r)
          tma_load_4d(sK + st * C::KV_BYTES + r * C::KV_REGION, &tm_k,
                      &k_full[st], r * C::COLS, kvh, k0, b);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_arrive_expect_tx(&v_full[st], C::KV_BYTES);
        for (int r = 0; r < C::REG; ++r)
          tma_load_4d(sV + st * C::KV_BYTES + r * C::KV_REGION, &tm_v,
                      &v_full[st], r * C::COLS, kvh, k0, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int row_base = 64 * (tid / 128 - 1);  // this warpgroup's rows
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // this thread's rows: row0 and row0 + 8 of the block
    const int row0 = row_base + 16 * warp + g;
    const int qpos0 = q_offset + q0 + row0;

    float oacc[C::NO];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) oacc[i] = 0.0f;
    float m2[2] = {kNegInf2, kNegInf2};  // running max, base 2
    float lsum[2] = {0.0f, 0.0f};        // this thread's part of the sum
    const float neg_inf = -__int_as_float(0x7f800000);

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = (t_lo + it) * kBK;

      // S = Q K^T
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.0f;
      mbar_wait(&k_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = kk * 16 / C::COLS;
        const int cb = (kk * 16 % C::COLS) * 2;
        const uint64_t da = make_desc(
            sQ + r * C::Q_REGION + row_base * C::ROWB + cb, 16, C::ATOM,
            C::SWIZZLE);
        const uint64_t db = make_desc(
            sK + st * C::KV_BYTES + r * C::KV_REGION + cb, 16, C::ATOM,
            C::SWIZZLE);
        WgmmaSS<kBK>::run(s, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kBK / 2>(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[st]);

      // scale to base 2; mask where the tile straddles an edge
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] *= scale_log2;
      const bool whole = k0 + kBK <= S &&
                         (!causal || k0 + kBK - 1 <= q_lo) &&
                         (window <= 0 || q_hi - k0 < window);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int key = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
          const int qpos = qpos0 + 8 * ((i >> 1) & 1);
          bool ok = key < S;
          const float masked = ok ? kNegInf2 : neg_inf;
          if (causal) ok = ok && qpos >= key;
          if (window > 0) ok = ok && qpos - key < window;
          s[i] = ok ? s[i] : masked;
        }
      }

      // online softmax: row max over the quad, rescale, P in bf16
      float mx[2] = {m2[0], m2[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = ex2(m2[r] - mx[r]);
        m2[r] = mx[r];
      }
      uint32_t p[kBK / 16][4];
      float rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          e[u] = ex2(s[8 * kk + u] - m2[(u >> 1) & 1]);
          rsum[(u >> 1) & 1] += e[u];
        }
        // the accumulator of keys 16kk.. is the A fragment of k-step kk
        p[kk][0] = pack_bf16(e[0], e[1]);
        p[kk][1] = pack_bf16(e[2], e[3]);
        p[kk][2] = pack_bf16(e[4], e[5]);
        p[kk][3] = pack_bf16(e[6], e[7]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) lsum[r] = lsum[r] * corr[r] + rsum[r];
#pragma unroll
      for (int i = 0; i < C::NO; ++i) oacc[i] *= corr[(i >> 1) & 1];

      // O += P V
      mbar_wait(&v_full[st], ph);
      fence_regs<C::NO>(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        pv_regions<D, 0>(oacc, p[kk],
                         sV + st * C::KV_BYTES + kk * 16 * C::ROWB);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<C::NO>(oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[st]);
    }

    // epilogue: the quad's sums, normalise, write o and lse
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + row0 + 8 * r;
      if (t >= T_len) continue;
      const float den = fmaxf(lsum[r], 1e-37f);
      __nv_bfloat16* orow =
          o + ((static_cast<int64_t>(b) * T_len + t) * H + h) * D;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        *reinterpret_cast<uint32_t*>(orow + 8 * jn + 2 * t4) =
            pack_bf16(oacc[4 * jn + 2 * r] / den,
                      oacc[4 * jn + 2 * r + 1] / den);
      if (t4 == 0)
        lse[(static_cast<int64_t>(b) * H + h) * T_len + t] =
            (m2[r] == kNegInf2 ? kNegInf : m2[r] * kLn2) + logf(lsum[r]);
    }
  }
}

// a 4-D map of x [batch, rows, heads, D] bf16, innermost first, with
// boxes of one region's columns, one head and 128 rows
template <int D>
bool encode(EncodeTiledFn enc, CUtensorMap* map, const void* x, int batch,
            int rows, int heads) {
  using C = Cfg<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2,
      static_cast<cuuint64_t>(heads) * D * 2,
      static_cast<cuuint64_t>(rows) * heads * D * 2};
  const cuuint32_t box[4] = {C::COLS, 1, kBM, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = C::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// allows the kernel its dynamic shared memory (once)
template <int D>
cudaError_t configure() {
  static cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::SMEM);
  return err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int T_len, int S, int H, int KV, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  static_assert(kBM == kBK, "one box shape for every map");
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode<D>(enc, &tq, q, B, T_len, H) ||
      !encode<D>(enc, &tk, k, B, S, KV) || !encode<D>(enc, &tv, v, B, S, KV))
    return static_cast<int>(cudaErrorInvalidValue);
  if (configure<D>() != cudaSuccess) return static_cast<int>(configure<D>());
  const dim3 grid(H, B, (T_len + kBM - 1) / kBM);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, Cfg<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      T_len, S, H, KV, scale * kLog2e, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int resources(int* smem_bytes, int* ctas_per_sm) {
  cudaError_t err = configure<D>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, flash_fwd_sm90_kernel<D>, kThreads, Cfg<D>::SMEM);
  *smem_bytes = Cfg<D>::SMEM;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The dynamic shared memory of the kernel for head dim D and how many of
// its CTAs an SM holds; returns the CUDA error code.
int flash_attention_bf16_sm90_resources(int D, int* smem_bytes,
                                        int* ctas_per_sm) {
  switch (D) {
    case 16: return resources<16>(smem_bytes, ctas_per_sm);
    case 32: return resources<32>(smem_bytes, ctas_per_sm);
    case 64: return resources<64>(smem_bytes, ctas_per_sm);
    case 80: return resources<80>(smem_bytes, ctas_per_sm);
    case 128: return resources<128>(smem_bytes, ctas_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the bf16 forward on `stream` and returns the CUDA error code of
// the launch (0 on success). q, k, v and o bf16, lse float32; window <= 0
// means no window. All tensors contiguous, device pointers 16-byte aligned.
int flash_attention_fwd_bf16_sm90(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int T_len, int S, int H, int KV, int D,
                                  int causal, int window, int q_offset,
                                  float scale, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, T_len, S, H, KV, scale, causal,
                        window, q_offset, st);
    case 32:
      return launch<32>(q, k, v, o, lse, B, T_len, S, H, KV, scale, causal,
                        window, q_offset, st);
    case 64:
      return launch<64>(q, k, v, o, lse, B, T_len, S, H, KV, scale, causal,
                        window, q_offset, st);
    case 80:
      return launch<80>(q, k, v, o, lse, B, T_len, S, H, KV, scale, causal,
                        window, q_offset, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, T_len, S, H, KV, scale, causal,
                         window, q_offset, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
