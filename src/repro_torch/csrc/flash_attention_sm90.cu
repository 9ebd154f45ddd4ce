// Flash-attention forward for Hopper (sm_90a), bf16 on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention) for bf16 inputs: out = softmax(q k^T *
// scale) v, with an optional causal mask written as -1e30 and out =
// acc / max(l, 1e-30). float32 inputs go to the scalar kernel in
// flash_attention.cu, which this file does not touch.
//
// What bounds it on an H100: at the serving shapes (head_dim 128, S >= 256)
// attention does 4 * hd operations per (query, key) pair against 2 * hd * 2
// bytes of K/V per key, far above the card's ~295 operations per byte, so
// it is bound by the tensor cores (989 bf16 TFLOP/s dense). Both products
// therefore run on wgmma, fed by TMA, and nothing of size S x S leaves the
// SM.
//
// Design. One block per (128-row q tile, head, batch), q tiles issued
// longest-causal-first. Three warpgroups:
//  - a producer warpgroup, whose first thread issues TMA loads of the Q
//    tile (once) and of K and V tiles (BK x hd) into a ring of kStages
//    stages, each guarded by "full" and "empty" mbarriers; the warpgroup
//    gives its registers up with setmaxnreg;
//  - two consumer warpgroups of 64 query rows each, with setmaxnreg raised.
//    For each K/V tile: S = Q K^T by wgmma m64 n(BK) k16 with both operands
//    in shared memory, K-major; scale, mask (only on the diagonal tile and
//    the ragged last tile) and online softmax in fp32 registers, the row max
//    and sum reduced over the 4 lanes that hold a row; P rounded to bf16 in
//    registers, where the accumulator fragment of S already is the A
//    fragment of the next product; O += P V by wgmma m64 n(hd) k16 with V
//    read from shared memory as an MN-major B operand.
// TMA writes every tile with the 128-byte swizzle (64-byte at hd 32) in
// blocks of one swizzle width of columns, and the wgmma descriptors read
// that layout.
// Head dim 112 (kimi-k2) runs on the hd-128 tile: a 224-byte row does not
// fill whole 128-byte swizzle blocks, so the tensor maps keep the real
// width (globalDim[0] = 112) under two 64-column boxes, TMA fills columns
// 112-127 with zeros, Q K^T is unchanged by them and P V's extra output
// columns are 0, and the epilogue stores 112 columns. The cost is 14% more
// MMA work than a tile of 112 would do. TMA fills rows past S with zeros; the score mask kj >= S is
// still applied, as a zero K row scores 0, not -inf.
// Tensor maps are 4-D (hd, heads, S, B) over the caller's strides, built on
// the host at each call (cuTensorMapEncodeTiled through the runtime's
// driver entry point, so the library needs no -lcuda) and passed as
// __grid_constant__ parameters. GQA: query head h reads KV head
// h / (H / KV). The output is stored from registers through its strides.
//
// Sliding window (`window` > 0, causal only: key k is seen by query q iff
// k <= q and q - k < window, the JAX layers' _mask): the block's key loop
// starts at the tile that holds its first row's first key, q0 - window + 1,
// so the producer never loads a tile wholly outside the window, and both
// warpgroups consume every tile from there (the ring's empty barriers
// count both); a tile that reaches before a warpgroup's window is masked
// like the diagonal one. A row whose keys in such a tile are all masked
// adds exp2(0) = 1 for each until its first unmasked score, whose max
// scales that sum and the output by exp2(-1e30 - max) = 0: every row sees
// its own key. The window is an instance of its own (WINDOW), as the LSE
// write is: as a runtime argument it made every serving shape without a
// window 9-38% slower (an H100 80GB HBM3 at 700 W, paired against the
// kernel without it by python -m repro_torch.launch.kernel_times).
//
// Training: given a pointer, the epilogue also writes each row's
// log-sum-exp, (m + log2 l) ln 2, which flash_attention_bwd_sm90.cu
// recomputes P from; serving passes none and launches an instance without
// that code: one instance with the write behind a runtime test was 4-9%
// slower at every serving shape (an H100 80GB HBM3 at 700 W, paired
// against the kernel without it by python -m repro_torch.launch.kernel_times).
//
// C entry: repro_flash_attention_sm90_fwd, launched on the caller's stream;
// it allocates nothing and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for input TMA cannot address.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

constexpr int kConsumers = 2;                 // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockQ = 64 * kConsumers;
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Tile {
  static constexpr int BK = HD <= 128 ? 128 : 64;      // keys per K/V tile
  static constexpr int ROW = HD >= 64 ? 128 : 64;      // bytes of a swizzled row
  static constexpr int BOX = ROW / 2;                  // bf16 columns per block
  static constexpr int BLOCKS = HD / BOX;              // column blocks per row
  static constexpr uint32_t LAYOUT = ROW == 128 ? 1 : 2;  // descriptor swizzle
  static constexpr int ATOM = 8 * ROW;                 // 8 swizzled rows
  static constexpr int Q_BLOCK = kBlockQ * ROW;        // one column block of Q
  static constexpr int KV_BLOCK = BK * ROW;            // one of a K or V tile
  static constexpr int Q_BYTES = BLOCKS * Q_BLOCK;
  static constexpr int KV_BYTES = BLOCKS * KV_BLOCK;
  static constexpr int BAR_BYTES = 8 * (1 + 4 * kStages);
  // + 1024 to align the tiles to the swizzle pattern's 1024-byte period
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * kStages * KV_BYTES + BAR_BYTES;
};

// HD: the tile's head dim; HD_OUT <= HD: the columns the output has; LSE:
// whether the epilogue also writes each row's log-sum-exp (training), an
// instance of its own so that serving's code is the same without it;
// WINDOW: whether `window` (> 0) applies, likewise.
template <int HD, int HD_OUT, bool LSE, bool WINDOW>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
               int group, int64_t sob, int64_t sos, int64_t soh, float scale,
               int causal, int window) {
  using T = Tile<HD>;
  constexpr int BK = T::BK;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t k_s = q_s + T::Q_BYTES;                 // kStages K tiles
  const uint32_t v_s = k_s + kStages * T::KV_BYTES;      // kStages V tiles
  const uint32_t bars = v_s + kStages * T::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * kStages + st); };

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  const int n_k = (k_end + BK - 1) / BK;
  // the first tile of the first row's window (window implies causal)
  const int kt0 = WINDOW ? max(0, q0 - window + 1) / BK : 0;
  // consumer warpgroups that hold at least one row < S
  const int active = min(kConsumers, (S - q0 + 63) / 64);

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 128 * active);
      mbar_init(v_empty(st), 128 * active);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    regs_release<kProducerRegs>();
    if (t == 0) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      const int hk = h / group;
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::BLOCKS; ++c)
        tma_load_4d(q_s + c * T::Q_BLOCK, &tq, q_full, c * T::BOX, h, q0, b);
      for (int kt = kt0; kt < n_k; ++kt) {
        const int st = (kt - kt0) % kStages;
        const uint32_t ph = ((kt - kt0) / kStages) & 1;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_expect_tx(k_full(st), T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::BLOCKS; ++c)
          tma_load_4d(k_s + st * T::KV_BYTES + c * T::KV_BLOCK, &tk, k_full(st),
                      c * T::BOX, hk, kt * BK, b);
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_expect_tx(v_full(st), T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::BLOCKS; ++c)
          tma_load_4d(v_s + st * T::KV_BYTES + c * T::KV_BLOCK, &tv, v_full(st),
                      c * T::BOX, hk, kt * BK, b);
      }
    }
  } else {
    // ---- consumer: 64 query rows, both products on wgmma ----
    regs_claim<kConsumerRegs>();
    if (wg >= active) return;
    const int warp = t / 32;
    const int lane = t % 32;
    const int wq0 = q0 + 64 * wg;             // first row of this warpgroup
    const int r0 = wq0 + 16 * warp + lane / 4;  // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);              // column offset in an 8-block
    // a causal warpgroup stops at its own diagonal
    const int n_mine =
        causal ? (min(S, wq0 + 64) + BK - 1) / BK : n_k;
    const float sl2 = scale * kLog2e;

    float acc[HD / 2];
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
    float l[2] = {0.f, 0.f};          // this thread's part of the row sum

    mbar_wait(q_full, 0);
    for (int kt = kt0; kt < n_mine; ++kt) {
      const int st = (kt - kt0) % kStages;
      const uint32_t ph = ((kt - kt0) / kStages) & 1;
      const int k0 = kt * BK;

      // S = Q K^T
      mbar_wait(k_full(st), ph);
      const uint32_t kb = k_s + st * T::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int blk = kk * 16 / T::BOX;
        const int col = (kk * 16 % T::BOX) * 2;
        const uint64_t da = make_desc(q_s + blk * T::Q_BLOCK + wg * 64 * T::ROW + col,
                                      16, T::ATOM, T::LAYOUT);
        const uint64_t db =
            make_desc(kb + blk * T::KV_BLOCK + col, 16, T::ATOM, T::LAYOUT);
        Wgmma<BK>::ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty(st));

      // scale, mask, online softmax (log2 domain)
      const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > wq0) ||
                          (WINDOW && k0 < wq0 + 64 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[4 * j + 2 * i + c] * sl2;
            if (masked) {
              const int kj = k0 + 8 * j + c0 + c;
              const int row = r0 + 8 * i;
              if (kj >= S || (causal && kj > row) || (WINDOW && row - kj >= window))
                x = kNegInf;
            }
            s[4 * j + 2 * i + c] = x;
            mx[i] = fmaxf(mx[i], x);
          }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2_approx(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2_approx(s[4 * j + 2 * i + c] - m[i]);
            s[4 * j + 2 * i + c] = p;
            l[i] += p;
          }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * j + 2 * i] *= alpha[i];
          acc[4 * j + 2 * i + 1] *= alpha[i];
        }
      // P in bf16: the S fragment of columns 16kk..16kk+15 is the A
      // fragment of k-step kk
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V
      mbar_wait(v_full(st), ph);
      const uint32_t vb = v_s + st * T::KV_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            make_desc(vb + kk * 16 * T::ROW, T::KV_BLOCK, T::ATOM, T::LAYOUT);
        Wgmma<HD>::rs(acc, pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty(st));
    }

    // epilogue: O / max(l, 1e-30), stored as bf16 through the strides, and
    // (for the backward) the row's log-sum-exp of the scaled scores,
    // (m + log2 l) ln 2, into the contiguous (B, H, S) lse
    __nv_bfloat16* ob = o + b * sob + h * soh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float inv = 1.f / fmaxf(li, 1e-30f);
      const int row = r0 + 8 * i;
      if (LSE && row < S && lane % 4 == 0)
        lse[(static_cast<int64_t>(b) * gridDim.y + h) * S + row] =
            (m[i] + log2f(fmaxf(li, 1e-30f))) * kLn2;
      if (row < S) {
        __nv_bfloat16* orow = ob + static_cast<int64_t>(row) * sos;
#pragma unroll
        for (int j = 0; j < HD_OUT / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) = __floats2bfloat162_rn(
              acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

template <int HD, int HD_OUT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int S,
                   int H, int KV, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                   int64_t sks, int64_t skh, int64_t svb, int64_t svs, int64_t svh,
                   int64_t sob, int64_t sos, int64_t soh, float scale, int causal,
                   int window, cudaStream_t stream) {
  using T = Tile<HD>;
  // boxes of one column block (columns HD_OUT..HD-1 read as zeros)
  CUtensorMap tq, tk, tv;
  if (!make_bf16_map(&tq, q, HD_OUT, B, S, H, sqb, sqs, sqh, T::BOX, kBlockQ) ||
      !make_bf16_map(&tk, k, HD_OUT, B, S, KV, skb, sks, skh, T::BOX, T::BK) ||
      !make_bf16_map(&tv, v, HD_OUT, B, S, KV, svb, svs, svh, T::BOX, T::BK))
    return cudaErrorInvalidValue;
  auto kern = lse != nullptr
                  ? (window > 0 ? flash_fwd_sm90<HD, HD_OUT, true, true>
                                : flash_fwd_sm90<HD, HD_OUT, true, false>)
                  : (window > 0 ? flash_fwd_sm90<HD, HD_OUT, false, true>
                                : flash_fwd_sm90<HD, HD_OUT, false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kThreads, T::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o),
                                            lse, S, H / KV, sob, sos, soh, scale, causal,
                                            window);
  return cudaGetLastError();
}

// The head dims the kernel is built for, each with the head dim of its tile.
#define REPRO_FA_HEAD_DIMS(X) X(32, 32) X(64, 64) X(112, 128) X(128, 128) X(256, 256)

}  // namespace

// bf16 only. Strides are in elements; q/k/v must be TMA-addressable (16-byte
// aligned base, strides of whole 16 bytes), which the Python wrapper checks.
// `window`: 0, or a sliding window under `causal`. `lse`: null, or a
// contiguous fp32 (B, H, S) that receives each row's log-sum-exp (what the
// backward kernel recomputes P from).
extern "C" int repro_flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
    int hd, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int64_t sob, int64_t sos,
    int64_t soh, float scale, int causal, int window, float* lse, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(HD_, TILE_)                                                    \
  case HD_:                                                                          \
    return (int)launch<TILE_, HD_>(q, k, v, o, lse, B, S, H, KV, sqb, sqs, sqh, skb, sks, \
                                   skh, svb, svs, svh, sob, sos, soh, scale, causal,     \
                                   window, st);
  switch (hd) {
    REPRO_FA_HEAD_DIMS(REPRO_FA_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

// Bytes of dynamic shared memory a block takes at head dim `hd` (0 for a
// head dim the kernel is not built for).
extern "C" int repro_flash_attention_sm90_smem_bytes(int hd) {
#define REPRO_FA_SMEM(HD_, TILE_) \
  case HD_:                       \
    return Tile<TILE_>::SMEM;
  switch (hd) {
    REPRO_FA_HEAD_DIMS(REPRO_FA_SMEM)
    default:
      return 0;
  }
#undef REPRO_FA_SMEM
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
