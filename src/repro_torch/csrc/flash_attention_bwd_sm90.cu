// Flash-attention backward for Hopper (sm_90a), bf16 on the tensor cores.
//
// The gradient of the forward in flash_attention_sm90.cu, which replaces the
// Pallas TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel /
// flash_attention). The Pallas kernel has no backward (the JAX package
// differentiates the XLA ops of its layers); this one computes the same
// closed form as kernels/flash_attention.py:flash_attention_backward, its
// plain version:
//
//   P = exp(S * scale - LSE),  dV = P^T dO,  dP = dO V^T,
//   dS = P * (dP - delta),  delta = rowsum(dO * O),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
//
// What bounds it on an H100: products of 2 * hd operations per visited
// (query, key) pair against a few bytes per row, so the tensor cores
// (989 bf16 TFLOP/s dense), as in the forward. So every product runs on
// wgmma fed by TMA, P is recomputed per tile from the forward's saved
// log-sum-exp, and nothing of size S x S reaches device memory.
//
// Design (FA2's backward, with dQ in a pass of its own). Three launches on
// the caller's stream (four with the GQA sum):
//  1. prologue: a few lanes a query row compute delta = rowsum(dO * O) in
//     fp32 and copy LSE * log2(e) beside it, both into (B*H, S_pad)
//     arrays padded with zeros to whole 64-row tiles, so that every tile's
//     rows are one aligned 256-byte bulk copy;
//  2. main (dK, dV): one block per (128-key tile, KV head, batch). A
//     producer warpgroup loads the K and V tiles once by TMA and streams
//     the (Q, dO, LSE, delta) tiles of 64 queries through a ring of
//     mbarrier-guarded stages; the block loops over the query tiles at or
//     after its keys when causal and over the G = H / KV query heads that
//     read its KV head (GQA), so dK and dV build up in registers with no
//     atomics. With G > 1 each query head has a block of its own: one
//     block looping over all G had the longest causal loop G times over
//     (at yi-9b's 32/4 heads, 128 blocks for 132 SMs, the first key tile's
//     512 steps against 256 an SM on average), so the blocks write fp32
//     partials that a small launch (bwd_sum_heads) sums per KV head in a
//     fixed order. Two consumer warpgroups own 64 keys each and, per
//     tile:
//       S^T = K Q^T                    (SS, both operands K-major)
//       P^T = exp2(S^T scale log2e - LSE log2e), masked (causal, keys and
//             queries past S) to 0
//       dV += P^T dO                   (RS: P^T in bf16 from the registers,
//                                       dO an MN-major B)
//       dP^T = V dO^T                  (SS, both K-major)
//       dS^T = P^T (dP^T - delta)      (fp32, then bf16 A fragments)
//       dK += dS^T Q                   (RS, Q an MN-major B)
//     The epilogue scales dK, casts dK and dV to bf16 and stores them
//     through their strides;
//  3. dQ: one block per (128-query tile, head, batch), shaped as the
//     forward: two consumer warpgroups of 64 rows recompute S = Q K^T and
//     dP = dO V^T for each 64-key tile, form dS in registers and add
//     dQ += dS K (RS), then store dQ * scale as bf16. Seven products in
//     all where one kernel would do five, but no atomics: summing dQ's
//     per-key-tile parts by fp32 atomics (even 16-byte ones) was bound by
//     the L2's atomic throughput: 2.88 ms at yi-9b's (1, 4096, 32/4, 128)
//     on an H100 80GB HBM3 (700 W), against 1.53 with this kernel and a
//     bound of 0.348 for five products; and dQ comes out the same on
//     every run.
// Sliding window (`window` > 0, causal only: key k is seen by query q iff
// k <= q and q - k < window, the JAX layers' _mask): a key tile's query loop
// ends at the last query its window reaches, k0 + 127 + window - 1; a query
// tile's key loop starts at the tile that holds its first row's first key,
// q0 - window + 1; tiles that reach past a warpgroup's window are masked
// as the diagonal ones are (P = 0), and a warpgroup whose keys no query of
// the step sees skips it. The prologue and the GQA sum are unchanged. The
// window is an instance of its own (WINDOW): as a runtime argument it made
// the backward without a window 11-15% slower (an H100 80GB HBM3 at 700 W).
// Head dim 256: a warpgroup's dK and dV accumulators (64 x 256 fp32 each,
// 128 registers a thread each) do not fit together, so the main kernel runs
// twice, a dV pass and a dK pass, each recomputing P, with one ring stage
// (the K, V and Q/dO tiles take 192 KB); the dQ kernel holds one stage too.
// Head dim 112 runs on the hd-128 tile, as in the forward: TMA fills
// columns 112-127 with zeros, which leave S and dP unchanged and give zero
// output columns, not stored. Tiles are written by TMA with the 128-byte
// swizzle (64-byte at hd 32).
//
// C entry: repro_flash_attention_bwd_sm90, launched on the caller's stream;
// it allocates nothing (the caller gives the scratch) and returns the first
// launch error, or cudaErrorInvalidValue for input TMA cannot address.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

constexpr int kConsumers = 2;                 // warpgroups of 64 keys each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockK = 64 * kConsumers;      // keys a block
constexpr int kBlockQ = 64;                   // queries a step
constexpr int kDqRows = 64 * kConsumers;      // query rows a dQ block
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// What one launch of the main kernel computes: dK and dV, or (head dim
// 256) dV alone, then dK.
enum Pass { kAll = 0, kDV = 1, kDK = 2 };

template <int HD>
struct Tile {
  static constexpr int ROW = HD >= 64 ? 128 : 64;      // bytes of a swizzled row
  static constexpr int BOX = ROW / 2;                  // bf16 columns per block
  static constexpr int BLOCKS = HD / BOX;              // column blocks per row
  static constexpr uint32_t LAYOUT = ROW == 128 ? 1 : 2;  // descriptor swizzle
  static constexpr int ATOM = 8 * ROW;                 // 8 swizzled rows
  static constexpr int STAGES = HD == 256 ? 1 : 2;
  static constexpr int KV_BLOCK = kBlockK * ROW;       // a column block of K or V
  static constexpr int KV_BYTES = BLOCKS * KV_BLOCK;
  static constexpr int Q_BLOCK = kBlockQ * ROW;        // a column block of Q or dO
  static constexpr int Q_BYTES = BLOCKS * Q_BLOCK;
  static constexpr int VEC_BYTES = kBlockQ * 4;        // a tile's LSE or delta
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  // + 1024 to align the tiles to the swizzle pattern's 1024-byte period
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + 2 * STAGES * Q_BYTES + 2 * STAGES * VEC_BYTES + BAR_BYTES;
};

// The dQ kernel's tiles: 128 query rows (two consumer warpgroups of 64),
// K and V tiles of 64 keys.
template <int HD>
struct DqTile {
  static constexpr int ROW = Tile<HD>::ROW;
  static constexpr int BOX = Tile<HD>::BOX;
  static constexpr int BLOCKS = Tile<HD>::BLOCKS;
  static constexpr uint32_t LAYOUT = Tile<HD>::LAYOUT;
  static constexpr int ATOM = Tile<HD>::ATOM;
  static constexpr int BK = 64;                        // keys per K/V tile
  static constexpr int STAGES = Tile<HD>::STAGES;
  static constexpr int Q_BLOCK = kDqRows * ROW;        // a column block of Q or dO
  static constexpr int Q_BYTES = BLOCKS * Q_BLOCK;
  static constexpr int KV_BLOCK = BK * ROW;
  static constexpr int KV_BYTES = BLOCKS * KV_BLOCK;
  static constexpr int BAR_BYTES = 8 * (1 + 4 * STAGES);
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

// delta = rowsum(dO * O) in fp32 and LSE * log2(e) into the padded
// (B*H, S_pad) arrays (rows past S get zeros). A row takes `lanes` lanes
// (a power of two of at least hd / 8), each reading 16 bytes of O and of
// dO; a warp takes 32 / lanes rows.
__global__ void bwd_prologue(const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, float* __restrict__ lse2,
                             float* __restrict__ delta, int S, int S_pad, int H, int hd,
                             int lanes, int64_t sob, int64_t sos, int64_t soh, int64_t sdb,
                             int64_t sds, int64_t sdh, int64_t n_rows) {
  const int sub = threadIdx.x % lanes;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / lanes;
  if (row >= n_rows) return;  // n_rows is a multiple of 64: whole warps leave
  const int64_t bh = row / S_pad;
  const int i = static_cast<int>(row % S_pad);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  float acc = 0.f;
  if (i < S && 8 * sub < hd) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * sob + i * sos + h * soh + 8 * sub);
    const uint4 dv =
        *reinterpret_cast<const uint4*>(dout + b * sdb + i * sds + h * sdh + 8 * sub);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
    const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int w = 0; w < 4; ++w)
      acc += __uint_as_float(ow[w] << 16) * __uint_as_float(dw[w] << 16) +
             __uint_as_float(ow[w] & 0xFFFF0000u) * __uint_as_float(dw[w] & 0xFFFF0000u);
  }
  for (int off = lanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if (sub == 0) {
    delta[row] = acc;
    lse2[row] = i < S ? lse[bh * S + i] * kLog2e : 0.f;
  }
}

// dK and dV as bf16 through their strides from the main kernel's fp32
// partials of `splits` query-head shares, summed in a fixed order.
__global__ void bwd_sum_heads(const float2* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int B, int S, int KV,
                              int splits, int hd, int64_t skb, int64_t sks, int64_t skh,
                              int64_t svb, int64_t svs, int64_t svh) {
  const int pairs = hd / 2;
  const int64_t half = static_cast<int64_t>(B) * S * KV * pairs;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < 2 * half;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int v = i >= half;
    int64_t r = i - v * half;
    const int d = static_cast<int>(r % pairs) * 2;
    r /= pairs;
    const int hk = static_cast<int>(r % KV);
    r /= KV;
    const int s = static_cast<int>(r % S);
    const int b = static_cast<int>(r / S);
    const float2* src = part + v * half * splits +
                        ((static_cast<int64_t>(b) * S + s) * KV + hk) * splits * pairs + d / 2;
    float2 sum = make_float2(0.f, 0.f);
    for (int g = 0; g < splits; ++g) {
      const float2 x = src[g * pairs];
      sum.x += x.x;
      sum.y += x.y;
    }
    __nv_bfloat16* dst = v ? dv + b * svb + s * svs + hk * svh : dk + b * skb + s * sks + hk * skh;
    *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(sum.x, sum.y);
  }
}

// HD: the tile's head dim; HD_OUT <= HD: the columns the tensors have;
// WINDOW: whether `window` (> 0) applies.
template <int HD, int HD_OUT, int PASS, bool WINDOW>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ part, int S, int S_pad, int H, int group, int splits,
               int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
               int64_t svh, float scale, int causal, int window) {
  using T = Tile<HD>;
  constexpr bool kDoDV = PASS != kDK;
  constexpr bool kDoDK = PASS != kDV;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + T::KV_BYTES;
  const uint32_t q_s = v_s + T::KV_BYTES;                 // STAGES Q tiles
  const uint32_t do_s = q_s + T::STAGES * T::Q_BYTES;     // STAGES dO tiles
  const uint32_t vec_s = do_s + T::STAGES * T::Q_BYTES;   // STAGES x (LSE, delta)
  const uint32_t bars = vec_s + T::STAGES * 2 * T::VEC_BYTES;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + T::STAGES + st); };

  const int k0 = blockIdx.x * kBlockK;  // key tiles from 0: the longest causal loop first
  // block y takes KV head y / splits and the (y % splits)-th share of the
  // query heads that read it
  const int hk = blockIdx.y / splits;
  const int heads = group / splits;
  const int h0 = hk * group + blockIdx.y % splits * heads;
  const int b = blockIdx.z;
  const int n_q = S_pad / kBlockQ;
  const int qt0 = causal ? k0 / kBlockQ : 0;  // no earlier query sees these keys
  // nor a later one than the last key's window reaches (window implies causal)
  const int qt_end = WINDOW ? min(n_q, (k0 + kBlockK + window - 2) / kBlockQ + 1) : n_q;
  const int per_head = qt_end - qt0;
  const int n_steps = heads * per_head;

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128 * kConsumers);
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
      prefetch_tensormap(&tdo);
      mbar_expect_tx(kv_full, (kDoDK ? 2 : 1) * T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < T::BLOCKS; ++c)
        tma_load_4d(k_s + c * T::KV_BLOCK, &tk, kv_full, c * T::BOX, hk, k0, b);
      if (kDoDK) {
#pragma unroll
        for (int c = 0; c < T::BLOCKS; ++c)
          tma_load_4d(v_s + c * T::KV_BLOCK, &tv, kv_full, c * T::BOX, hk, k0, b);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % T::STAGES;
        const uint32_t ph = (i / T::STAGES) & 1;
        const int h = h0 + i / per_head;
        const int q0 = (qt0 + i % per_head) * kBlockQ;
        mbar_wait(empty(st), ph ^ 1);
        mbar_expect_tx(full(st), 2 * T::Q_BYTES + 2 * T::VEC_BYTES);
#pragma unroll
        for (int c = 0; c < T::BLOCKS; ++c) {
          tma_load_4d(q_s + st * T::Q_BYTES + c * T::Q_BLOCK, &tq, full(st), c * T::BOX, h,
                      q0, b);
          tma_load_4d(do_s + st * T::Q_BYTES + c * T::Q_BLOCK, &tdo, full(st), c * T::BOX,
                      h, q0, b);
        }
        const int64_t row = (static_cast<int64_t>(b) * H + h) * S_pad + q0;
        const uint32_t vb = vec_s + st * 2 * T::VEC_BYTES;
        bulk_load(vb, lse2 + row, T::VEC_BYTES, full(st));
        bulk_load(vb + T::VEC_BYTES, delta + row, T::VEC_BYTES, full(st));
      }
    }
  } else {
    // ---- consumer: 64 keys, five products on wgmma ----
    regs_claim<kConsumerRegs>();
    const int warp = t / 32;
    const int lane = t % 32;
    const int kw0 = k0 + 64 * wg;               // first key of this warpgroup
    const int rr = 16 * warp + lane / 4;        // fragment rows rr and rr + 8
    const int c0 = 2 * (lane % 4);              // column offset in an 8-block
    const float sl2 = scale * kLog2e;
    const float* vec_p = reinterpret_cast<const float*>(smem_raw + (vec_s - raw));

    float dk_acc[HD / 2];
    float dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    float s[32];
    float dp[32];

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % T::STAGES;
      const uint32_t ph = (i / T::STAGES) & 1;
      const int q0 = (qt0 + i % per_head) * kBlockQ;
      mbar_wait(full(st), ph);
      // a warpgroup whose keys are all past S, all after the tile's last
      // query (causal), or all before the first query's window, adds nothing
      const bool live = kw0 < S && !(causal && kw0 > q0 + kBlockQ - 1) &&
                        !(WINDOW && q0 - (kw0 + 63) >= window);
      if (live) {
        const uint32_t qb = q_s + st * T::Q_BYTES;
        const uint32_t dob = do_s + st * T::Q_BYTES;
        const float* lse_t = vec_p + st * 2 * kBlockQ;
        const float* delta_t = lse_t + kBlockQ;

        // S^T = K Q^T: 64 keys x 64 queries
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int blk = kk * 16 / T::BOX;
          const int col = (kk * 16 % T::BOX) * 2;
          const uint64_t da = make_desc(k_s + blk * T::KV_BLOCK + wg * 64 * T::ROW + col, 16,
                                        T::ATOM, T::LAYOUT);
          const uint64_t db =
              make_desc(qb + blk * T::Q_BLOCK + col, 16, T::ATOM, T::LAYOUT);
          Wgmma<64>::ss(s, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // P^T in fp32, masked to 0 on the causal triangle and past S
        const bool masked = (causal && q0 < kw0 + 63) || kw0 + 64 > S ||
                            q0 + kBlockQ > S ||
                            (WINDOW && q0 + kBlockQ - 1 - kw0 >= window);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qc = 8 * j + c0 + c;
            const float l2 = lse_t[qc];
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              float p = exp2_approx(s[4 * j + 2 * ii + c] * sl2 - l2);
              if (masked) {
                const int key = kw0 + rr + 8 * ii;
                const int q = q0 + qc;
                if (key >= S || q >= S || (causal && key > q) ||
                    (WINDOW && q - key >= window))
                  p = 0.f;
              }
              s[4 * j + 2 * ii + c] = p;
            }
          }

        // dV += P^T dO: P^T's fragment of queries 16kk..16kk+15 is the A
        // fragment of k-step kk
        uint32_t pa[4][4];
        if constexpr (kDoDV) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          fence_regs(dv_acc);
        }
        wgmma_fence();
        if (kDoDV) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db =
                make_desc(dob + kk * 16 * T::ROW, T::Q_BLOCK, T::ATOM, T::LAYOUT);
            Wgmma<HD>::rs(dv_acc, pa[kk], db, 1);
          }
          wgmma_commit();
        }
        // dP^T = V dO^T
        if (kDoDK) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const int blk = kk * 16 / T::BOX;
            const int col = (kk * 16 % T::BOX) * 2;
            const uint64_t da = make_desc(v_s + blk * T::KV_BLOCK + wg * 64 * T::ROW + col,
                                          16, T::ATOM, T::LAYOUT);
            const uint64_t db =
                make_desc(dob + blk * T::Q_BLOCK + col, 16, T::ATOM, T::LAYOUT);
            Wgmma<64>::ss(dp, da, db, kk > 0);
          }
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dp);
        if constexpr (kDoDV) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
        }

        if (kDoDK) {
          // dS^T = P^T (dP^T - delta), bf16, as the A fragments of
          // dK += dS^T Q
          uint32_t dsa[4][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const int e = 4 * j + 2 * ii;
              dsa[j / 2][2 * (j % 2) + ii] =
                  pack_bf16(s[e] * (dp[e] - delta_t[8 * j + c0]),
                            s[e + 1] * (dp[e + 1] - delta_t[8 * j + c0 + 1]));
            }
          fence_regs(dk_acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db =
                make_desc(qb + kk * 16 * T::ROW, T::Q_BLOCK, T::ATOM, T::LAYOUT);
            Wgmma<HD>::rs(dk_acc, dsa[kk], db, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk_acc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
        }
      }
      mbar_arrive(empty(st));
    }

    // epilogue: dK * scale and dV, as bf16 through the strides or, when
    // the query heads are split over blocks, as fp32 partials (dK's, then
    // dV's: (B, S, KV * splits, HD_OUT) each) for bwd_sum_heads
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int key = kw0 + rr + 8 * ii;
      if (key < S && splits > 1) {
        const int64_t n = static_cast<int64_t>(gridDim.z) * S * gridDim.y * HD_OUT;
        float* pk = part + ((static_cast<int64_t>(b) * S + key) * gridDim.y + blockIdx.y) *
                               HD_OUT + c0;
#pragma unroll
        for (int j = 0; j < HD_OUT / 8; ++j) {
          if (kDoDK)
            *reinterpret_cast<float2*>(pk + 8 * j) = make_float2(
                dk_acc[4 * j + 2 * ii] * scale, dk_acc[4 * j + 2 * ii + 1] * scale);
          if (kDoDV)
            *reinterpret_cast<float2*>(pk + n + 8 * j) =
                make_float2(dv_acc[4 * j + 2 * ii], dv_acc[4 * j + 2 * ii + 1]);
        }
      } else if (key < S) {
        if (kDoDK) {
          __nv_bfloat16* krow = dk + b * skb + static_cast<int64_t>(key) * sks + hk * skh;
#pragma unroll
          for (int j = 0; j < HD_OUT / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j + c0) = __floats2bfloat162_rn(
                dk_acc[4 * j + 2 * ii] * scale, dk_acc[4 * j + 2 * ii + 1] * scale);
        }
        if (kDoDV) {
          __nv_bfloat16* vrow = dv + b * svb + static_cast<int64_t>(key) * svs + hk * svh;
#pragma unroll
          for (int j = 0; j < HD_OUT / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j + c0) =
                __floats2bfloat162_rn(dv_acc[4 * j + 2 * ii], dv_acc[4 * j + 2 * ii + 1]);
        }
      }
    }
  }
}

// dQ = scale * dS K for one 128-row query tile of one head, the K and V
// tiles of the keys it sees streamed through a ring; no atomics: the block
// owns its rows. The forward's shape: a producer warpgroup (Q and dO tiles
// once, K and V tiles of 64 keys through STAGES stages) and two consumer
// warpgroups of 64 rows, each per tile: S = Q K^T and dP = dO V^T (SS, all
// K-major), P = exp2(S scale log2e - LSE log2e) masked to 0, dS = P (dP -
// delta) rounded to bf16 in registers, whose accumulator fragment is the A
// fragment of dQ += dS K (RS, K an MN-major B). HD: the tile's head dim;
// HD_OUT <= HD: the columns the tensors have; WINDOW: whether `window`
// (> 0) applies.
template <int HD, int HD_OUT, bool WINDOW>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse2, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int S, int S_pad, int group,
                  int64_t sqb, int64_t sqs, int64_t sqh, float scale, int causal,
                  int window) {
  using T = DqTile<HD>;
  constexpr int BK = T::BK;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t do_s = q_s + T::Q_BYTES;
  const uint32_t k_s = do_s + T::Q_BYTES;                // STAGES K tiles
  const uint32_t v_s = k_s + T::STAGES * T::KV_BYTES;    // STAGES V tiles
  const uint32_t bars = v_s + T::STAGES * T::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + T::STAGES + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * T::STAGES + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * T::STAGES + st); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal loop first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kDqRows;
  const int k_end = causal ? min(S, q0 + kDqRows) : S;
  const int n_k = (k_end + BK - 1) / BK;
  // the first tile of the first row's window (window implies causal)
  const int kt0 = WINDOW ? max(0, q0 - window + 1) / BK : 0;
  // consumer warpgroups that hold at least one row < S
  const int active = min(kConsumers, (S - q0 + 63) / 64);

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 128 * active);
      mbar_init(v_empty(st), 128 * active);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    regs_release<kProducerRegs>();
    if (t == 0) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      prefetch_tensormap(&tdo);
      const int hk = h / group;
      mbar_expect_tx(q_full, 2 * T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::BLOCKS; ++c) {
        tma_load_4d(q_s + c * T::Q_BLOCK, &tq, q_full, c * T::BOX, h, q0, b);
        tma_load_4d(do_s + c * T::Q_BLOCK, &tdo, q_full, c * T::BOX, h, q0, b);
      }
      for (int kt = kt0; kt < n_k; ++kt) {
        const int st = (kt - kt0) % T::STAGES;
        const uint32_t ph = ((kt - kt0) / T::STAGES) & 1;
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
    regs_claim<kConsumerRegs>();
    if (wg >= active) return;
    const int warp = t / 32;
    const int lane = t % 32;
    const int wq0 = q0 + 64 * wg;               // first row of this warpgroup
    const int r0 = wq0 + 16 * warp + lane / 4;  // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);
    const int n_mine = causal ? (min(S, wq0 + 64) + BK - 1) / BK : n_k;
    const float sl2 = scale * kLog2e;
    // the rows' LSE * log2(e) and delta (rows < S_pad: wq0 < S)
    const int64_t vrow = (static_cast<int64_t>(b) * gridDim.y + h) * S_pad + r0;
    const float l2[2] = {lse2[vrow], lse2[vrow + 8]};
    const float dl[2] = {delta[vrow], delta[vrow + 8]};

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float sc[BK / 2];
    float dp[BK / 2];

    mbar_wait(q_full, 0);
    for (int kt = kt0; kt < n_mine; ++kt) {
      const int st = (kt - kt0) % T::STAGES;
      const uint32_t ph = ((kt - kt0) / T::STAGES) & 1;
      const int k0 = kt * BK;
      const uint32_t kb = k_s + st * T::KV_BYTES;
      const uint32_t vb = v_s + st * T::KV_BYTES;

      // S = Q K^T and dP = dO V^T
      mbar_wait(k_full(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int blk = kk * 16 / T::BOX;
        const int col = (kk * 16 % T::BOX) * 2;
        const uint64_t da = make_desc(q_s + blk * T::Q_BLOCK + wg * 64 * T::ROW + col, 16,
                                      T::ATOM, T::LAYOUT);
        const uint64_t db = make_desc(kb + blk * T::KV_BLOCK + col, 16, T::ATOM, T::LAYOUT);
        Wgmma<BK>::ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      mbar_wait(v_full(st), ph);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int blk = kk * 16 / T::BOX;
        const int col = (kk * 16 % T::BOX) * 2;
        const uint64_t da = make_desc(do_s + blk * T::Q_BLOCK + wg * 64 * T::ROW + col, 16,
                                      T::ATOM, T::LAYOUT);
        const uint64_t db = make_desc(vb + blk * T::KV_BLOCK + col, 16, T::ATOM, T::LAYOUT);
        Wgmma<BK>::ss(dp, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(v_empty(st));

      // dS = P (dP - delta), P masked to 0 (causal, window, keys and rows
      // past S)
      const bool masked = k0 + BK > S || wq0 + 64 > S ||
                          (causal && k0 + BK - 1 > wq0) ||
                          (WINDOW && k0 < wq0 + 64 - window);
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float d[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            float p = exp2_approx(sc[e] * sl2 - l2[i]);
            if (masked) {
              const int kj = k0 + 8 * j + c0 + c;
              const int row = r0 + 8 * i;
              if (kj >= S || row >= S || (causal && kj > row) ||
                  (WINDOW && row - kj >= window))
                p = 0.f;
            }
            d[c] = p * (dp[e] - dl[i]);
          }
          dsa[j / 2][2 * (j % 2) + i] = pack_bf16(d[0], d[1]);
        }

      // dQ += dS K
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = make_desc(kb + kk * 16 * T::ROW, T::KV_BLOCK, T::ATOM, T::LAYOUT);
        Wgmma<HD>::rs(acc, dsa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(dsa[kk]);
      mbar_arrive(k_empty(st));
    }

    // epilogue: dQ * scale as bf16 through the strides
    __nv_bfloat16* qb = dq + b * sqb + h * sqh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row < S) {
        __nv_bfloat16* qrow = qb + static_cast<int64_t>(row) * sqs;
#pragma unroll
        for (int j = 0; j < HD_OUT / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j + c0) = __floats2bfloat162_rn(
              acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
      }
    }
  }
}

template <int HD, int HD_OUT, int PASS>
cudaError_t launch_main(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                        const CUtensorMap& tdo, const float* lse2, const float* delta,
                        void* dk, void* dv, float* part, int B, int S, int S_pad, int H,
                        int KV, int splits, int64_t skb, int64_t sks, int64_t skh,
                        int64_t svb, int64_t svs, int64_t svh, float scale, int causal,
                        int window, cudaStream_t stream) {
  using T = Tile<HD>;
  auto kern = window > 0 ? flash_bwd_sm90<HD, HD_OUT, PASS, true>
                         : flash_bwd_sm90<HD, HD_OUT, PASS, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockK - 1) / kBlockK, KV * splits, B);
  kern<<<grid, kThreads, T::SMEM, stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, S, S_pad, H, H / KV, splits, skb, sks, skh,
      svb, svs, svh, scale, causal, window);
  return cudaGetLastError();
}

template <int HD, int HD_OUT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse2, const float* delta, void* dq, void* dk, void* dv,
                   float* part, int B, int S, int S_pad, int H, int KV, int splits,
                   int64_t sqb, int64_t sqs,
                   int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb,
                   int64_t svs, int64_t svh, int64_t sdb, int64_t sds, int64_t sdh,
                   int64_t sdqb, int64_t sdqs, int64_t sdqh, int64_t sdkb, int64_t sdks,
                   int64_t sdkh, int64_t sdvb, int64_t sdvs, int64_t sdvh, float scale,
                   int causal, int window, cudaStream_t stream) {
  using T = Tile<HD>;
  // the main kernel's boxes: 64-row Q and dO tiles, 128-row K and V
  // tiles; the dQ kernel's: 128-row Q and dO tiles, 64-row K and V tiles
  CUtensorMap tq, tk, tv, tdo, uq, uk, uv, udo;
  if (!make_bf16_map(&tq, q, HD_OUT, B, S, H, sqb, sqs, sqh, T::BOX, kBlockQ) ||
      !make_bf16_map(&tdo, dout, HD_OUT, B, S, H, sdb, sds, sdh, T::BOX, kBlockQ) ||
      !make_bf16_map(&tk, k, HD_OUT, B, S, KV, skb, sks, skh, T::BOX, kBlockK) ||
      !make_bf16_map(&tv, v, HD_OUT, B, S, KV, svb, svs, svh, T::BOX, kBlockK) ||
      !make_bf16_map(&uq, q, HD_OUT, B, S, H, sqb, sqs, sqh, T::BOX, kDqRows) ||
      !make_bf16_map(&udo, dout, HD_OUT, B, S, H, sdb, sds, sdh, T::BOX, kDqRows) ||
      !make_bf16_map(&uk, k, HD_OUT, B, S, KV, skb, sks, skh, T::BOX, DqTile<HD>::BK) ||
      !make_bf16_map(&uv, v, HD_OUT, B, S, KV, svb, svs, svh, T::BOX, DqTile<HD>::BK))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (HD == 256) {
    err = launch_main<HD, HD_OUT, kDV>(tq, tk, tv, tdo, lse2, delta, dk, dv, part, B, S,
                                       S_pad, H, KV, splits, sdkb, sdks, sdkh, sdvb, sdvs, sdvh, scale, causal,
                                       window, stream);
    if (err != cudaSuccess) return err;
    err = launch_main<HD, HD_OUT, kDK>(tq, tk, tv, tdo, lse2, delta, dk, dv, part, B, S,
                                       S_pad, H, KV, splits, sdkb, sdks, sdkh, sdvb, sdvs, sdvh, scale, causal,
                                       window, stream);
  } else {
    err = launch_main<HD, HD_OUT, kAll>(tq, tk, tv, tdo, lse2, delta, dk, dv, part, B, S,
                                        S_pad, H, KV, splits, sdkb, sdks, sdkh, sdvb, sdvs, sdvh, scale,
                                        causal, window, stream);
  }
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const int64_t n = static_cast<int64_t>(B) * S * KV * HD_OUT;  // 2 tensors of pairs
    const int blocks = static_cast<int>(n / 256 + 1 < 8192 ? n / 256 + 1 : 8192);
    bwd_sum_heads<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const float2*>(part), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), B, S, KV, splits, HD_OUT, sdkb, sdks, sdkh, sdvb,
        sdvs, sdvh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kern = window > 0 ? flash_bwd_dq_sm90<HD, HD_OUT, true>
                         : flash_bwd_dq_sm90<HD, HD_OUT, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqTile<HD>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kDqRows - 1) / kDqRows, H, B);
  kern<<<grid, kThreads, DqTile<HD>::SMEM, stream>>>(
      uq, uk, uv, udo, lse2, delta, static_cast<__nv_bfloat16*>(dq), S, S_pad, H / KV,
      sdqb, sdqs, sdqh, scale, causal, window);
  return cudaGetLastError();
}

// The head dims the kernel is built for, each with the head dim of its tile.
#define REPRO_FA_HEAD_DIMS(X) X(32, 32) X(64, 64) X(112, 128) X(128, 128) X(256, 256)

}  // namespace

// bf16 only; strides in elements. q, k, v, dout: TMA-addressable (16-byte
// aligned base, strides of whole 16 bytes), which the Python wrapper
// checks. lse: the forward's contiguous fp32 (B, H, S). Scratch from the
// caller: lse2 and delta, fp32 (B*H, S_pad) each with S_pad = S rounded up
// to 64; with `splits` > 1 (the query heads of a KV head over that many
// blocks), part, fp32 2 x (B, S, KV * splits, hd). dq, dk, dv: bf16,
// written through their strides. `window`: 0, or a sliding window under
// `causal`.
extern "C" int repro_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* lse2, float* delta, void* dq, void* dk, void* dv, float* part,
    int B, int S, int H, int KV, int hd, int splits, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int64_t sob, int64_t sos,
    int64_t soh, int64_t sdb, int64_t sds, int64_t sdh, int64_t sdqb, int64_t sdqs,
    int64_t sdqh, int64_t sdkb, int64_t sdks, int64_t sdkh, int64_t sdvb, int64_t sdvs,
    int64_t sdvh, float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || splits <= 0 ||
      (H / KV) % splits != 0 || (splits > 1 && part == nullptr) || window < 0 ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S_pad = (S + kBlockQ - 1) / kBlockQ * kBlockQ;
  const int64_t n_rows = static_cast<int64_t>(B) * H * S_pad;
  int lanes = 4;
  while (8 * lanes < hd) lanes *= 2;
  const int64_t rows_a_block = 256 / lanes;
  bwd_prologue<<<static_cast<unsigned>((n_rows + rows_a_block - 1) / rows_a_block), 256, 0,
                 st>>>(static_cast<const __nv_bfloat16*>(o),
                       static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, S, S_pad,
                       H, hd, lanes, sob, sos, soh, sdb, sds, sdh, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define REPRO_FA_CASE(HD_, TILE_)                                                        \
  case HD_:                                                                              \
    return (int)launch<TILE_, HD_>(q, k, v, dout, lse2, delta, dq, dk, dv, part, B, S,   \
                                   S_pad, H, KV, splits, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,  \
                                   sdb, sds, sdh, sdqb, sdqs, sdqh, sdkb, sdks, sdkh,   \
                                   sdvb, sdvs, sdvh, scale, causal, window, st);
  switch (hd) {
    REPRO_FA_HEAD_DIMS(REPRO_FA_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

// Bytes of dynamic shared memory a block of the main kernel (`dq` = 0) or
// of the dQ kernel (1) takes at head dim `hd` (0 for a head dim the kernel
// is not built for).
extern "C" int repro_flash_attention_bwd_sm90_smem_bytes(int hd, int dq) {
#define REPRO_FA_SMEM(HD_, TILE_) \
  case HD_:                       \
    return dq ? DqTile<TILE_>::SMEM : Tile<TILE_>::SMEM;
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
