// Flash-attention forward for Hopper (sm_90a), float32 accurate: the
// float32 route; bf16 inputs go to the wgmma kernel in
// flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention): out = softmax(q k^T * scale) v, with
// an optional causal mask written as -1e30 and out = acc / max(l, 1e-30).
//
// What bounds it on an H100: at the serving shapes (head_dim 128, S >= 256)
// attention does 4*S*S*hd/2 operations per (batch, head) against
// 2*S*hd*2 floats of K/V, far above the card's operations per byte, so it
// is bound by arithmetic. Scalar fp32 FMAs peak at 67 TFLOP/s. A single
// TF32 tensor-core product keeps ~3 decimal digits and would break the
// route's 2e-4 agreement; three of them (3xTF32, tf32x3.cuh: each operand
// split as hi + lo in registers, a_lo b_hi + a_hi b_lo + a_hi b_hi into an
// fp32 accumulator) keep ~2^-21 relative error a product, at 495 / 3 = 165
// TFLOP/s. That is this kernel's arithmetic, on mma.sync.m16n8k8.
//
// Why mma.sync and not wgmma: wgmma takes .tf32 operands K-major only,
// and P V's V is MN-major in memory (a transposing pass a tile), and hi/lo
// tiles for wgmma would double every tile in shared memory. mma.sync
// fragments are read from fp32 tiles in either orientation and split as
// they are loaded, so only fp32 tiles live in shared memory.
//
// Design. A block of W = BQ / 16 warps per (q tile of BQ rows, head,
// batch); a warp owns 16 query rows. The Q tile is copied once; K and V
// tiles of BK rows go through a two-stage ring filled with cp.async, the
// next tile's copy in flight while this tile's products run (16-byte
// cp.async.cg where q, k and v rows are all 16-byte aligned, else 4-byte
// cp.async.ca: any (batch, seq, head) strides with a contiguous last dim
// are read as they are; a runtime flag, so that one instance holds both
// and the build stays at 15 instances). Per key tile a warp computes S = Q K^T (natural
// slots), masks and scales it, keeps the row max and normaliser over the
// 4 lanes of a quad, and feeds P from its accumulators straight into
// O += P V (paired slots: V read as tile[2t][g]). Rows are padded to HD + 4
// floats, so every fragment read is free of bank conflicts. The BQ and BK
// tiles come from kernels/flash_attention.py:fp32_plan: 64-row q tiles,
// and 32 or 16 rows where 64 would leave SMs idle; keys 64 a tile at hd
// <= 64, 32 above (registers: O is hd / 2 floats a thread).
// Under `causal` the loop stops at the diagonal tile, and masking inside
// the diagonal tile and past the end of a ragged last tile uses -1e30, so S
// need not be a multiple of the tile; a warp skips a tile whose every pair
// is masked (its rows would add exact zeros). A sliding window (`window` >
// 0, causal only: key k is seen by query q iff k <= q and q - k < window,
// the JAX layers' _mask) starts the loop at the tile that holds the tile's
// first row's first key, q0 - window + 1, and masks the keys before each
// row's window: the loop visits ~window keys a row, not q. A row whose
// keys in an early tile are all masked takes exp(0) = 1 for each until its
// first unmasked score, whose max scales that sum and the output by
// exp(-1e30 - max) = 0, as for rows past the diagonal; every row sees its
// own key. GQA: query head h reads KV head h / (H / KV). Q tiles are issued
// last-first so the longest causal tiles start first.
//
// Training: given a pointer, the epilogue also writes each row's
// log-sum-exp of the scaled, masked scores, m + log l, which the backward
// (flash_attention_bwd.cu) recomputes P from.
//
// C entry: repro_flash_attention_fwd, launched on the caller's stream; it
// allocates nothing and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float kNegInf = -1e30f;

// Keys a tile at head dim HD (the plan's `step`)
template <int HD>
__host__ __device__ constexpr int block_k() {
  return HD <= 64 ? 64 : 32;
}

template <int HD, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HD + 4) * (BQ + 4 * block_k<HD>());
}

template <int HD, int BQ>
__global__ void __launch_bounds__(BQ * 2)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int S, int group,
               int64_t sqb, int64_t sqs, int64_t sqh,
               int64_t skb, int64_t sks, int64_t skh,
               int64_t svb, int64_t svs, int64_t svh,
               int64_t sob, int64_t sos, int64_t soh,
               float scale, int causal, int window, int vec) {
  constexpr int BK = block_k<HD>();
  constexpr int NTHREADS = BQ * 2;  // a warp per 16 rows
  constexpr int LD = HD + 4;
  constexpr int NT = BK / 8;        // score tiles of 8 keys
  constexpr int KS = HD / 8;        // k-steps over hd, and output tiles

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* Ks = Qs + BQ * LD;                     // [2][BK][LD]
  float* Vs = Ks + 2 * BK * LD;                 // [2][BK][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + (h / group) * skh;
  const float* vb = v + b * svb + (h / group) * svh;

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_k = (k_end + BK - 1) / BK;
  // a window's first key for the tile's first row (window implies causal)
  const int kt0 = window ? max(0, q0 - window + 1) / BK : 0;

  stage_rows<HD, BQ, NTHREADS>(Qs, qb, sqs, q0, S, vec);
  stage_rows<HD, BK, NTHREADS>(Ks, kb, sks, kt0 * BK, S, vec);
  stage_rows<HD, BK, NTHREADS>(Vs, vb, svs, kt0 * BK, S, vec);
  cp_commit();

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const int row_lo = q0 + warp * 16;
  const int rows[2] = {row_lo + g, row_lo + g + 8};
  const float* Qw = Qs + warp * 16 * LD;

  for (int kt = kt0; kt < n_k; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < n_k) {
      stage_rows<HD, BK, NTHREADS>(Ks + (st ^ 1) * BK * LD, kb, sks, (kt + 1) * BK, S, vec);
      stage_rows<HD, BK, NTHREADS>(Vs + (st ^ 1) * BK * LD, vb, svs, (kt + 1) * BK, S, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this tile (and Q) landed for every thread
    const int k0 = kt * BK;
    const bool masked = row_lo >= S || (causal && k0 > row_lo + 15) ||
                        (window && row_lo - (k0 + BK - 1) >= window);
    if (!masked) {
      const float* Kt = Ks + st * BK * LD;
      const float* Vt = Vs + st * BK * LD;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        float a[4];
        uint32_t ahi[4], alo[4];
        load_a(Qw + ks * 8, LD, g, t, a);
        split(a, ahi, alo);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float bf[2];
          uint32_t bhi[2], blo[2];
          load_b_nk(Kt + j * 8 * LD + ks * 8, LD, g, t, bf);
          split(bf, bhi, blo);
          mma3(s[j], ahi, alo, bhi, blo);
        }
      }
      // mask (where some pair of the warp's tile is masked) and scale; the
      // new row max over the quad
      const bool whole = (!causal || k0 + BK - 1 <= row_lo) && k0 + BK <= S &&
                         (!window || row_lo + 15 - k0 < window);
      float mx[2] = {m[0], m[1]};
      if (whole) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= scale;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = rows[e >> 1];
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            float x = s[j][e] * scale;
            if (kj >= S || (causal && kj > qi) || (window && qi - kj >= window)) x = kNegInf;
            s[j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      const float alpha[2] = {__expf(m[0] - mx[0]), __expf(m[1] - mx[1])};
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[j][e] - mx[e >> 1]);
          s[j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + sum[r];
        m[r] = mx[r];
      }
      // O = O alpha + P V: P from the accumulators (paired slots). A
      // tile's P V is summed apart and added to O with fp32 FMAs: the
      // tensor cores round their fp32 sums toward zero, which over a long
      // key loop would pile up.
      uint32_t phi[NT][4], plo[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float a[4];
        c_as_a(s[j], a);
        split(a, phi[j], plo[j]);
      }
      // NG output tiles at a time: independent sums for the tensor cores
      constexpr int NG = KS % 4 == 0 ? 4 : 2;
#pragma unroll
      for (int n0 = 0; n0 < KS; n0 += NG) {
        float pv[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            float bf[2];
            uint32_t bhi[2], blo[2];
            load_b_kn(Vt + j * 8 * LD + (n0 + n) * 8, LD, g, t, bf);
            split(bf, bhi, blo);
            mma3(pv[n], phi[j], plo[j], bhi, blo);
          }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e >> 1], pv[n][e]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = rows[r];
    if (qi < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      if (lse != nullptr && t == 0)
        lse[(static_cast<int64_t>(b) * gridDim.y + h) * S + qi] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
      float* orow = o + b * sob + static_cast<int64_t>(qi) * sos + h * soh;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        orow[n * 8 + 2 * t] = acc[n][2 * r] * inv;
        orow[n * 8 + 2 * t + 1] = acc[n][2 * r + 1] * inv;
      }
    }
  }
}

// The head dims the kernel is built for, and the q tiles (BQ rows) the
// plan may pick at each.
#define REPRO_FA_HEAD_DIMS(X) X(32) X(64) X(112) X(128) X(256)
#define REPRO_FA_ROWS(X, HD_) X(HD_, 16) X(HD_, 32) X(HD_, 64)

template <int HD, int BQ>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   int B, int S, int H, int KV,
                   int64_t sqb, int64_t sqs, int64_t sqh,
                   int64_t skb, int64_t sks, int64_t skh,
                   int64_t svb, int64_t svs, int64_t svh,
                   int64_t sob, int64_t sos, int64_t soh,
                   float scale, int causal, int window, int vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ>();
  auto kern = flash_fwd_fp32<HD, BQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, BQ * 2, smem, stream>>>(q, k, v, o, lse, S, H / KV, sqb, sqs, sqh, skb,
                                       sks, skh, svb, svs, svh, sob, sos, soh, scale,
                                       causal, window, vec);
  return cudaGetLastError();
}

}  // namespace

// float32 only. Strides are in elements. `window`: 0, or a sliding window
// under `causal`. `lse`: null, or a contiguous fp32 (B, H, S) that receives
// each row's log-sum-exp (what the backward kernel recomputes P from).
// `rows`, `step`: the plan's q tile and key tile (fp32_plan; step must be
// the head dim's). `vec`: 1 where every row of q, k and v is 16-byte
// aligned (16-byte copies), else 0.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int S, int H, int KV, int hd,
    int64_t sqb, int64_t sqs, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh,
    int64_t sob, int64_t sos, int64_t soh,
    float scale, int causal, int window, float* lse, int rows, int step, int vec,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(HD_, BQ_)                                                         \
  if (hd == HD_ && rows == BQ_ && step == block_k<HD_>())                               \
    return (int)launch<HD_, BQ_>(                                                        \
        static_cast<const float*>(q), static_cast<const float*>(k),                     \
        static_cast<const float*>(v), static_cast<float*>(o), lse, B, S, H, KV, sqb, sqs, \
        sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh, scale, causal, window, vec, st);
#define REPRO_FA_HD(HD_) REPRO_FA_ROWS(REPRO_FA_CASE, HD_)
  REPRO_FA_HEAD_DIMS(REPRO_FA_HD)
#undef REPRO_FA_HD
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}

namespace {

// The ceiling of this route's products on the card: TF32
// mma.sync.m16n8k8 from registers alone, 4 independent sums a warp (one
// sum's 33-cycle latency hides behind the others); the host launches 8
// warps an SM. 3xTF32 divides the rate it reaches by three.
__global__ void __launch_bounds__(128) tf32_mma_rate(float* out, int iters) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = tf32x3::to_tf32(1.f + threadIdx.x * 1e-3f + i);
#pragma unroll
  for (int i = 0; i < 2; ++i) b[i] = tf32x3::to_tf32(0.5f + threadIdx.x * 1e-3f + i);
  float d[4][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 4; ++c) tf32x3::mma(d[c], a, b);
  out[blockIdx.x * blockDim.x + threadIdx.x] =
      d[0][0] + d[1][1] + d[2][2] + d[3][3];
}

}  // namespace

// Launch tf32_mma_rate on `blocks` blocks of 128 threads, each warp doing
// 4 * iters products of 16 x 8 x 8 (2048 operations each); `out` takes
// blocks * 128 floats. Returns the launch error.
extern "C" int repro_tf32_mma_rate(float* out, int blocks, int iters, void* stream) {
  tf32_mma_rate<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block takes at head dim `hd` with q
// tiles of `rows` (0 for an instance the kernel is not built for).
extern "C" int repro_flash_attention_smem_bytes(int hd, int rows) {
#define REPRO_FA_SMEM(HD_, BQ_) \
  if (hd == HD_ && rows == BQ_) return (int)smem_bytes<HD_, BQ_>();
#define REPRO_FA_HD(HD_) REPRO_FA_ROWS(REPRO_FA_SMEM, HD_)
  REPRO_FA_HEAD_DIMS(REPRO_FA_HD)
#undef REPRO_FA_HD
#undef REPRO_FA_SMEM
  return 0;
}
