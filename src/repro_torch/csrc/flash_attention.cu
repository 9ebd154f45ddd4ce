// Flash-attention forward for Hopper (sm_90a): online softmax, fp32 math.
// This is the float32 route; bf16 inputs go to the tensor-core kernel in
// flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention): out = softmax(q k^T * scale) v, with
// an optional causal mask written as -1e30 and out = acc / max(l, 1e-30).
//
// What bounds it on an H100: at the serving shapes (head_dim 128, S >= 256)
// attention does 4*S*S*hd/2 operations per (batch, head) against
// 2*S*hd*2 bytes of K/V, far above the card's ~295 operations per byte, so
// it is bound by arithmetic. This first version does that arithmetic as
// scalar fp32 FMAs from shared memory (67 TFLOP/s peak outside the tensor
// cores). It stays scalar on purpose: TF32 tensor-core products would miss
// the 1e-4 agreement that the float32 model checks hold the card to.
//
// Design. One block of 128 threads per (q tile of BQ rows, head, batch).
// The Q tile is staged once in shared memory as fp32, pre-scaled. The block
// loops over K/V tiles of 64 rows: K is staged, each thread computes a
// (BQ/16) x 8 patch of scores, the running max m and normaliser l are
// updated with warp shuffles (the 8 threads of a row group are adjacent
// lanes), P goes to shared memory, V replaces K in the same buffer, and each
// thread accumulates a (BQ/16) x (hd/8) patch of the output in registers.
// So nothing of size S x S is ever written to device memory, and K/V are
// read once per q tile. Rows are padded by one float so that the strided
// reads of the score loop hit distinct banks.
// Under `causal` the loop stops at the diagonal tile, and masking inside the
// diagonal tile and past the end of a ragged last tile uses -1e30, so S need
// not be a multiple of the tile. A sliding window (`window` > 0, causal
// only: key k is seen by query q iff k <= q and q - k < window, the JAX
// layers' _mask) starts the loop at the tile that holds the tile's first
// row's first key, q0 - window + 1, and masks the keys before each row's
// window: the loop visits ~window keys a row, not q. A row whose keys in an
// early tile are all masked takes exp(0) = 1 for each until its first
// unmasked score, whose max scales that sum and the output by exp(-1e30 -
// max) = 0, as for rows past the diagonal; every row sees its own key. q/k/v/o are read and written through their
// (batch, seq, head) strides; the last dim must be contiguous. GQA: query
// head h reads KV head h / (H / KV). Q tiles are issued last-first so the
// longest causal tiles start first.
//
// Training: given a pointer, the epilogue also writes each row's
// log-sum-exp of the scaled, masked scores, m + log l, which the backward
// (flash_attention_bwd.cu) recomputes P from; an instance of its own, so
// that a call without it runs the same code as before.
//
// C entry: repro_flash_attention_fwd, launched on the caller's stream; it
// allocates nothing and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Copy `rows` x HD elements starting at sequence position `s0` into a
// shared tile with row pitch HD + 1, as fp32 times `mul`; rows at or past S
// are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int64_t stride_s,
                                           int s0, int rows, int S, float mul) {
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    const int s = s0 + r;
    dst[r * (HD + 1) + c] = s < S ? to_f32(src[(int64_t)s * stride_s + c]) * mul : 0.f;
  }
}

// LSE: whether the epilogue also writes each row's log-sum-exp (training).
template <typename T, int HD, int BQ, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int group,
                 int64_t sqb, int64_t sqs, int64_t sqh,
                 int64_t skb, int64_t sks, int64_t skh,
                 int64_t svb, int64_t svs, int64_t svh,
                 int64_t sob, int64_t sos, int64_t soh,
                 float scale, int causal, int window) {
  constexpr int RQ = BQ / 16;      // query rows per thread
  constexpr int NC = HD / 8;       // output columns per thread
  constexpr int SC = kBlockK / 8;  // score columns per thread
  constexpr int LD = HD + 1;
  constexpr int LDP = kBlockK + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][LD]
  float* KVs = Qs + BQ * LD;          // [kBlockK][LD], K then V
  float* Ps = KVs + kBlockK * LD;     // [BQ][LDP]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // row group 0..15
  const int tx = tid & 7;   // lane within the row group
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + (h / group) * skh;
  const T* vb = v + b * svb + (h / group) * svh;
  T* ob = o + b * sob + h * soh;

  stage_tile<T, HD>(Qs, qb, sqs, q0, BQ, S, scale);

  float acc[RQ][NC];
  float m[RQ];
  float l[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_k = (k_end + kBlockK - 1) / kBlockK;
  // a window's first key for the tile's first row (window implies causal)
  const int kt0 = window ? max(0, q0 - window + 1) / kBlockK : 0;
  for (int kt = kt0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Q staged / previous V tile consumed
    stage_tile<T, HD>(KVs, kb, sks, k0, kBlockK, S, 1.f);
    __syncthreads();

    float s[RQ][SC];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RQ];
      float kv[SC];
#pragma unroll
      for (int r = 0; r < RQ; ++r) qv[r] = Qs[(ty * RQ + r) * LD + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) kv[j] = KVs[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qi = q0 + ty * RQ + r;
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kj = k0 + tx + 8 * j;
        if (kj >= S || (causal && kj > qi) || (window && qi - kj >= window))
          s[r][j] = kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = __expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = __expf(s[r][j] - mx);
        s[r][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
#pragma unroll
      for (int j = 0; j < SC; ++j) Ps[(ty * RQ + r) * LDP + tx + 8 * j] = s[r][j];
    }
    __syncthreads();  // K reads done, P written
    stage_tile<T, HD>(KVs, vb, svs, k0, kBlockK, S, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[RQ];
      float vv[NC];
#pragma unroll
      for (int r = 0; r < RQ; ++r) pv[r] = Ps[(ty * RQ + r) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = KVs[j * LD + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qi = q0 + ty * RQ + r;
    if (qi < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      if (LSE && tx == 0)
        lse[(static_cast<int64_t>(b) * gridDim.y + h) * S + qi] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
      T* orow = ob + (int64_t)qi * sos;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[tx + 8 * c] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

// Dynamic shared memory of one block: Q, K-or-V and P tiles in fp32.
template <int HD, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + kBlockK * (HD + 1) + BQ * (kBlockK + 1));
}

// The head dims the kernel is built for, each with its q tile (BQ rows).
#define REPRO_FA_HEAD_DIMS(X) X(32, 64) X(64, 64) X(112, 64) X(128, 64) X(256, 32)

template <typename T, int HD, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int S, int H, int KV,
                   int64_t sqb, int64_t sqs, int64_t sqh,
                   int64_t skb, int64_t sks, int64_t skh,
                   int64_t svb, int64_t svs, int64_t svh,
                   int64_t sob, int64_t sos, int64_t soh,
                   float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, BQ>();
  auto kern = lse != nullptr ? flash_fwd_kernel<T, HD, BQ, true>
                             : flash_fwd_kernel<T, HD, BQ, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, H / KV, sqb, sqs, sqh, skb, sks, skh, svb, svs,
      svh, sob, sos, soh, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int H, int KV,
                        int64_t sqb, int64_t sqs, int64_t sqh,
                        int64_t skb, int64_t sks, int64_t skh,
                        int64_t svb, int64_t svs, int64_t svh,
                        int64_t sob, int64_t sos, int64_t soh,
                        float scale, int causal, int window, cudaStream_t stream) {
#define REPRO_FA_CASE(HD_, BQ_)                                                        \
  case HD_:                                                                            \
    return launch<T, HD_, BQ_>(q, k, v, o, lse, B, S, H, KV, sqb, sqs, sqh, skb, sks, \
                               skh, svb, svs, svh, sob, sos, soh, scale, causal,      \
                               window, stream);
  switch (hd) {
    REPRO_FA_HEAD_DIMS(REPRO_FA_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

}  // namespace

// float32 only. Strides are in elements. `window`: 0, or a sliding window
// under `causal`. `lse`: null, or a contiguous fp32 (B, H, S) that receives
// each row's log-sum-exp (what the backward kernel recomputes P from).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int S, int H, int KV, int hd,
    int64_t sqb, int64_t sqs, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh,
    int64_t sob, int64_t sos, int64_t soh,
    float scale, int causal, int window, float* lse, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_hd<float>(hd, q, k, v, o, lse, B, S, H, KV, sqb, sqs, sqh, skb,
                                 sks, skh, svb, svs, svh, sob, sos, soh, scale, causal,
                                 window, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block takes at head dim `hd` (0 for a
// head dim the kernel is not built for).
extern "C" int repro_flash_attention_smem_bytes(int hd) {
#define REPRO_FA_SMEM(HD_, BQ_) \
  case HD_:                     \
    return (int)smem_bytes<HD_, BQ_>();
  switch (hd) {
    REPRO_FA_HEAD_DIMS(REPRO_FA_SMEM)
    default:
      return 0;
  }
#undef REPRO_FA_SMEM
}
