// Flash-attention backward for Hopper (sm_90a), fp32 math: the float32
// route's gradient. bf16 inputs go to the tensor-core backward in
// flash_attention_bwd_sm90.cu.
//
// The gradient of the forward in flash_attention.cu, which replaces the
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
// (query, key) pair against a few bytes per row, so arithmetic, as in the
// forward. It stays scalar fp32 FMAs from shared memory (67 TFLOP/s peak
// outside the tensor cores) on purpose: TF32 products would miss the 2e-4
// that the float32 training path is held to. At the training path's small
// shapes it is bound by its three launches, not by either.
//
// Design (FA2's backward, dQ in a pass of its own, as the bf16 route). Three
// launches on the caller's stream:
//  1. prologue: a warp a query row computes delta = rowsum(dO * O) into a
//     contiguous (B, H, S) array;
//  2. dK, dV: one block of 128 threads per (BK-key tile, KV head, batch),
//     looping over the G = H / KV query heads that read its KV head and
//     over the BQ-row query tiles that see its keys (from the key tile's
//     own when causal, to the last query its window reaches), so dK and dV
//     build up in registers with no atomics. K and V are staged once; per
//     step the Q and dO tiles, their LSE and delta rows are staged, and
//     each thread computes a (BK/16) x (BQ/8) patch of
//       S^T = K Q^T,  P^T = exp(S^T scale - LSE) masked to 0,
//       dP^T = V dO^T,  dS^T = P^T (dP^T - delta),
//     P^T and dS^T go to shared memory, and each thread adds a
//     (BK/16) x (hd/8) patch of dV += P^T dO and dK += dS^T Q;
//  3. dQ: one block per (BQ-row query tile, head, batch), shaped as the
//     forward: per key tile S = Q K^T, P, dP = dO V^T and dS as above, then
//     dQ += dS K; dQ * scale stored.
// So nothing of size S x S is written to device memory, and each of the
// seven products (S and dP in both kernels, dV, dK, dQ) is done once a
// visited pair. Rows are padded by one float so that the strided reads hit
// distinct banks. Masking (causal, the sliding window, keys and rows past
// a ragged S) sets P to 0, so a tile may hold masked pairs. Head dim 256
// takes 32-row tiles (the forward's q tile there), the others 64. GQA:
// query head h reads KV head h / (H / KV). Every operand is read and
// written through its (batch, seq, head) strides; the last dim must be
// contiguous.
//
// Sliding window (`window` > 0, causal only: key k is seen by query q iff
// k <= q and q - k < window, the JAX layers' _mask): a key tile's query
// loop ends at k0 + BK - 1 + window - 1, a query tile's key loop starts at
// the tile that holds q0 - window + 1.
//
// C entry: repro_flash_attention_bwd, launched on the caller's stream; it
// allocates nothing (the caller gives delta's scratch) and returns the
// first launch error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Keys a dK/dV block and queries a step (BK, BQ), and the dQ kernel's rows
// a block and keys a step: the same tile at one head dim.
template <int HD>
struct Tile {
  static constexpr int N = HD == 256 ? 32 : 64;
  static constexpr int LD = HD + 1;  // a staged row, padded
  static constexpr int LDP = N + 1;  // a row of P or dS, padded
  // dK/dV: K, V, Q and dO tiles; P^T and dS^T; LSE and delta rows
  static constexpr int SMEM = sizeof(float) * (4 * N * LD + 2 * N * LDP + 2 * N);
  // dQ: Q, dO, K and V tiles; dS
  static constexpr int DQ_SMEM = sizeof(float) * (4 * N * LD + N * LDP);
};

// Copy `rows` x HD floats starting at sequence position `s0` into a shared
// tile with row pitch HD + 1; rows at or past S are zero.
template <int HD>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int64_t stride_s,
                                           int s0, int rows, int S) {
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    const int s = s0 + r;
    dst[r * (HD + 1) + c] = s < S ? src[static_cast<int64_t>(s) * stride_s + c] : 0.f;
  }
}

// Whether query `qi` sees key `kj` (both < S checked by the caller).
__device__ __forceinline__ bool visible(int qi, int kj, int causal, int window) {
  return !(causal && kj > qi) && !(window && qi - kj >= window);
}

// delta = rowsum(dO * O): a warp a (batch, head, row), into (B, H, S).
__global__ void bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                          float* __restrict__ delta, int S, int H, int hd, int64_t sob,
                          int64_t sos, int64_t soh, int64_t sdb, int64_t sds, int64_t sdh,
                          int64_t n_rows) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % S);
  const int64_t bh = row / S;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const float* orow = o + b * sob + i * sos + h * soh;
  const float* drow = dout + b * sdb + i * sds + h * sdh;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(orow[c], drow[c], acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int S, int H, int group,
               int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
               int64_t skh, int64_t svb, int64_t svs, int64_t svh, int64_t sdb,
               int64_t sds, int64_t sdh, int64_t sdkb, int64_t sdks, int64_t sdkh,
               int64_t sdvb, int64_t sdvs, int64_t sdvh, float scale, int causal,
               int window) {
  using T = Tile<HD>;
  constexpr int BK = T::N, BQ = T::N, LD = T::LD, LDP = T::LDP;
  constexpr int RK = BK / 16;  // keys per thread
  constexpr int SC = BQ / 8;   // queries per thread in a score patch
  constexpr int NC = HD / 8;   // output columns per thread

  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Qs = Vs + BK * LD;    // [BQ][LD]
  float* Ds = Qs + BQ * LD;    // [BQ][LD], dO
  float* Ps = Ds + BQ * LD;    // [BK][LDP], P^T
  float* Ss = Ps + BK * LDP;   // [BK][LDP], dS^T
  float* Ls = Ss + BK * LDP;   // [BQ], LSE
  float* Es = Ls + BQ;         // [BQ], delta

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // key group 0..15
  const int tx = tid & 7;   // lane within the key group
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  stage_tile<HD>(Ks, k + b * skb + hk * skh, sks, k0, BK, S);
  stage_tile<HD>(Vs, v + b * svb + hk * svh, svs, k0, BK, S);

  float dk_acc[RK][NC];
  float dv_acc[RK][NC];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_acc[r][c] = 0.f;
      dv_acc[r][c] = 0.f;
    }

  // the queries that see these keys: from the key tile's own (causal) to
  // the last one the window of its last key reaches (window implies causal)
  const int qt0 = causal ? k0 / BQ : 0;
  const int q_end = window ? min(S, k0 + BK + window - 1) : S;
  const int qt_end = (q_end + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qb = q + b * sqb + h * sqh;
    const float* db = dout + b * sdb + h * sdh;
    const float* lb = lse + (static_cast<int64_t>(b) * H + h) * S;
    const float* eb = delta + (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = qt0; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous step's reads of Q, dO, P^T, dS^T done
      stage_tile<HD>(Qs, qb, sqs, q0, BQ, S);
      stage_tile<HD>(Ds, db, sds, q0, BQ, S);
      for (int i = tid; i < BQ; i += kThreads) {
        Ls[i] = q0 + i < S ? lb[q0 + i] : 0.f;
        Es[i] = q0 + i < S ? eb[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T, then P^T
      float s[RK][SC];
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[RK];
        float qv[SC];
#pragma unroll
        for (int r = 0; r < RK; ++r) kv[r] = Ks[(ty * RK + r) * LD + d];
#pragma unroll
        for (int j = 0; j < SC; ++j) qv[j] = Qs[(tx + 8 * j) * LD + d];
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int j = 0; j < SC; ++j) s[r][j] = fmaf(kv[r], qv[j], s[r][j]);
      }
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const int kj = k0 + ty * RK + r;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int qi = q0 + tx + 8 * j;
          const float p = kj < S && qi < S && visible(qi, kj, causal, window)
                              ? expf(s[r][j] * scale - Ls[tx + 8 * j])
                              : 0.f;
          Ps[(ty * RK + r) * LDP + tx + 8 * j] = p;
        }
      }

      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float vv[RK];
        float dv_[SC];
#pragma unroll
        for (int r = 0; r < RK; ++r) vv[r] = Vs[(ty * RK + r) * LD + d];
#pragma unroll
        for (int j = 0; j < SC; ++j) dv_[j] = Ds[(tx + 8 * j) * LD + d];
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int j = 0; j < SC; ++j) s[r][j] = fmaf(vv[r], dv_[j], s[r][j]);
      }
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int e = (ty * RK + r) * LDP + tx + 8 * j;
          Ss[e] = Ps[e] * (s[r][j] - Es[tx + 8 * j]);
        }
      __syncthreads();  // P^T and dS^T written

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 4
      for (int j = 0; j < BQ; ++j) {
        float pv[RK];
        float sv[RK];
        float dov[NC];
        float qv[NC];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          pv[r] = Ps[(ty * RK + r) * LDP + j];
          sv[r] = Ss[(ty * RK + r) * LDP + j];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = Ds[j * LD + tx + 8 * c];
          qv[c] = Qs[j * LD + tx + 8 * c];
        }
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[r][c] = fmaf(pv[r], dov[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(sv[r], qv[c], dk_acc[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int kj = k0 + ty * RK + r;
    if (kj < S) {
      float* krow = dk + b * sdkb + static_cast<int64_t>(kj) * sdks + hk * sdkh;
      float* vrow = dv + b * sdvb + static_cast<int64_t>(kj) * sdvs + hk * sdvh;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        krow[tx + 8 * c] = dk_acc[r][c] * scale;
        vrow[tx + 8 * c] = dv_acc[r][c];
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int S, int group, int64_t sqb, int64_t sqs,
             int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb,
             int64_t svs, int64_t svh, int64_t sdb, int64_t sds, int64_t sdh,
             int64_t sdqb, int64_t sdqs, int64_t sdqh, float scale, int causal,
             int window) {
  using T = Tile<HD>;
  constexpr int BQ = T::N, BK = T::N, LD = T::LD, LDP = T::LDP;
  constexpr int RQ = BQ / 16;  // query rows per thread
  constexpr int SC = BK / 8;   // keys per thread in a score patch
  constexpr int NC = HD / 8;   // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* Ds = Qs + BQ * LD;    // [BQ][LD], dO
  float* Ks = Ds + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Ps = Vs + BK * LD;    // [BQ][LDP], dS

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // row group 0..15
  const int tx = tid & 7;   // lane within the row group
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal loop first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;

  stage_tile<HD>(Qs, q + b * sqb + h * sqh, sqs, q0, BQ, S);
  stage_tile<HD>(Ds, dout + b * sdb + h * sdh, sds, q0, BQ, S);
  const float* kb = k + b * skb + (h / group) * skh;
  const float* vb = v + b * svb + (h / group) * svh;
  const int64_t vrow = (static_cast<int64_t>(b) * gridDim.y + h) * S;
  float l[RQ], e[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qi = q0 + ty * RQ + r;
    l[r] = qi < S ? lse[vrow + qi] : 0.f;
    e[r] = qi < S ? delta[vrow + qi] : 0.f;
  }

  float acc[RQ][NC];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_k = (k_end + BK - 1) / BK;
  // the first tile of the first row's window (window implies causal)
  const int kt0 = window ? max(0, q0 - window + 1) / BK : 0;
  for (int kt = kt0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q, dO staged / the previous step's reads done
    stage_tile<HD>(Ks, kb, sks, k0, BK, S);
    stage_tile<HD>(Vs, vb, svs, k0, BK, S);
    __syncthreads();

    float s[RQ][SC];
    float dp[RQ][SC];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[r][j] = 0.f;
        dp[r][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RQ];
      float dov[RQ];
      float kv[SC];
      float vv[SC];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        qv[r] = Qs[(ty * RQ + r) * LD + d];
        dov[r] = Ds[(ty * RQ + r) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        kv[j] = Ks[(tx + 8 * j) * LD + d];
        vv[j] = Vs[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
          dp[r][j] = fmaf(dov[r], vv[j], dp[r][j]);
        }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qi = q0 + ty * RQ + r;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kj = k0 + tx + 8 * j;
        const float p = kj < S && qi < S && visible(qi, kj, causal, window)
                            ? expf(s[r][j] * scale - l[r])
                            : 0.f;
        Ps[(ty * RQ + r) * LDP + tx + 8 * j] = p * (dp[r][j] - e[r]);
      }
    }
    __syncthreads();  // dS written

    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[RQ];
      float kv[NC];
#pragma unroll
      for (int r = 0; r < RQ; ++r) sv[r] = Ps[(ty * RQ + r) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[j * LD + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(sv[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qi = q0 + ty * RQ + r;
    if (qi < S) {
      float* qrow = dq + b * sdqb + static_cast<int64_t>(qi) * sdqs + h * sdqh;
#pragma unroll
      for (int c = 0; c < NC; ++c) qrow[tx + 8 * c] = acc[r][c] * scale;
    }
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* delta, float* dq, float* dk, float* dv,
                   int B, int S, int H, int KV, int64_t sqb, int64_t sqs, int64_t sqh,
                   int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
                   int64_t svh, int64_t sdb, int64_t sds, int64_t sdh, int64_t sdqb,
                   int64_t sdqs, int64_t sdqh, int64_t sdkb, int64_t sdks, int64_t sdkh,
                   int64_t sdvb, int64_t sdvs, int64_t sdvh, float scale, int causal,
                   int window, cudaStream_t stream) {
  using T = Tile<HD>;
  auto dkdv = flash_bwd_dkdv<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((S + T::N - 1) / T::N, KV, B), kThreads, T::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, H / KV, sqb, sqs, sqh, skb, sks, skh, svb,
      svs, svh, sdb, sds, sdh, sdkb, sdks, sdkh, sdvb, sdvs, sdvh, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dqk = flash_bwd_dq<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::DQ_SMEM);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((S + T::N - 1) / T::N, H, B), kThreads, T::DQ_SMEM, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H / KV, sqb, sqs, sqh, skb, sks, skh, svb, svs,
      svh, sdb, sds, sdh, sdqb, sdqs, sdqh, scale, causal, window);
  return cudaGetLastError();
}

// The head dims the kernels are built for.
#define REPRO_FA_HEAD_DIMS(X) X(32) X(64) X(112) X(128) X(256)

}  // namespace

// float32 only; strides in elements, every last dim contiguous. lse: the
// forward's contiguous fp32 (B, H, S). delta: the caller's fp32 (B, H, S)
// scratch. dq, dk, dv: written through their strides. `window`: 0, or a
// sliding window under `causal`.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
    int KV, int hd, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int64_t sob, int64_t sos,
    int64_t soh, int64_t sdb, int64_t sds, int64_t sdh, int64_t sdqb, int64_t sdqs,
    int64_t sdqh, int64_t sdkb, int64_t sdks, int64_t sdkh, int64_t sdvb, int64_t sdvs,
    int64_t sdvh, float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_rows = static_cast<int64_t>(B) * H * S;
  bwd_delta<<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta, S, H, hd, sob,
      sos, soh, sdb, sds, sdh, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define REPRO_FA_CASE(HD_)                                                             \
  case HD_:                                                                            \
    return (int)launch<HD_>(                                                           \
        static_cast<const float*>(q), static_cast<const float*>(k),                    \
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,     \
        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), B, \
        S, H, KV, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sdb, sds, sdh, sdqb,   \
        sdqs, sdqh, sdkb, sdks, sdkh, sdvb, sdvs, sdvh, scale, causal, window, st);
  switch (hd) {
    REPRO_FA_HEAD_DIMS(REPRO_FA_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

// Bytes of dynamic shared memory a block of the dK/dV kernel (`dq` = 0) or
// of the dQ kernel (1) takes at head dim `hd` (0 for a head dim the kernels
// are not built for).
extern "C" int repro_flash_attention_bwd_smem_bytes(int hd, int dq) {
#define REPRO_FA_SMEM(HD_) \
  case HD_:                \
    return dq ? Tile<HD_>::DQ_SMEM : Tile<HD_>::SMEM;
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
