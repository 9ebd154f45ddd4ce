// Flash-attention backward for Hopper (sm_90a), float32 accurate: the
// float32 route's gradient. bf16 inputs go to the wgmma backward in
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
// What bounds it on an H100: five products of 2 * hd operations per
// visited (query, key) pair against a few bytes per row, so arithmetic, as
// in the forward. They run on the tensor cores in 3xTF32 (tf32x3.cuh:
// mma.sync.m16n8k8, each fp32 operand split as hi + lo in registers, three
// TF32 products into an fp32 accumulator, ~2^-21 relative error a product),
// at 165 TFLOP/s against the 67 of scalar FMAs, which keeps the float32
// training path within its 2e-4. At the training path's small shapes it is
// bound by latency and by how many SMs it fills, so the design is one
// launch whose tiles the plan sizes to fill the card.
//
// Design: one launch, two kinds of block in one grid (FA2's backward, dQ
// apart from dK/dV so that neither needs atomics); neither depends on the
// other, both read only q, k, v, out, dy and the LSE:
//  - dK/dV blocks (the first ones): one per (N-key tile, KV head, share of
//    its G = H / KV query heads, batch). K and V are copied once; the block
//    steps over its query heads and the M-row query tiles that see its keys
//    (from the key tile's own when causal, to the last query its window
//    reaches), Q, dO, O and LSE rows through a two-stage cp.async ring (O
//    from global memory at hd 256, for shared memory). Per step it
//    recomputes delta = rowsum(dO * O) for the staged rows (hd FMAs a
//    row), then a warp computes S^T = K Q^T and
//    dP^T = V dO^T for its 16 keys and a share of the queries,
//    P^T = exp(S^T scale - LSE) masked to 0 and dS^T = P^T (dP^T - delta)
//    into shared tiles, and adds dV += P^T dO and dK += dS^T Q for its 16
//    keys and a share of hd's columns in registers. Where the plan splits a
//    KV head's query heads over blocks (too few dK/dV blocks otherwise),
//    each writes fp32 partials; the last block of a key tile to finish (a
//    counter in global memory, reset by that block) sums them in split
//    order, so the result does not depend on which block came last.
//  - dQ blocks: one per (N-row query tile, head, batch): Q, dO and their
//    LSE staged once, delta computed once; K and V tiles of M rows through
//    the ring; per tile S = Q K^T, dP = dO V^T, dS into a shared tile, and
//    dQ += dS K.
// A warp owns 16 rows; C warps share them where the registers need it (hd
// 112 and 128: 2, hd 256: 4), each taking 1/C of the score columns in the
// first products and 1/C of hd's columns in the accumulated one, the
// shared P / dS tiles between. Operands are read as tf32x3.cuh lays out:
// staged rows padded to HD + 4 floats, P and dS tiles to M + 8, no bank
// conflicts. Copies are 16-byte cp.async.cg where every staged row is
// 16-byte aligned, else 4-byte cp.async.ca: any (batch, seq, head)
// strides with a contiguous last dim. Masking (causal, the sliding
// window, keys and rows past a ragged S) sets P to 0; a warp skips a step
// whose every pair is masked. The N (16, 32, 64; hd 256 at most 32) and
// the split of query heads come from kernels/flash_attention.py:fp32_plan,
// M is 32.
//
// Sliding window (`window` > 0, causal only: key k is seen by query q iff
// k <= q and q - k < window, the JAX layers' _mask): a key tile's query
// loop ends at k0 + N - 1 + window - 1, a query tile's key loop starts at
// the tile that holds q0 - window + 1.
//
// C entry: repro_flash_attention_bwd, launched on the caller's stream; it
// allocates nothing (the caller gives the partials' scratch and the
// counters, zero on entry and left zero) and returns the launch error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kStep = 32;  // M: rows of the tiles a block steps over

// Warps sharing 16 rows at head dim HD with N block rows: what the
// registers need (hd 112 and 128: 2, hd 256: 4), and at 16-row blocks,
// which the plan gives only problems too small to fill the card, as many
// as hd's columns allow (4, hd 112: 2), so that a block's few steps run
// on more warps
template <int HD, int N>
__host__ __device__ constexpr int col_split() {
  return N == 16 ? (HD == 112 ? 2 : 4) : (HD <= 64 ? 1 : (HD <= 128 ? 2 : 4));
}

// The largest of MAX, MAX / 2, ..., 1 that divides NT: output tiles a
// warp sums at a time (independent sums keep the tensor cores busy)
template <int NT, int MAX>
__host__ __device__ constexpr int group_of() {
  return NT % MAX == 0 ? MAX : group_of<NT, (MAX > 1 ? MAX / 2 : 1)>();
}

template <int HD, int N>
struct Tile {
  static constexpr int M = kStep;
  static constexpr int C = col_split<HD, N>();
  static constexpr int WARPS = C * N / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = HD + 4;  // a staged row
  static constexpr int LDP = M + 8;  // a row of P or dS
  static constexpr int VEC = (M > N ? M : N);
  // dK/dV blocks stage O beside dO for delta where it fits (hd <= 128);
  // at hd 256 they read it from global memory
  static constexpr bool STAGE_O = HD <= 128;
  // a two-stage ring of M-row tiles: Q, dO (and O), or K, V
  static constexpr int RING = (STAGE_O ? 6 : 4) * M * LD;
  // two N-row tiles, the ring, LSE and delta rows, P and dS tiles
  static constexpr int SMEM = sizeof(float) * (2 * N * LD + RING + 4 * VEC + 2 * N * LDP);
};

// Whether query `qi` sees key `kj` (both < S checked by the caller).
__device__ __forceinline__ bool visible(int qi, int kj, int causal, int window) {
  return !(causal && kj > qi) && !(window && qi - kj >= window);
}

struct Args {
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv, *part;
  int* counters;
  int B, S, H, KV, splits, n_kv_blocks;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh, sdb, sds, sdh;
  int64_t sdqb, sdqs, sdqh, sdkb, sdks, sdkh, sdvb, sdvs, sdvh;
  float scale;
  int causal, window, vec;
};

// delta = rowsum(dO * O) for ROWS staged dO rows (pitch LD) from s0, row
// s of O at ob + (s - o0) * sos (global memory, o0 = 0, or a staged tile,
// o0 = s0): L = NTHREADS / ROWS neighbouring lanes a row, every row at
// once, into dst (0 past S).
template <int HD, int ROWS, int NTHREADS>
__device__ __forceinline__ void row_delta(float* dst, const float* dos, const float* ob,
                                          int64_t sos, int o0, int s0, int S) {
  constexpr int LD = HD + 4;
  constexpr int L = NTHREADS / ROWS;
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "lanes a row");
  const int r = threadIdx.x / L, sub = threadIdx.x % L;
  const int s = s0 + r;
  float d = 0.f;
  if (s < S) {
    const float* orow = ob + static_cast<int64_t>(s - o0) * sos;
#pragma unroll
    for (int c = sub; c < HD; c += L) d = fmaf(orow[c], dos[r * LD + c], d);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (sub == 0) dst[r] = d;
}

template <int HD, int N>
__device__ __forceinline__ void dkdv_block(const Args& a, float* smem, int bx) {
  using T = Tile<HD, N>;
  constexpr int M = T::M, C = T::C, LD = T::LD, LDP = T::LDP, NTHREADS = T::THREADS;
  constexpr int NT1 = M / C / 8;   // score tiles of 8 queries a warp
  constexpr int NT2 = HD / C / 8;  // output tiles of 8 columns a warp
  float* Ks = smem;                 // [N][LD]
  float* Vs = Ks + N * LD;          // [N][LD]
  constexpr int RS = T::RING / 2;    // a ring stage: Q, dO (and O)
  float* Ring = Vs + N * LD;          // [2][RS]
  float* Ls = Ring + T::RING;         // [2][M]
  float* Es = Ls + 2 * M;             // [2][M]
  float* Ps = Ring + T::RING + 4 * T::VEC;  // [N][LDP], P^T
  float* Ss = Ps + N * LDP;                 // [N][LDP], dS^T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / C, cs = warp % C;
  // longest causal key tiles (the first) first
  const int per_tile = a.B * a.KV * a.splits;
  const int kt = bx / per_tile;
  int rem = bx % per_tile;
  const int sp = rem % a.splits;
  rem /= a.splits;
  const int hk = rem % a.KV;
  const int b = rem / a.KV;
  const int S = a.S;
  const int k0 = kt * N;
  const int G = a.H / a.KV, heads = G / a.splits;
  const int h0 = hk * G + sp * heads;

  stage_rows<HD, N, NTHREADS>(Ks, a.k + b * a.skb + hk * a.skh, a.sks, k0, S, a.vec);
  stage_rows<HD, N, NTHREADS>(Vs, a.v + b * a.svb + hk * a.svh, a.svs, k0, S, a.vec);
  cp_commit();

  // the queries that see these keys: from the key tile's own (causal) to
  // the last one the window of its last key reaches (window implies causal)
  const int qt0 = a.causal ? k0 / M : 0;
  const int q_end = a.window ? min(S, k0 + N + a.window - 1) : S;
  const int nq = (q_end + M - 1) / M - qt0;
  const int n_steps = heads * nq;
  auto issue = [&](int i, int st) {
    const int h = h0 + i / nq;
    const int q0 = (qt0 + i % nq) * M;
    float* Qd = Ring + st * RS;
    stage_rows<HD, M, NTHREADS>(Qd, a.q + b * a.sqb + h * a.sqh, a.sqs, q0, S, a.vec);
    stage_rows<HD, M, NTHREADS>(Qd + M * LD, a.dout + b * a.sdb + h * a.sdh, a.sds, q0, S,
                                a.vec);
    if (T::STAGE_O)
      stage_rows<HD, M, NTHREADS>(Qd + 2 * M * LD, a.o + b * a.sob + h * a.soh, a.sos, q0,
                                  S, a.vec);
    stage_vec<NTHREADS>(Ls + st * M, a.lse + (static_cast<int64_t>(b) * a.H + h) * S, q0,
                        M, S);
    cp_commit();
  };
  issue(0, 0);

  float dk[NT2][4], dv[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  const int key_lo = k0 + rg * 16;
  const int keys[2] = {key_lo + g, key_lo + g + 8};
  const float* Kw = Ks + rg * 16 * LD;
  const float* Vw = Vs + rg * 16 * LD;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    if (i + 1 < n_steps) {
      issue(i + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this step (and K, V) landed; the last step's reads done
    const int h = h0 + i / nq;
    const int q0 = (qt0 + i % nq) * M;
    const float* Qt = Ring + st * RS;
    const float* Dt = Qt + M * LD;
    if (T::STAGE_O)
      row_delta<HD, M, NTHREADS>(Es + st * M, Dt, Dt + M * LD, LD, q0, q0, S);
    else
      row_delta<HD, M, NTHREADS>(Es + st * M, Dt, a.o + b * a.sob + h * a.soh, a.sos, 0, q0,
                                 S);
    __syncthreads();  // delta written
    const bool live = key_lo < S && !(a.causal && q0 + M - 1 < key_lo) &&
                      !(a.window && q0 - (key_lo + 15) >= a.window);
    // every pair of the warp's 16 keys and the step's queries is seen
    const bool whole = (!a.causal || q0 >= key_lo + 15) && key_lo + 16 <= S &&
                       q0 + M <= S && (!a.window || q0 + M - 1 - key_lo < a.window);
    if (live) {
      // S^T = K Q^T, dP^T = V dO^T for 16 keys x this warp's M / C queries
      float s[NT1][4], dp[NT1][4];
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      const float* Qc = Qt + cs * (M / C) * LD;
      const float* Dc = Dt + cs * (M / C) * LD;
#pragma unroll
      for (int ks = 0; ks < HD / 8; ++ks) {
        float x[4];
        uint32_t khi[4], klo[4], vhi[4], vlo[4];
        load_a(Kw + ks * 8, LD, g, t, x);
        split(x, khi, klo);
        load_a(Vw + ks * 8, LD, g, t, x);
        split(x, vhi, vlo);
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
          float y[2];
          uint32_t bhi[2], blo[2];
          load_b_nk(Qc + j * 8 * LD + ks * 8, LD, g, t, y);
          split(y, bhi, blo);
          mma3(s[j], khi, klo, bhi, blo);
          load_b_nk(Dc + j * 8 * LD + ks * 8, LD, g, t, y);
          split(y, bhi, blo);
          mma3(dp[j], vhi, vlo, bhi, blo);
        }
      }
      const float* Lst = Ls + st * M;
      const float* Est = Es + st * M;
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int ql = cs * (M / C) + j * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p[2], ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qi = q0 + ql + c;
            const float x = s[j][2 * r + c];
            p[c] = whole || (keys[r] < S && qi < S &&
                             visible(qi, keys[r], a.causal, a.window))
                       ? expf(x * a.scale - Lst[ql + c])
                       : 0.f;
            ds[c] = p[c] * (dp[j][2 * r + c] - Est[ql + c]);
          }
          const int e = (rg * 16 + g + 8 * r) * LDP + ql;
          *reinterpret_cast<float2*>(Ps + e) = make_float2(p[0], p[1]);
          *reinterpret_cast<float2*>(Ss + e) = make_float2(ds[0], ds[1]);
        }
      }
    }
    if (C > 1)
      __syncthreads();  // the row group's P^T, dS^T written
    else
      __syncwarp();
    if (live) {
      // dV += P^T dO, dK += dS^T Q for 16 keys x this warp's HD / C
      // columns; a step's products summed apart and added in fp32 (the
      // tensor cores round their sums toward zero, which would pile up over
      // the G S / M steps)
      const float* Pw = Ps + rg * 16 * LDP;
      const float* Sw = Ss + rg * 16 * LDP;
      uint32_t phi[M / 8][4], plo[M / 8][4], shi[M / 8][4], slo[M / 8][4];
#pragma unroll
      for (int kk = 0; kk < M / 8; ++kk) {
        float x[4];
        load_a_paired(Pw + kk * 8, LDP, g, t, x);
        split(x, phi[kk], plo[kk]);
        load_a_paired(Sw + kk * 8, LDP, g, t, x);
        split(x, shi[kk], slo[kk]);
      }
      constexpr int NG = group_of<NT2, 2>();  // output tiles at a time
#pragma unroll
      for (int n0 = 0; n0 < NT2; n0 += NG) {
        float sv[NG][4], sk[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sv[n][e] = 0.f;
            sk[n][e] = 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < M / 8; ++kk)
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const int col = cs * (HD / C) + (n0 + n) * 8;
            float y[2];
            uint32_t bhi[2], blo[2];
            load_b_kn(Dt + kk * 8 * LD + col, LD, g, t, y);
            split(y, bhi, blo);
            mma3(sv[n], phi[kk], plo[kk], bhi, blo);
            load_b_kn(Qt + kk * 8 * LD + col, LD, g, t, y);
            split(y, bhi, blo);
            mma3(sk[n], shi[kk], slo[kk], bhi, blo);
          }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv[n0 + n][e] += sv[n][e];
            dk[n0 + n][e] += sk[n][e];
          }
      }
    }
    __syncthreads();  // the ring stage and the P^T, dS^T tiles are free
  }

  if (a.splits == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] >= S) continue;
      float* krow = a.dk + b * a.sdkb + static_cast<int64_t>(keys[r]) * a.sdks + hk * a.sdkh;
      float* vrow = a.dv + b * a.sdvb + static_cast<int64_t>(keys[r]) * a.sdvs + hk * a.sdvh;
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        const int col = cs * (HD / C) + n * 8 + 2 * t;
        krow[col] = dk[n][2 * r] * a.scale;
        krow[col + 1] = dk[n][2 * r + 1] * a.scale;
        vrow[col] = dv[n][2 * r];
        vrow[col + 1] = dv[n][2 * r + 1];
      }
    }
    return;
  }
  // partials (splits, B, S, KV, HD) for dK then dV; the last block of the
  // key tile sums them in split order
  const int64_t plane = static_cast<int64_t>(a.splits) * a.B * S * a.KV * HD;
  auto pidx = [&](int s, int key, int col) {
    return ((static_cast<int64_t>(s) * a.B + b) * S + key) * a.KV * HD +
           static_cast<int64_t>(hk) * HD + col;
  };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= S) continue;
#pragma unroll
    for (int n = 0; n < NT2; ++n) {
      const int64_t e = pidx(sp, keys[r], cs * (HD / C) + n * 8 + 2 * t);
      *reinterpret_cast<float2*>(a.part + e) = make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<float2*>(a.part + plane + e) =
          make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  int* counter = a.counters + (static_cast<int64_t>(kt) * a.B + b) * a.KV + hk;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a thread's CH 16-byte chunks of the tile, every chunk's loads of one
  // split in flight together
  constexpr int CH = N * HD / 4 / NTHREADS;
  float4 sk[CH], sv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    sk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    sv[c] = sk[c];
  }
  for (int s = 0; s < a.splits; ++s) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = threadIdx.x + c * NTHREADS;
      const int key = k0 + i / (HD / 4);
      if (key >= S) continue;
      const int64_t e = pidx(s, key, i % (HD / 4) * 4);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(a.part + e));
      const float4 y = __ldcg(reinterpret_cast<const float4*>(a.part + plane + e));
      sk[c] = make_float4(sk[c].x + x.x, sk[c].y + x.y, sk[c].z + x.z, sk[c].w + x.w);
      sv[c] = make_float4(sv[c].x + y.x, sv[c].y + y.y, sv[c].z + y.z, sv[c].w + y.w);
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = threadIdx.x + c * NTHREADS;
    const int key = k0 + i / (HD / 4), col = i % (HD / 4) * 4;
    if (key >= S) continue;
    float* krow = a.dk + b * a.sdkb + static_cast<int64_t>(key) * a.sdks + hk * a.sdkh + col;
    float* vrow = a.dv + b * a.sdvb + static_cast<int64_t>(key) * a.sdvs + hk * a.sdvh + col;
    krow[0] = sk[c].x * a.scale;
    krow[1] = sk[c].y * a.scale;
    krow[2] = sk[c].z * a.scale;
    krow[3] = sk[c].w * a.scale;
    vrow[0] = sv[c].x;
    vrow[1] = sv[c].y;
    vrow[2] = sv[c].z;
    vrow[3] = sv[c].w;
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next call
}

template <int HD, int N>
__device__ __forceinline__ void dq_block(const Args& a, float* smem, int by) {
  using T = Tile<HD, N>;
  constexpr int M = T::M, C = T::C, LD = T::LD, LDP = T::LDP, NTHREADS = T::THREADS;
  constexpr int NT1 = M / C / 8;   // score tiles of 8 keys a warp
  constexpr int NT2 = HD / C / 8;  // output tiles of 8 columns a warp
  float* Qs = smem;                 // [N][LD]
  float* Ds = Qs + N * LD;          // [N][LD], dO
  float* Ring = Ds + N * LD;        // [2][K, V][M][LD]
  float* Ls = Ring + T::RING;       // [N]
  float* Es = Ls + N;               // [N]
  float* Ss = Ring + T::RING + 4 * T::VEC + N * LDP;  // [N][LDP], dS

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / C, cs = warp % C;
  const int S = a.S;
  const int n_qt = (S + N - 1) / N;
  const int qt = n_qt - 1 - by / (a.B * a.H);  // longest causal loop first
  const int h = by % (a.B * a.H) % a.H;
  const int b = by % (a.B * a.H) / a.H;
  const int q0 = qt * N;
  const int hk = h / (a.H / a.KV);
  const float* kb = a.k + b * a.skb + hk * a.skh;
  const float* vb = a.v + b * a.svb + hk * a.svh;

  stage_rows<HD, N, NTHREADS>(Qs, a.q + b * a.sqb + h * a.sqh, a.sqs, q0, S, a.vec);
  stage_rows<HD, N, NTHREADS>(Ds, a.dout + b * a.sdb + h * a.sdh, a.sds, q0, S, a.vec);
  stage_vec<NTHREADS>(Ls, a.lse + (static_cast<int64_t>(b) * a.H + h) * S, q0, N, S);
  cp_commit();

  const int k_end = a.causal ? min(S, q0 + N) : S;
  const int n_k = (k_end + M - 1) / M;
  // the first tile of the first row's window (window implies causal)
  const int kt0 = a.window ? max(0, q0 - a.window + 1) / M : 0;
  auto issue = [&](int kt, int st) {
    float* Kd = Ring + st * 2 * M * LD;
    stage_rows<HD, M, NTHREADS>(Kd, kb, a.sks, kt * M, S, a.vec);
    stage_rows<HD, M, NTHREADS>(Kd + M * LD, vb, a.svs, kt * M, S, a.vec);
    cp_commit();
  };
  issue(kt0, 0);
  cp_wait<1>();
  __syncthreads();  // Q, dO, LSE landed
  row_delta<HD, N, NTHREADS>(Es, Ds, a.o + b * a.sob + h * a.soh, a.sos, 0, q0, S);
  // (the loop's first barrier publishes delta)

  float dq[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const int row_lo = q0 + rg * 16;
  const int rows[2] = {row_lo + g, row_lo + g + 8};
  const float* Qw = Qs + rg * 16 * LD;
  const float* Dw = Ds + rg * 16 * LD;

  for (int kt = kt0; kt < n_k; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < n_k) {
      issue(kt + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this tile landed; the last tile's reads done
    const int k0 = kt * M;
    const float* Kt = Ring + st * 2 * M * LD;
    const float* Vt = Kt + M * LD;
    const bool live = row_lo < S && !(a.causal && k0 > row_lo + 15) &&
                      !(a.window && row_lo - (k0 + M - 1) >= a.window);
    // every pair of the warp's 16 rows and the tile's keys is seen
    const bool whole = (!a.causal || k0 + M - 1 <= row_lo) && k0 + M <= S &&
                       row_lo + 16 <= S && (!a.window || row_lo + 15 - k0 < a.window);
    if (live) {
      // S = Q K^T, dP = dO V^T for 16 rows x this warp's M / C keys
      float s[NT1][4], dp[NT1][4];
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      const float* Kc = Kt + cs * (M / C) * LD;
      const float* Vc = Vt + cs * (M / C) * LD;
#pragma unroll
      for (int ks = 0; ks < HD / 8; ++ks) {
        float x[4];
        uint32_t qhi[4], qlo[4], dhi[4], dlo[4];
        load_a(Qw + ks * 8, LD, g, t, x);
        split(x, qhi, qlo);
        load_a(Dw + ks * 8, LD, g, t, x);
        split(x, dhi, dlo);
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
          float y[2];
          uint32_t bhi[2], blo[2];
          load_b_nk(Kc + j * 8 * LD + ks * 8, LD, g, t, y);
          split(y, bhi, blo);
          mma3(s[j], qhi, qlo, bhi, blo);
          load_b_nk(Vc + j * 8 * LD + ks * 8, LD, g, t, y);
          split(y, bhi, blo);
          mma3(dp[j], dhi, dlo, bhi, blo);
        }
      }
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int kl = cs * (M / C) + j * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rl = rg * 16 + g + 8 * r;
          float ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kj = k0 + kl + c;
            const float p = whole || (kj < S && rows[r] < S &&
                                      visible(rows[r], kj, a.causal, a.window))
                                ? expf(s[j][2 * r + c] * a.scale - Ls[rl])
                                : 0.f;
            ds[c] = p * (dp[j][2 * r + c] - Es[rl]);
          }
          *reinterpret_cast<float2*>(Ss + rl * LDP + kl) = make_float2(ds[0], ds[1]);
        }
      }
    }
    if (C > 1)
      __syncthreads();  // the row group's dS written
    else
      __syncwarp();
    if (live) {
      // dQ += dS K for 16 rows x this warp's HD / C columns, a step's
      // products summed apart and added in fp32 (as dK and dV)
      const float* Sw = Ss + rg * 16 * LDP;
      uint32_t shi[M / 8][4], slo[M / 8][4];
#pragma unroll
      for (int kk = 0; kk < M / 8; ++kk) {
        float x[4];
        load_a_paired(Sw + kk * 8, LDP, g, t, x);
        split(x, shi[kk], slo[kk]);
      }
      constexpr int NG = group_of<NT2, 4>();  // output tiles at a time
#pragma unroll
      for (int n0 = 0; n0 < NT2; n0 += NG) {
        float sq[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sq[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < M / 8; ++kk)
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            float y[2];
            uint32_t bhi[2], blo[2];
            load_b_kn(Kt + kk * 8 * LD + cs * (HD / C) + (n0 + n) * 8, LD, g, t, y);
            split(y, bhi, blo);
            mma3(sq[n], shi[kk], slo[kk], bhi, blo);
          }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n0 + n][e] += sq[n][e];
      }
    }
    __syncthreads();  // the ring stage and the dS tile are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    float* qrow = a.dq + b * a.sdqb + static_cast<int64_t>(rows[r]) * a.sdqs + h * a.sdqh;
#pragma unroll
    for (int n = 0; n < NT2; ++n) {
      const int col = cs * (HD / C) + n * 8 + 2 * t;
      qrow[col] = dq[n][2 * r] * a.scale;
      qrow[col + 1] = dq[n][2 * r + 1] * a.scale;
    }
  }
}

template <int HD, int N>
__global__ void __launch_bounds__(Tile<HD, N>::THREADS) flash_bwd_fp32(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (static_cast<int>(blockIdx.x) < a.n_kv_blocks)
    dkdv_block<HD, N>(a, smem, blockIdx.x);
  else
    dq_block<HD, N>(a, smem, blockIdx.x - a.n_kv_blocks);
}

// The head dims the kernel is built for, and the block rows (N) the plan
// may pick at each (hd 256: at most 32, for shared memory).
#define REPRO_FA_HEAD_DIMS(X) X(32) X(64) X(112) X(128) X(256)
#define REPRO_FA_ROWS(X, HD_) X(HD_, 16) X(HD_, 32) REPRO_FA_ROWS64_##HD_(X, HD_)
#define REPRO_FA_ROWS64_32(X, HD_) X(HD_, 64)
#define REPRO_FA_ROWS64_64(X, HD_) X(HD_, 64)
#define REPRO_FA_ROWS64_112(X, HD_) X(HD_, 64)
#define REPRO_FA_ROWS64_128(X, HD_) X(HD_, 64)
#define REPRO_FA_ROWS64_256(X, HD_)

template <int HD, int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using T = Tile<HD, N>;
  auto kern = flash_bwd_fp32<HD, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (a.S + N - 1) / N;
  const int blocks = a.n_kv_blocks + tiles * a.H * a.B;
  kern<<<blocks, T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// float32 only; strides in elements, every last dim contiguous. lse: the
// forward's contiguous fp32 (B, H, S). dq, dk, dv: written through their
// strides. `window`: 0, or a sliding window under `causal`. `rows`,
// `step`, `split`: the plan's block rows, step rows (32) and warps sharing
// 16 rows (the head dim's); `splits`: blocks a KV head's query heads are
// split over (a divisor of H / KV). Where splits > 1, `part` is fp32
// scratch of 2 * splits * B * S * KV * hd and `counters` B * KV *
// ceil(S / rows) ints, zero on entry and left zero. `vec`: 1 where every
// row of q, k, v, out and dy is 16-byte aligned.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* part, int* counters, int B,
    int S, int H, int KV, int hd, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
    int64_t sks, int64_t skh, int64_t svb, int64_t svs, int64_t svh, int64_t sob,
    int64_t sos, int64_t soh, int64_t sdb, int64_t sds, int64_t sdh, int64_t sdqb,
    int64_t sdqs, int64_t sdqh, int64_t sdkb, int64_t sdks, int64_t sdkh, int64_t sdvb,
    int64_t sdvs, int64_t sdvh, float scale, int causal, int window, int rows, int step,
    int split, int splits, int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      (window > 0 && !causal) || step != kStep || splits <= 0 || (H / KV) % splits != 0 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(o),
         static_cast<const float*>(dout), lse, static_cast<float*>(dq),
         static_cast<float*>(dk), static_cast<float*>(dv), part, counters,
         B, S, H, KV, splits, ((S + rows - 1) / rows) * B * KV * splits,
         sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh, sdb, sds, sdh,
         sdqb, sdqs, sdqh, sdkb, sdks, sdkh, sdvb, sdvs, sdvh, scale, causal, window, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(HD_, N_) \
  if (hd == HD_ && rows == N_ && split == col_split<HD_, N_>())                               \
    return (int)launch<HD_, N_>(a, st);
#define REPRO_FA_HD(HD_) REPRO_FA_ROWS(REPRO_FA_CASE, HD_)
  REPRO_FA_HEAD_DIMS(REPRO_FA_HD)
#undef REPRO_FA_HD
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory a block takes at head dim `hd` with
// `rows` block rows (0 for an instance the kernel is not built for).
extern "C" int repro_flash_attention_bwd_smem_bytes(int hd, int rows) {
#define REPRO_FA_SMEM(HD_, N_) \
  if (hd == HD_ && rows == N_) return Tile<HD_, N_>::SMEM;
#define REPRO_FA_HD(HD_) REPRO_FA_ROWS(REPRO_FA_SMEM, HD_)
  REPRO_FA_HEAD_DIMS(REPRO_FA_HD)
#undef REPRO_FA_HD
#undef REPRO_FA_SMEM
  return 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
