// AdamW's update for Hopper (sm_90a): the global norm of the gradient, and
// the update of every parameter and both moments in one pass a leaf.
//
// Replaces no TPU kernel: the JAX package's update
// (src/repro/optim/adamw.py:36-66) is one XLA fusion. The port's plain
// version (kernels/adamw.py:update_plain) runs it as ~20 eager fp32 passes
// a leaf; these kernels move only the bytes the update needs.
//
// What bounds it on an H100: bytes, a few operations an element against
// 28 bytes a parameter (3.35 TB/s on the SXM part). The norm reads the
// gradient once (4 B a parameter for an fp32 gradient); the update reads
// p, g, m and v and writes p, m and v once (10 B read with an fp32
// gradient, 10 B written, for a bf16 parameter). Every array is read in
// 16-byte vectors where the four bases allow it (a scalar loop otherwise,
// and for a ragged end); the grids are sized to fill the card and walk the
// leaf grid-stride, with 64-bit indices (command-r's embedding has 2.1 B
// elements).
//
// - adamw_sumsq: one launch a leaf; block b writes the fp32 sum of its
//   threads' g^2 into partial[b] (each thread sums its own elements in a
//   fixed order, the block sums its threads by warp shuffles in a fixed
//   order). adamw_sumsq_finish, one block, sums every leaf's partials in
//   fp64 in a fixed order and writes gnorm = sqrt(sum) and
//   scale = min(clip * (1 / (gnorm + 1e-9)), 1), as the plain version
//   forms them. No atomics: the same gradient gives the same bits.
// - adamw_update: one launch a leaf, the plain version's arithmetic on each
//   element in fp32 registers, in its order, every step rounded on its own
//   (__fmul_rn & co., so nvcc contracts nothing into an FMA): the kernel
//   gives the plain version's bits. The device scalars (scale, lr and the
//   bias corrections) are read from device memory, where the schedule's
//   0-d tensors hold them; nothing is read on the host.
//
// C entries, launched on the caller's stream; each allocates nothing and
// returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The update's constants: the plain version's Python expressions cast to
// float (kernels/adamw.py:UpdateArgs, the same fields in the same order).
struct AdamwArgs {
  float b1, omb1, b2, omb2, eps, wd;  // omb1 = float(1 - b1), omb2 = float(1 - b2)
  int decay;                          // 0: no weight decay term
};

namespace {

constexpr int kThreads = 256;        // a block's, both kernels
constexpr int kSumUnroll = 4;        // 16-byte loads in flight a thread in the norm
constexpr int kFinishThreads = 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as .to(bfloat16)
}

// E elements of T, 16-byte aligned: one or two 16-byte loads or stores.
template <typename T, int E>
struct alignas(16) Pack {
  T x[E];
};

// The block's sum of each thread's v, in a fixed order; thread 0 has it.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  }
  return v;
}

// partial[blockIdx.x] = the block's sum of g^2 over its elements of g.
// Eight blocks an SM (32 registers a thread): a full SM's threads, each
// with kSumUnroll loads in flight.
template <typename G>
__global__ void __launch_bounds__(kThreads, 8)
    adamw_sumsq(const G* __restrict__ g, int64_t n, float* __restrict__ partial) {
  constexpr int E = 16 / sizeof(G);
  using V = Pack<G, E>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t packs = reinterpret_cast<uintptr_t>(g) % 16 ? 0 : n / E;
  const V* gv = reinterpret_cast<const V*>(g);
  float acc[kSumUnroll] = {};
  int64_t i = t;
  for (; i + (kSumUnroll - 1) * stride < packs; i += kSumUnroll * stride) {
    V x[kSumUnroll];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) x[u] = gv[i + u * stride];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u)
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float f = to_float(x[u].x[j]);
        acc[u] = __fmaf_rn(f, f, acc[u]);
      }
  }
  for (; i < packs; i += stride) {
    const V x = gv[i];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float f = to_float(x.x[j]);
      acc[0] = __fmaf_rn(f, f, acc[0]);
    }
  }
  for (int64_t k = packs * E + t; k < n; k += stride) {  // the ragged end, or all of it
    const float f = to_float(g[k]);
    acc[0] = __fmaf_rn(f, f, acc[0]);
  }
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < kSumUnroll; ++u) s += acc[u];
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// out[0] = gnorm, out[1] = scale, from every leaf's partials.
__global__ void __launch_bounds__(kFinishThreads)
    adamw_sumsq_finish(const float* __restrict__ partial, int n, float clip,
                       float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    const float gnorm = static_cast<float>(sqrt(acc));
    const float s = __fmul_rn(__frcp_rn(__fadd_rn(gnorm, 1e-9f)), clip);
    out[0] = gnorm;
    out[1] = s > 1.f ? 1.f : s;  // NaN stays NaN, as torch.clamp
  }
}

// One element of the update, in the plain version's order.
__device__ __forceinline__ void step(float& p, float g, float& m, float& v, float scale,
                                     bool scaled, float lr, float bc1, float bc2,
                                     const AdamwArgs& a) {
  if (scaled) g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(g, a.omb1));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(g, g), a.omb2));
  float delta = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
  if (a.decay) delta = __fadd_rn(delta, __fmul_rn(p, a.wd));
  p = __fsub_rn(p, __fmul_rn(delta, lr));
}

// p, m, v updated in place from g; E elements a thread a step (8 where a
// bf16 array is read, else 4), every array in 16-byte vectors where all
// four bases are 16-byte aligned. Four blocks an SM (64 registers a
// thread), each thread with 7 16-byte loads in flight for bf16 p and fp32 g.
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads, 4)
    adamw_update(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
                 float* __restrict__ v, int64_t n, const float* __restrict__ scale_p,
                 const float* __restrict__ lr_p, const float* __restrict__ bc1_p,
                 const float* __restrict__ bc2_p, AdamwArgs a) {
  constexpr int E = (sizeof(P) == 2 || sizeof(G) == 2) ? 8 : 4;
  const bool scaled = scale_p != nullptr;
  const float scale = scaled ? *scale_p : 1.f;
  const float lr = *lr_p, bc1 = *bc1_p, bc2 = *bc2_p;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) %
                        16) == 0;
  const int64_t packs = aligned ? n / E : 0;
  auto* pv = reinterpret_cast<Pack<P, E>*>(p);
  auto* gv = reinterpret_cast<const Pack<G, E>*>(g);
  auto* mv = reinterpret_cast<Pack<float, E>*>(m);
  auto* vv = reinterpret_cast<Pack<float, E>*>(v);
  for (int64_t i = t; i < packs; i += stride) {
    Pack<P, E> pp = pv[i];
    const Pack<G, E> gp = gv[i];
    Pack<float, E> mp = mv[i], vp = vv[i];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      float pf = to_float(pp.x[j]);
      step(pf, to_float(gp.x[j]), mp.x[j], vp.x[j], scale, scaled, lr, bc1, bc2, a);
      pp.x[j] = from_float<P>(pf);
    }
    mv[i] = mp;
    vv[i] = vp;
    pv[i] = pp;
  }
  for (int64_t k = packs * E + t; k < n; k += stride) {  // the ragged end, or all of it
    float pf = to_float(p[k]), mf = m[k], vf = v[k];
    step(pf, to_float(g[k]), mf, vf, scale, scaled, lr, bc1, bc2, a);
    m[k] = mf;
    v[k] = vf;
    p[k] = from_float<P>(pf);
  }
}

template <typename P, typename G>
cudaError_t launch_update(void* p, const void* g, float* m, float* v, int64_t n,
                          const float* scale, const float* lr, const float* bc1,
                          const float* bc2, const AdamwArgs& a, int grid, cudaStream_t st) {
  adamw_update<P, G><<<grid, kThreads, 0, st>>>(static_cast<P*>(p), static_cast<const G*>(g), m,
                                                v, n, scale, lr, bc1, bc2, a);
  return cudaGetLastError();
}

}  // namespace

// The sum of squares of one leaf g (n elements; bf16 if g_bf16, else fp32)
// into partial[0, grid).
extern "C" int repro_adamw_sumsq(const void* g, int64_t n, int g_bf16, float* partial, int grid,
                                 void* stream) {
  if (n <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    adamw_sumsq<__nv_bfloat16>
        <<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(g), n, partial);
  else
    adamw_sumsq<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(g), n, partial);
  return static_cast<int>(cudaGetLastError());
}

// gnorm and scale (out[0], out[1]) from the n partials of every leaf.
extern "C" int repro_adamw_sumsq_finish(const float* partial, int n, float clip, float* out,
                                        void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  adamw_sumsq_finish<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(partial, n,
                                                                                  clip, out);
  return static_cast<int>(cudaGetLastError());
}

// One leaf's update, in place. pair: 0 bf16 p / fp32 g, 1 bf16 / bf16,
// 2 fp32 / fp32. scale is null where the gradient is not clipped.
extern "C" int repro_adamw_update(void* p, const void* g, float* m, float* v, int64_t n,
                                  int pair, const float* scale, const float* lr, const float* bc1,
                                  const float* bc2, const AdamwArgs* a, int grid, void* stream) {
  if (n <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pair) {
    case 0:
      return static_cast<int>(launch_update<__nv_bfloat16, float>(p, g, m, v, n, scale, lr, bc1,
                                                                  bc2, *a, grid, st));
    case 1:
      return static_cast<int>(launch_update<__nv_bfloat16, __nv_bfloat16>(
          p, g, m, v, n, scale, lr, bc1, bc2, *a, grid, st));
    case 2:
      return static_cast<int>(
          launch_update<float, float>(p, g, m, v, n, scale, lr, bc1, bc2, *a, grid, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
