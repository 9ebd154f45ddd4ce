// RMSNorm for Hopper (sm_90a), float32 and bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py
// (_rmsnorm_kernel / rmsnorm): y = x * rsqrt(mean(x^2, -1) + eps) * (1 + scale),
// the sum of squares and every product in fp32, one cast to x's dtype.
//
// What bounds it on an H100: a few operations per element against one read
// of x and one write of y, so bytes (3.35 TB/s on the SXM part). At the
// decode call (4 rows of 4096 bf16, 64 KB in all) no byte bound describes
// it: the time is the launch, one DRAM round trip and one block reduction.
// Two launch plans, chosen by kernels/rmsnorm.py:plan():
//
// - rows (while one block per row fits the card in one wave, as the decode
//   call does): one block per row; each thread holds at most two 16-byte
//   chunks of the row. Every load of the row (ld.global.nc, no L1
//   allocation) and of the scale (through L1, which an SM's blocks share)
//   is issued before the first use, the sum of squares is reduced by warp
//   shuffles and one cross-warp step through shared memory, and the row
//   goes back as 16-byte stores. No ring and no barrier set-up, so the
//   kernel is one DRAM round trip and one reduction.
// - ring (many rows): a persistent grid; block b walks rows b, b + grid, ...
//   Rows arrive through a ring of 2-4 shared-memory stages. One thread fills
//   each stage with one 1-D TMA bulk copy of the whole row, which completes
//   on the stage's mbarrier (expect_tx of the row's bytes), so the next
//   rows' copies are in flight while the current row is reduced and stored.
//   A bulk copy needs no tensor map, so the host builds none. The scale is
//   loaded once per block into registers for the thread's fixed columns
//   (1 + scale is formed in fp32 as each row is stored). Stores are 16-byte
//   vectors from registers.
//
// Rows and scale stay packed in registers (unpacked once for the sum and
// again for the stores), which keeps the rows plan within 32 registers a
// thread.
//
// Both plans read 16-byte chunks: the x base, its row stride and
// D * sizeof(T) must be multiples of 16 bytes, and the scale's base
// 16-byte aligned; the Python wrapper checks this and raises. Row offsets
// are 64-bit.
//
// Backward (training): the gradient of the same function, which the Pallas
// kernel does not have (the JAX package differentiates XLA ops), computed
// as kernels/rmsnorm.py:rmsnorm_backward, its plain version, does:
//   r = rsqrt(mean(x^2) + eps), g = dy * (1 + scale),
//   dx = r * (g - x * r^2 * mean(g * x)),  dscale = sum over rows of dy * x * r.
// Bounded by bytes too (x and dy read, dx written once). One pass a row:
// a block holds `slots` rows at a time, each over the threads a forward row
// would take, every load of both rows issued before the two sums (sum x^2
// and sum g x, reduced together), so an SM keeps ~16 rows in flight. Each
// thread adds dy * x * r for its fixed columns into fp32 registers across
// all its rows; at the end the block's slots are summed through shared
// memory into one fp32 row of partials a block, and a second launch sums
// the (grid, D) partials by column, in a fixed order (deterministic, no
// atomics), into dscale in scale's dtype. Plan: kernels/rmsnorm.py:
// backward_plan.
//
// C entries, launched on the caller's stream; each allocates nothing and
// returns cudaGetLastError() of its launches: repro_rmsnorm_fwd,
// repro_rmsnorm_bwd and repro_rmsnorm_empty (an empty kernel: the floor
// under any launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

// What a launch takes besides the pointers and the stream; the Python
// wrapper builds one per plan and shape and passes it by reference
// (kernels/rmsnorm.py:LaunchArgs: the same fields in the same order).
struct RmsnormArgs {
  int rows, D;  // rows of D elements; out is contiguous
  int64_t sx;   // x's row stride, in elements
  float eps;
  int bf16, ring;  // the dtype, and the plan (1: ring, 0: rows)
  int grid, threads, stages, smem;  // the plan's; smem in bytes
};

// The backward's launch (kernels/rmsnorm.py:BackwardArgs, the same fields
// in the same order).
struct RmsnormBwdArgs {
  int rows, D;        // rows of D elements; dx is contiguous
  int64_t sx, sdy;    // x's and dy's row strides, in elements
  float eps;
  int bf16;
  int grid, threads, slots, smem;  // the plan's; smem in bytes
};

namespace {

constexpr int kVec = 2;  // 16-byte chunks of a row per thread, at most
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxDevices = 64;

// 16 bytes of T as N fp32 values, and back (bf16: round to nearest even).
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[N]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[N]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(sm90::pack_bf16(f[0], f[1]), sm90::pack_bf16(f[2], f[3]),
                      sm90::pack_bf16(f[4], f[5]), sm90::pack_bf16(f[6], f[7]));
  }
};

// 16 bytes of x, read once: through the non-coherent path, not kept in L1.
__device__ __forceinline__ uint4 ld_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Every lane gets the same sum (a butterfly adds the same pairs in every lane).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// The block's sum of each thread's `v`: warp shuffles, the warps' sums
// through `red` (one float per warp), one __syncthreads, then every warp
// sums `red` the same way, so every thread gets the same value.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f);
}

// The sum of squares of 16 bytes of T, in fp32.
template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& v) {
  float f[Chunk<T>::N];
  Chunk<T>::unpack(v, f);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < Chunk<T>::N; ++j) s += f[j] * f[j];
  return s;
}

// y = x * r * (1 + scale), in that order and in fp32, as 16 bytes of T.
template <typename T>
__device__ __forceinline__ uint4 normalise(const uint4& xv, float r, const uint4& sv) {
  float f[Chunk<T>::N], w[Chunk<T>::N];
  Chunk<T>::unpack(xv, f);
  Chunk<T>::unpack(sv, w);
#pragma unroll
  for (int j = 0; j < Chunk<T>::N; ++j) f[j] = f[j] * r * (1.f + w[j]);
  return Chunk<T>::pack(f);
}

// Plan "rows": block b normalises row b. Thread t holds chunks t and
// t + blockDim.x of the row, packed, and unpacks them again to store. At
// most 32 registers a thread (two blocks of 1024 threads an SM), so blocks
// of any size fill an SM's 2048 threads and a call of up to
// 2048 / blockDim.x rows an SM runs in one wave. Every block reads the
// whole scale, so it is read through L1, which the SM's blocks share.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                 int D, int64_t sx, int64_t so, float eps) {
  using C = Chunk<T>;
  __shared__ float red[kMaxWarps];
  const int chunks = D / C::N;
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * sx);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4 xv[kVec], sv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {  // every load in flight before any use
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      xv[i] = ld_once(xr + c);
      sv[i] = __ldg(sr + c);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (static_cast<int>(threadIdx.x + i * blockDim.x) < chunks) ss += sum_squares<T>(xv[i]);
  const float r = rsqrtf(block_sum(ss, red) / D + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + row * so);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) orow[c] = normalise<T>(xv[i], r, sv[i]);
  }
}

// Plan "ring": block b normalises rows b, b + gridDim.x, ... (the host never
// launches a block with no row). Dynamic shared memory: `stages` rows, then
// the warps' sums for two rows (float[2][kMaxWarps]), then one mbarrier a
// stage. Local row i lives in stage i % stages and is that stage's
// (i / stages)-th fill, so its barrier phase has parity (i / stages) & 1.
// At most 64 registers a thread: plan() puts 1024 threads of it on an SM.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rmsnorm_ring(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                 int rows, int D, int64_t sx, int64_t so, float eps, int stages) {
  using C = Chunk<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int chunks = D / C::N;
  const uint32_t row_bytes = static_cast<uint32_t>(D) * sizeof(T);
  float* red = reinterpret_cast<float*>(smem + stages * row_bytes);
  const uint32_t ring = sm90::smem_u32(smem);
  const uint32_t bars = sm90::smem_u32(red + 2 * kMaxWarps);
  const int grid = gridDim.x;
  const int n = (rows - 1 - static_cast<int>(blockIdx.x)) / grid + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  auto fill = [&](int i) {  // local row i into its stage; one thread
    const int s = i % stages;
    const int64_t row = blockIdx.x + static_cast<int64_t>(i) * grid;
    sm90::mbar_expect_tx(bars + 8 * s, row_bytes);
    sm90::bulk_load(ring + s * row_bytes, x + row * sx, row_bytes, bars + 8 * s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) sm90::mbar_init(bars + 8 * s, 1);
    sm90::fence_barrier_init();
    for (int i = 0; i < stages && i < n; ++i) fill(i);
  }

  uint4 sv[kVec];  // this thread's columns of the scale, kept for every row
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < chunks) sv[k] = __ldg(sr + c);
  }
  __syncthreads();  // the barriers are initialised

  const uint4* stage0 = reinterpret_cast<const uint4*>(smem);
  const int stage_chunks = row_bytes / 16;
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    sm90::mbar_wait(bars + 8 * s, (i / stages) & 1);
    uint4 xv[kVec];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < chunks) {
        xv[k] = stage0[s * stage_chunks + c];
        ss += sum_squares<T>(xv[k]);
      }
    }
    // Two buffers of warp sums: a warp writes row i + 1's while a slower
    // one may still read row i's; row i + 2's waits behind row i + 1's
    // __syncthreads, which every thread reaches after reading row i's.
    float* red_i = red + (i & 1) * kMaxWarps;
    ss = warp_sum(ss);
    if (lane == 0) red_i[warp] = ss;
    __syncthreads();  // stage s is read by every thread; the warps' sums are in
    if (threadIdx.x == 0 && i + stages < n) {
      sm90::fence_proxy_async();
      fill(i + stages);
    }
    const float r = rsqrtf(
        warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red_i[lane] : 0.f) / D + eps);
    const int64_t row = blockIdx.x + static_cast<int64_t>(i) * grid;
    uint4* orow = reinterpret_cast<uint4*>(out + row * so);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < chunks) orow[c] = normalise<T>(xv[k], r, sv[k]);
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Backward, one pass a row. The block's `slots` rows at a time, slot s on
// threads [s * tr, (s + 1) * tr) (tr a multiple of 32: no warp spans two
// rows), each thread on chunks t and t + tr of its row, as the forward.
// Block b takes rows b * slots + s, then every gridDim.x * slots rows; all
// its threads run the same number of iterations (one __syncthreads each).
// Dynamic shared memory: the warps' two sums for two rows
// (float[2][kMaxWarps][2]), then, when slots > 1, float[slots][D] for the
// block's dscale partials. At most 64 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rmsnorm_bwd(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                int rows, int D, int64_t sx, int64_t sdy, float eps, int slots) {
  using C = Chunk<T>;
  extern __shared__ __align__(16) float bsm[];
  const int chunks = D / C::N;
  const int tr = blockDim.x / slots;
  const int slot = threadIdx.x / tr;
  const int ts = threadIdx.x % tr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot_warps = tr >> 5;

  uint4 sv[kVec];
  float acc[kVec][C::N];
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = ts + k * tr;
    if (c < chunks) sv[k] = __ldg(sr + c);
#pragma unroll
    for (int e = 0; e < C::N; ++e) acc[k][e] = 0.f;
  }

  const int first = blockIdx.x * slots;
  const int step = gridDim.x * slots;
  const int n_iter = (rows - first + step - 1) / step;  // the host gives every block a row
  for (int it = 0; it < n_iter; ++it) {
    const int64_t row = first + static_cast<int64_t>(it) * step + slot;
    const bool valid = row < rows;
    uint4 xv[kVec], dv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {  // every load in flight before any use
      const int c = ts + k * tr;
      if (valid && c < chunks) {
        xv[k] = ld_once(reinterpret_cast<const uint4*>(x + row * sx) + c);
        dv[k] = ld_once(reinterpret_cast<const uint4*>(dy + row * sdy) + c);
      }
    }
    float sxx = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int c = ts + k * tr;
      if (valid && c < chunks) {
        float xf[C::N], df[C::N], wf[C::N];
        C::unpack(xv[k], xf);
        C::unpack(dv[k], df);
        C::unpack(sv[k], wf);
#pragma unroll
        for (int e = 0; e < C::N; ++e) {
          sxx += xf[e] * xf[e];
          sgx += df[e] * (1.f + wf[e]) * xf[e];
        }
      }
    }
    // Two buffers of warp sums, as the ring forward's: a warp writes row
    // it + 1's while a slower one may still read row it's.
    float* red = bsm + (it & 1) * 2 * kMaxWarps;
    sxx = warp_sum(sxx);
    sgx = warp_sum(sgx);
    if (lane == 0) {
      red[2 * warp] = sxx;
      red[2 * warp + 1] = sgx;
    }
    __syncthreads();
    const int w0 = slot * slot_warps;
    const float a = warp_sum(lane < slot_warps ? red[2 * (w0 + lane)] : 0.f);
    const float g = warp_sum(lane < slot_warps ? red[2 * (w0 + lane) + 1] : 0.f);
    const float r = rsqrtf(a / D + eps);
    const float cr = r * r * g / D;  // r^2 mean(g x)
    if (valid) {
      uint4* drow = reinterpret_cast<uint4*>(dx + row * D);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int c = ts + k * tr;
        if (c < chunks) {
          float xf[C::N], df[C::N], wf[C::N], out[C::N];
          C::unpack(xv[k], xf);
          C::unpack(dv[k], df);
          C::unpack(sv[k], wf);
#pragma unroll
          for (int e = 0; e < C::N; ++e) {
            out[e] = r * (df[e] * (1.f + wf[e]) - xf[e] * cr);
            acc[k][e] += df[e] * xf[e] * r;
          }
          drow[c] = C::pack(out);
        }
      }
    }
  }

  // the block's partial row of dscale: its slots summed in a fixed order
  float* out = partial + static_cast<int64_t>(blockIdx.x) * D;
  float* ps = bsm + 4 * kMaxWarps;
  float* dst = slots > 1 ? ps + slot * D : out;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = ts + k * tr;
    if (c < chunks) {
#pragma unroll
      for (int e = 0; e < C::N; ++e) dst[c * C::N + e] = acc[k][e];
    }
  }
  if (slots > 1) {
    __syncthreads();
    for (int col = threadIdx.x; col < D; col += blockDim.x) {
      float v = 0.f;
      for (int sl = 0; sl < slots; ++sl) v += ps[sl * D + col];
      out[col] = v;
    }
  }
}

// dscale[col] = sum over the P partial rows, in a fixed order: 32 columns a
// block, 32 rows of threads each summing every 32nd partial, then one row of
// threads summing theirs.
template <typename T>
__global__ void rmsnorm_bwd_colsum(const float* __restrict__ partial, T* __restrict__ dscale,
                                   int P, int D) {
  __shared__ float part[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (col < D)
    for (int p = threadIdx.y; p < P; p += 32) v += partial[static_cast<int64_t>(p) * D + col];
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < D) {
    float sum = 0.f;
#pragma unroll 8
    for (int y = 0; y < 32; ++y) sum += part[y][threadIdx.x];
    dscale[col] = from_float<T>(sum);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
                       float* partial, void* dscale, const RmsnormBwdArgs& a,
                       cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kern = rmsnorm_bwd<T>;
  if (a.smem > 48 * 1024 && a.smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = a.smem;
  }
  kern<<<a.grid, a.threads, a.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, a.rows, a.D, a.sx, a.sdy, a.eps, a.slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_colsum<T><<<(a.D + 31) / 32, dim3(32, 32), 0, stream>>>(
      partial, static_cast<T*>(dscale), a.grid, a.D);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, const RmsnormArgs& a,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  T* ot = static_cast<T*>(out);
  if (!a.ring) {
    rmsnorm_rows<T><<<a.grid, a.threads, 0, stream>>>(xt, st, ot, a.D, a.sx, a.D, a.eps);
    return cudaGetLastError();
  }
  // The dynamic shared memory allowed so far, per device: the attribute is
  // set only when a larger ring is asked for.
  static int allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kern = rmsnorm_ring<T>;
  if (a.smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = a.smem;
  }
  kern<<<a.grid, a.threads, a.smem, stream>>>(xt, st, ot, a.rows, a.D, a.sx, a.D, a.eps,
                                              a.stages);
  return cudaGetLastError();
}

}  // namespace

// Launches one plan on `stream`. Checks only what would make the launch
// read or write out of bounds; the Python wrapper checks the rest.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* out,
                                 const RmsnormArgs* a, void* stream) {
  const int64_t row_bytes = static_cast<int64_t>(a->D) * (a->bf16 ? 2 : 4);
  if (a->rows <= 0 || a->D <= 0 || row_bytes % 16 || a->threads <= 0 || a->threads % 32 ||
      a->threads > kMaxThreads || row_bytes / 16 > static_cast<int64_t>(kVec) * a->threads ||
      a->grid <= 0 || a->grid > a->rows || (!a->ring && a->grid != a->rows) ||
      (a->ring && (a->stages <= 0 || a->smem < a->stages * row_bytes + 2 * kMaxWarps * 4 +
                                                   8 * a->stages)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->bf16)
    return static_cast<int>(launch<__nv_bfloat16>(x, scale, out, *a, st));
  return static_cast<int>(launch<float>(x, scale, out, *a, st));
}

// The backward: dx (contiguous, rows x D), dscale (D, scale's dtype) and
// the scratch `partial` (fp32, grid x D). Checks only what would make the
// launch read or write out of bounds; the Python wrapper checks the rest.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                                 float* partial, void* dscale, const RmsnormBwdArgs* a,
                                 void* stream) {
  const int64_t row_bytes = static_cast<int64_t>(a->D) * (a->bf16 ? 2 : 4);
  const int tr = a->slots > 0 ? a->threads / a->slots : 0;
  if (a->rows <= 0 || a->D <= 0 || row_bytes % 16 || a->slots <= 0 ||
      a->threads % a->slots || tr <= 0 || tr % 32 || a->threads > kMaxThreads ||
      row_bytes / 16 > static_cast<int64_t>(kVec) * tr || a->grid <= 0 ||
      static_cast<int64_t>(a->grid - 1) * a->slots >= a->rows ||
      a->smem < 4 * kMaxWarps * 4 + (a->slots > 1 ? a->slots * a->D * 4 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->bf16)
    return static_cast<int>(
        launch_bwd<__nv_bfloat16>(x, scale, dy, dx, partial, dscale, *a, st));
  return static_cast<int>(launch_bwd<float>(x, scale, dy, dx, partial, dscale, *a, st));
}

extern "C" int repro_rmsnorm_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
