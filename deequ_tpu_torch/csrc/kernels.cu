// Hand-written Hopper (sm_90a) kernels of the fused verification pass.
//
// Plain C interface, loaded with ctypes by deequ_tpu_torch/ops/cuda_build.py.
// Every launcher enqueues on the caller's stream, allocates nothing,
// never synchronises, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
//
// K1 dq_masked_moments     replaces deequ_tpu/ops/pallas_kernels.py
//                          masked_moments (_masked_moments_kernel).
// K2 dq_centered_sumsq     replaces pallas_kernels.py masked_centered_sumsq
//                          (_sumsq_kernel) and its XLA centring prologue.
// K3 dq_hll_register_max   replaces pallas_kernels.py hll_register_max
//                          (_kernel).
// K4 dq_hist16             replaces pallas_kernels.py hist16
//                          (_hist16_kernel) and the f32_sortable_bin16
//                          prologue that fed it.
//
// Bound on the H100 (3.35 TB/s HBM3): all three read each input once and
// do a handful of operations per row, so each is bound by bytes —
// K1 and K2 read 9 B/row (f64 value + bool mask), K3 5 B/row (int32
// code + bool mask); about 11 us and 6 us for a 4,194,304-row batch.
// The design answer for now is one pass over the inputs with enough
// blocks in flight to keep the memory system busy (grid-stride loop,
// 8 blocks of 256 threads per SM); vector loads, TMA and tuning are
// later work.
//
// Determinism: K1 and K2 use no float atomics. Each block writes one
// partial; a second single-block kernel folds the partials in a fixed
// order. With the grid a function of n alone, a sum is bit-identical
// from run to run, which cached states rely on. K3's register max is
// order-free, so its shared-memory and global atomicMax are exact.
//
// K4 (hist16) counts each row's 16-bit sortable-key bin of float(x) into
// 65536 int32 counters. It is bound by bytes too: 9 B/row read plus the
// 256 KB histogram written, about 11 us for a 4,194,304-row batch. The
// 65536 int32 bins (256 KB) do not fit one block's 227 KB of shared
// memory, so the counters live in global memory, where they stay in
// the 50 MB L2. The design answer to contention is warp aggregation:
// __match_any_sync groups a warp's lanes by bin, and one lane per
// distinct bin adds the group's size, so a one-value column makes one
// atomic per warp, not one per row. Excluded rows all go to the
// sentinel bin 65535; they are counted in registers and added once per
// block. Integer atomics commute, so the counts are exact and the same
// on every run.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;  // rows a thread covers before the grid grows
constexpr int kHllRegisters = 512;  // HLL++ p = 9

int grid_for(long long n, int max_blocks) {
  long long want = (n + (long long)kThreads * kRowsPerThread - 1) /
                   ((long long)kThreads * kRowsPerThread);
  if (want < 1) want = 1;
  if (want > max_blocks) want = max_blocks;
  return (int)want;
}

struct Moments {
  long long cnt;
  double sum;
  double mn;
  double mx;
};

__device__ __forceinline__ Moments moments_identity() {
  Moments r;
  r.cnt = 0;
  r.sum = 0.0;
  r.mn = CUDART_INF;
  r.mx = -CUDART_INF;
  return r;
}

__device__ __forceinline__ Moments moments_combine(Moments a, Moments b) {
  Moments r;
  r.cnt = a.cnt + b.cnt;
  r.sum = a.sum + b.sum;
  r.mn = fmin(a.mn, b.mn);
  r.mx = fmax(a.mx, b.mx);
  return r;
}

__device__ __forceinline__ Moments warp_reduce(Moments v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    Moments o;
    o.cnt = __shfl_down_sync(0xffffffffu, v.cnt, offset);
    o.sum = __shfl_down_sync(0xffffffffu, v.sum, offset);
    o.mn = __shfl_down_sync(0xffffffffu, v.mn, offset);
    o.mx = __shfl_down_sync(0xffffffffu, v.mx, offset);
    v = moments_combine(v, o);
  }
  return v;
}

// Fixed-shape block reduce: warp shuffles, then warp 0 over the warp
// results. Thread 0 holds the block's value on return.
__device__ __forceinline__ Moments block_reduce(Moments v) {
  __shared__ long long s_cnt[kWarps];
  __shared__ double s_sum[kWarps];
  __shared__ double s_mn[kWarps];
  __shared__ double s_mx[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce(v);
  if (lane == 0) {
    s_cnt[warp] = v.cnt;
    s_sum[warp] = v.sum;
    s_mn[warp] = v.mn;
    s_mx[warp] = v.mx;
  }
  __syncthreads();
  if (warp == 0) {
    Moments w = moments_identity();
    if (lane < kWarps) {
      w.cnt = s_cnt[lane];
      w.sum = s_sum[lane];
      w.mn = s_mn[lane];
      w.mx = s_mx[lane];
    }
    v = warp_reduce(w);
  }
  return v;
}

__device__ __forceinline__ double block_reduce_sum(double v) {
  __shared__ double s_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  if (lane == 0) s_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_sum[lane] : 0.0;
    for (int offset = 16; offset > 0; offset >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// ---- K1: masked count / sum / min / max ---------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_partial(const T* __restrict__ x, const uint8_t* __restrict__ m,
                long long n, long long* __restrict__ part_cnt,
                double* __restrict__ part_sum, double* __restrict__ part_mn,
                double* __restrict__ part_mx) {
  Moments acc = moments_identity();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (m[i]) {
      const double v = (double)x[i];
      acc.cnt += 1;
      acc.sum += v;
      acc.mn = fmin(acc.mn, v);
      acc.mx = fmax(acc.mx, v);
    }
  }
  acc = block_reduce(acc);
  if (threadIdx.x == 0) {
    part_cnt[blockIdx.x] = acc.cnt;
    part_sum[blockIdx.x] = acc.sum;
    part_mn[blockIdx.x] = acc.mn;
    part_mx[blockIdx.x] = acc.mx;
  }
}

__global__ void __launch_bounds__(kThreads)
moments_final(const long long* __restrict__ part_cnt,
              const double* __restrict__ part_sum,
              const double* __restrict__ part_mn,
              const double* __restrict__ part_mx, int parts,
              double* __restrict__ out) {
  Moments acc = moments_identity();
  for (int i = threadIdx.x; i < parts; i += blockDim.x) {
    Moments p;
    p.cnt = part_cnt[i];
    p.sum = part_sum[i];
    p.mn = part_mn[i];
    p.mx = part_mx[i];
    acc = moments_combine(acc, p);
  }
  acc = block_reduce(acc);
  if (threadIdx.x == 0) {
    out[0] = (double)acc.cnt;
    out[1] = acc.sum;
    out[2] = acc.mn;
    out[3] = acc.mx;
  }
}

// ---- K2: masked centred sum of squares ----------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_partial(const T* __restrict__ x, const uint8_t* __restrict__ m,
              long long n, const double* __restrict__ avg,
              double* __restrict__ part) {
  const double a = *avg;
  double acc = 0.0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (m[i]) {
      const double d = (double)x[i] - a;
      acc += d * d;
    }
  }
  acc = block_reduce_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
sumsq_final(const double* __restrict__ part, int parts,
            double* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < parts; i += blockDim.x) acc += part[i];
  acc = block_reduce_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

// ---- K3: HLL register max -----------------------------------------------

__global__ void __launch_bounds__(kThreads)
hll_max(const int32_t* __restrict__ codes, const uint8_t* __restrict__ m,
        long long n, int32_t* __restrict__ out) {
  __shared__ int32_t regs[kHllRegisters];
  for (int r = threadIdx.x; r < kHllRegisters; r += blockDim.x) regs[r] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (m[i]) {
      const int32_t c = codes[i];
      // code 0 (idx 0, rank 0) is every null row's code and a no-op;
      // skipping it keeps those rows from piling atomics on register 0
      const int32_t idx = c >> 6;
      if (c != 0 && idx >= 0 && idx < kHllRegisters) atomicMax(&regs[idx], c & 0x3F);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kHllRegisters; r += blockDim.x) {
    const int32_t v = regs[r];
    if (v != 0) atomicMax(&out[r], v);
  }
}

// ---- K4: 16-bit sortable-key histogram ----------------------------------

constexpr int kHistBins = 65536;
constexpr int kHistSentinel = kHistBins - 1;  // excluded rows

// The top 16 bits of float(x)'s order-preserving key: bin order is value
// order (pallas_kernels.f32_sortable_bin16 on the float32 cast).
__device__ __forceinline__ int sortable_bin16(double x) {
  const int32_t u = __float_as_int(__double2float_rn(x));
  const uint32_t key = u < 0 ? ~(uint32_t)u : ((uint32_t)u | 0x80000000u);
  return (int)(key >> 16);
}

__global__ void __launch_bounds__(kThreads)
hist16_count(const double* __restrict__ x, const uint8_t* __restrict__ live,
             long long n, int32_t* __restrict__ out) {
  __shared__ int s_excluded[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int excluded = 0;
  // whole warps iterate together (the loop bound is the warp's first
  // row), so every lane reaches __match_any_sync with the full mask
  for (long long base = (long long)blockIdx.x * blockDim.x + warp * 32;
       base < n; base += stride) {
    const long long i = base + lane;
    int bin = -1;  // out of range, or excluded: no per-row atomic
    if (i < n) {
      if (live[i]) {
        bin = sortable_bin16(x[i]);
      } else {
        excluded += 1;
      }
    }
    const unsigned group = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(group) - 1) {
      atomicAdd(&out[bin], __popc(group));
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1)
    excluded += __shfl_down_sync(0xffffffffu, excluded, offset);
  if (lane == 0) s_excluded[warp] = excluded;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_excluded[w];
    if (total) atomicAdd(&out[kHistSentinel], total);
  }
}

}  // namespace

extern "C" {

// out: 4 doubles (count, sum, min, max). scratch: 4 * max_blocks 8-byte
// slots. x_is_f32 selects float over double input.
int dq_masked_moments(const void* x, int x_is_f32, const void* m, long long n,
                      void* scratch, int max_blocks, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = grid_for(n, max_blocks);
  long long* part_cnt = (long long*)scratch;
  double* part_sum = (double*)scratch + max_blocks;
  double* part_mn = (double*)scratch + 2 * max_blocks;
  double* part_mx = (double*)scratch + 3 * max_blocks;
  if (x_is_f32) {
    moments_partial<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const uint8_t*)m, n, part_cnt, part_sum, part_mn,
        part_mx);
  } else {
    moments_partial<double><<<blocks, kThreads, 0, s>>>(
        (const double*)x, (const uint8_t*)m, n, part_cnt, part_sum, part_mn,
        part_mx);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_final<<<1, kThreads, 0, s>>>(part_cnt, part_sum, part_mn, part_mx,
                                       blocks, (double*)out);
  return (int)cudaGetLastError();
}

// out: 1 double. avg: 1 double on the device. scratch: max_blocks doubles.
int dq_centered_sumsq(const void* x, int x_is_f32, const void* m, long long n,
                      const void* avg, void* scratch, int max_blocks, void* out,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = grid_for(n, max_blocks);
  if (x_is_f32) {
    sumsq_partial<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const uint8_t*)m, n, (const double*)avg,
        (double*)scratch);
  } else {
    sumsq_partial<double><<<blocks, kThreads, 0, s>>>(
        (const double*)x, (const uint8_t*)m, n, (const double*)avg,
        (double*)scratch);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sumsq_final<<<1, kThreads, 0, s>>>((const double*)scratch, blocks,
                                     (double*)out);
  return (int)cudaGetLastError();
}

// out: 512 int32 registers, zeroed by the caller.
int dq_hll_register_max(const void* codes, const void* m, long long n,
                        int max_blocks, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = grid_for(n, max_blocks);
  hll_max<<<blocks, kThreads, 0, s>>>((const int32_t*)codes, (const uint8_t*)m,
                                      n, (int32_t*)out);
  return (int)cudaGetLastError();
}

// x: n doubles, live: n bools. out: 65536 int32 counters, zeroed by the
// caller.
int dq_hist16(const void* x, const void* live, long long n, int max_blocks,
              void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = grid_for(n, max_blocks);
  hist16_count<<<blocks, kThreads, 0, s>>>((const double*)x,
                                           (const uint8_t*)live, n,
                                           (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
