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
// Bound on the H100 (3.35 TB/s HBM3): every kernel reads each input once
// and does a handful of operations per row, so each is bound by bytes.
//
// K1, K2 read 9 B/row (f64 value + bool mask), about 11 us for a
// 4,194,304-row batch. One pass over the inputs, grid-stride, 8 blocks
// of 256 threads per SM, scalar loads. Determinism: no float atomics.
// Each block writes one partial; a second single-block kernel folds the
// partials in a fixed order. With the grid a function of n alone, a sum
// is bit-identical from run to run, which cached states rely on.
//
// K3 (hll_register_max) reads 5 B/row (int32 code + bool mask), about
// 6 us a batch. Two blocks of 1024 threads per SM (the wrapper passes
// the SM count and the plan). Vector loads: a thread takes four codes
// as one int4 and their four mask bytes as one word. Ranks are
// geometric, so almost no row raises its register: a thread reads the
// shared register and issues atomicMax only when its rank is larger.
// Max is monotone, so a stale read costs one extra atomic and loses no
// update. Each block then folds its 512 registers into the output the
// same way, test before atomicMax. Max is order-free: the registers are
// exact on every run.
//
// K4 (hist16) counts each row's 16-bit sortable-key bin of float(x)
// into 65536 int32 counters. It reads the mask (1 B/row) and x where
// live (8 B/row) and writes the 256 KB of counters, about 10 us a
// batch. The counters are privatised: one block of 1024 threads per SM
// holds all 65536 bins in shared memory as 16-bit counters packed two
// to a word (128 KB of dynamic shared memory, allowed by
// cudaFuncSetAttribute before each launch; a refused launch returns
// its error). Each live row costs one shared atomicAdd of
// 1 << 16*(bin & 1) on word bin >> 1, never an L2 atomic.
// - 16-bit overflow: the rows are cut into windows of at most 65532
//   rows (the wrapper's plan); a block counts one window, flushes its
//   non-zero counters into the output and zeroes them, then takes its
//   next window. No counter passes 65532, so any n stays exact.
// - Contention: a thread bins four consecutive rows and adds equal
//   bins once (a one-value column: one atomic per four rows); when a
//   whole warp's live rows share one bin (__reduce_max/min_sync), one
//   lane adds the warp's total. Excluded rows go to the sentinel bin
//   65535; they are counted in registers and added once per block.
// - The flush: a block scans its 32768 words with 16-byte reads and
//   adds each non-zero word, a pair of adjacent bins, with one 64-bit
//   global atomic; each block starts its scan at another word, so the
//   blocks, which flush together, do not queue on the same addresses.
//   On normal data a block holds about 2500 non-zero bins; 32-bit
//   atomics on every bin, scanned from word 0 by all blocks, made the
//   flush cost more than the rows.
// - Alignment: x need only be 8-byte aligned and the mask not at all.
//   The plan's head (0 or 1 row) brings x to a 16-byte boundary and is
//   counted with scalar loads; four mask bytes at any address are read
//   as two aligned words and funnel-shifted; a ragged tail of up to
//   three rows is read scalar. K3 does the same with a head of up to
//   three rows.
// Integer atomics commute: the counts are exact and the same on every
// run. Both launchers zero their output on the stream first.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

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

// ---- vector loads shared by K3 and K4 -----------------------------------

// Four mask bytes from p, at any alignment, as one 32-bit word (byte j is
// row j). Two aligned words are read and funnel-shifted; each holds at
// least one byte of [p, p + 4), so neither read leaves the mask's pages.
__device__ __forceinline__ uint32_t load_mask4(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const uint32_t shift = (uint32_t)(a & 3) * 8;
  const uint32_t lo = __ldg(w);
  return shift ? __funnelshift_r(lo, __ldg(w + 1), shift) : lo;
}

__device__ __forceinline__ bool mask_byte(uint32_t word, int j) {
  return (word >> (8 * j)) & 0xFFu;
}

// ---- K3: HLL register max -----------------------------------------------

constexpr int kHllThreads = 1024;

__device__ __forceinline__ void hll_row(int32_t* regs, int32_t c, bool live) {
  const int32_t idx = c >> 6;
  if (live && idx >= 0 && idx < kHllRegisters) {
    // rank 0 (code 0 is every null row's) never passes the test, and a
    // stale read only costs one extra atomic: max is monotone
    const int32_t rank = c & 0x3F;
    if (rank > *(volatile int32_t*)&regs[idx]) atomicMax(&regs[idx], rank);
  }
}

__device__ __forceinline__ void hll_quad(int32_t* regs, int4 c, uint32_t mk) {
  hll_row(regs, c.x, mask_byte(mk, 0));
  hll_row(regs, c.y, mask_byte(mk, 1));
  hll_row(regs, c.z, mask_byte(mk, 2));
  hll_row(regs, c.w, mask_byte(mk, 3));
}

// Rows [0, head) bring codes to a 16-byte boundary; then whole quads of
// four rows with vector loads; then a tail of up to three rows.
__global__ void __launch_bounds__(kHllThreads, 2)
hll_max(const int32_t* __restrict__ codes, const uint8_t* __restrict__ m,
        long long n, int head, int32_t* __restrict__ out) {
  __shared__ int32_t regs[kHllRegisters];
  for (int r = threadIdx.x; r < kHllRegisters; r += kHllThreads) regs[r] = 0;
  __syncthreads();
  const long long tid = (long long)blockIdx.x * kHllThreads + threadIdx.x;
  if (tid < head) hll_row(regs, codes[tid], m[tid]);
  const long long quads = (n - head) >> 2;
  const int4* cq = reinterpret_cast<const int4*>(codes + head);
  const uint8_t* mq = m + head;
  const long long stride = (long long)gridDim.x * kHllThreads;
  for (long long q = tid; q < quads; q += stride)
    hll_quad(regs, __ldg(cq + q), load_mask4(mq + 4 * q));
  const long long tail = head + 4 * quads;
  if (tid < n - tail) hll_row(regs, codes[tail + tid], m[tail + tid]);
  __syncthreads();
  for (int r = threadIdx.x; r < kHllRegisters; r += kHllThreads) {
    const int32_t v = regs[r];
    if (v > __ldcg(&out[r])) atomicMax(&out[r], v);
  }
}

// ---- K4: 16-bit sortable-key histogram ----------------------------------

constexpr int kHistBins = 65536;
constexpr int kHistSentinel = kHistBins - 1;  // excluded rows
constexpr int kHistThreads = 1024;
constexpr int kHistWords = kHistBins / 2;  // two 16-bit counters a word
constexpr int kHistSmemBytes = kHistWords * 4;  // 128 KB
constexpr int kMixedBins = kHistBins;  // a quad whose live rows differ in bin

// The top 16 bits of float(x)'s order-preserving key: bin order is value
// order (pallas_kernels.f32_sortable_bin16 on the float32 cast).
__device__ __forceinline__ int sortable_bin16(double x) {
  const int32_t u = __float_as_int(__double2float_rn(x));
  const uint32_t key = u < 0 ? ~(uint32_t)u : ((uint32_t)u | 0x80000000u);
  return (int)(key >> 16);
}

__device__ __forceinline__ void hist_add(uint32_t* hist, int bin, uint32_t count) {
  atomicAdd(&hist[bin >> 1], count << ((bin & 1) * 16));
}

// One quad of four consecutive rows a lane; the whole warp calls it
// together (`valid` false where a lane has no quad).
__device__ __forceinline__ void hist_quad(uint32_t* hist, bool valid, double2 a,
                                          double2 b, uint32_t mk, int& excluded) {
  const int bin[4] = {sortable_bin16(a.x), sortable_bin16(a.y),
                      sortable_bin16(b.x), sortable_bin16(b.y)};
  bool live[4];
  int nlive = 0;
  int key = -1;  // the one bin of the quad's live rows; -1 none; kMixedBins
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    live[j] = valid && mask_byte(mk, j);
    nlive += live[j];
    if (live[j]) key = (key < 0 || key == bin[j]) ? bin[j] : kMixedBins;
  }
  if (valid) excluded += 4 - nlive;
  const int hi = __reduce_max_sync(0xffffffffu, key);
  const int lo = __reduce_min_sync(0xffffffffu, key < 0 ? INT_MAX : key);
  if (hi == lo && hi < kHistBins) {  // the warp's live rows share one bin
    const int total = __reduce_add_sync(0xffffffffu, nlive);
    if ((threadIdx.x & 31) == 0) hist_add(hist, hi, (uint32_t)total);
    return;
  }
  // one atomic per distinct bin of the quad, by its first live row
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bool first = live[j];
    uint32_t count = 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool same = live[k] && bin[k] == bin[j];
      if (k < j) first = first && !same;
      if (k > j) count += same;
    }
    if (first) hist_add(hist, bin[j], count);
  }
}

// Adds `count` to bins 2 * pair and 2 * pair + 1 of the int32 output, the
// low bin's count in the low 32 bits: one 64-bit atomic for both. Every
// atomic on the output is of this width, so none overlaps another in
// part. The low bin's total is at most n < 2^32 (hist16_plan), so no
// carry crosses into the high bin.
__device__ __forceinline__ void add_bin_pair(int32_t* out, int pair,
                                             unsigned long long count) {
  atomicAdd(reinterpret_cast<unsigned long long*>(out) + pair, count);
}

__device__ __forceinline__ unsigned long long bin_pair_count(int bin,
                                                             uint32_t count) {
  return (unsigned long long)count << (32 * (bin & 1));
}

// A shared word holds the 16-bit counts of one bin pair.
__device__ __forceinline__ void flush_word(int32_t* out, int pair, uint32_t word) {
  if (word)
    add_bin_pair(out, pair,
                 ((unsigned long long)(word >> 16) << 32) | (word & 0xFFFFu));
}

// Rows [0, head) bring x to a 16-byte boundary and go straight to the
// output. The rest is cut into windows of `window` rows (a multiple of
// 4, at most 65532); block b counts windows b, b + gridDim.x, ... in
// its shared counters and flushes them after each window.
__global__ void __launch_bounds__(kHistThreads, 1)
hist16_count(const double* __restrict__ x, const uint8_t* __restrict__ live,
             long long n, int head, long long window, int32_t* __restrict__ out) {
  extern __shared__ uint4 hist_words[];  // kHistWords 32-bit words
  uint32_t* hist = reinterpret_cast<uint32_t*>(hist_words);
  __shared__ int s_excluded[kHistThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int excluded = 0;
  if (blockIdx.x == 0 && threadIdx.x < head) {
    if (live[threadIdx.x]) {
      const int bin = sortable_bin16(x[threadIdx.x]);
      add_bin_pair(out, bin >> 1, bin_pair_count(bin, 1));
    } else {
      excluded += 1;
    }
  }
  const long long body = n - head;
  const long long windows = body > 0 ? (body + window - 1) / window : 0;
  if ((long long)blockIdx.x < windows) {
    for (int v = threadIdx.x; v < kHistWords / 4; v += kHistThreads)
      hist_words[v] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  for (long long w = blockIdx.x; w < windows; w += gridDim.x) {
    const long long start = head + w * window;
    const long long rows = min(window, n - start);
    const long long quads = rows >> 2;
    const double2* xq = reinterpret_cast<const double2*>(x + start);
    const uint8_t* mq = live + start;
    // warp-uniform bound: every lane reaches the warp reductions
    for (long long base = (long long)warp * 32; base < quads;
         base += 2LL * kHistThreads) {
      const long long q0 = base + lane;
      const long long q1 = q0 + kHistThreads;
      const bool v0 = q0 < quads;
      const bool v1 = q1 < quads;
      double2 a0 = make_double2(0.0, 0.0), b0 = a0, a1 = a0, b1 = a0;
      uint32_t m0 = 0, m1 = 0;
      if (v0) {
        a0 = __ldg(xq + 2 * q0);
        b0 = __ldg(xq + 2 * q0 + 1);
        m0 = load_mask4(mq + 4 * q0);
      }
      if (v1) {
        a1 = __ldg(xq + 2 * q1);
        b1 = __ldg(xq + 2 * q1 + 1);
        m1 = load_mask4(mq + 4 * q1);
      }
      hist_quad(hist, v0, a0, b0, m0, excluded);
      hist_quad(hist, v1, a1, b1, m1, excluded);
    }
    if (threadIdx.x < rows - 4 * quads) {  // the last window's ragged tail
      const long long i = start + 4 * quads + threadIdx.x;
      if (live[i]) {
        hist_add(hist, sortable_bin16(x[i]), 1);
      } else {
        excluded += 1;
      }
    }
    __syncthreads();
    // each block starts its scan elsewhere, so the blocks' flushes, which
    // end together, do not queue on the same output words
    const int first = (int)(((long long)blockIdx.x * (kHistWords / 4)) / gridDim.x);
    for (int t = threadIdx.x; t < kHistWords / 4; t += kHistThreads) {
      const int v = (t + first) % (kHistWords / 4);
      const uint4 c = hist_words[v];
      if (c.x | c.y | c.z | c.w) {
        flush_word(out, 4 * v, c.x);
        flush_word(out, 4 * v + 1, c.y);
        flush_word(out, 4 * v + 2, c.z);
        flush_word(out, 4 * v + 3, c.w);
        hist_words[v] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
  }
  excluded = __reduce_add_sync(0xffffffffu, excluded);
  if (lane == 0) s_excluded[warp] = excluded;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kHistThreads / 32; ++w) total += s_excluded[w];
    if (total)
      add_bin_pair(out, kHistSentinel >> 1,
                   bin_pair_count(kHistSentinel, (uint32_t)total));
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

// out: 512 int32 registers, zeroed here. head (0-3 rows) brings codes to
// a 16-byte boundary; blocks of kHllThreads (the wrapper's plan).
int dq_hll_register_max(const void* codes, const void* m, long long n,
                        int head, int blocks, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, kHllRegisters * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  hll_max<<<blocks, kHllThreads, 0, s>>>((const int32_t*)codes,
                                         (const uint8_t*)m, n, head,
                                         (int32_t*)out);
  return (int)cudaGetLastError();
}

// x: n doubles, live: n bools. out: 65536 int32 counters, 8-byte aligned,
// zeroed here. head, window and blocks are the wrapper's plan
// (hist16_plan).
int dq_hist16(const void* x, const void* live, long long n, int head,
              long long window, int blocks, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // above 48 KB a block's dynamic shared memory must be allowed first;
  // without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(
      hist16_count, cudaFuncAttributeMaxDynamicSharedMemorySize, kHistSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(out, 0, kHistBins * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  hist16_count<<<blocks, kHistThreads, kHistSmemBytes, s>>>(
      (const double*)x, (const uint8_t*)live, n, head, window, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
