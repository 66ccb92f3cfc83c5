// Design probe of the port's kernels (tools/torch_kernel_probe.py). It
// includes the shipped kernels and adds kernels the library has no use
// for: hist16_count with another flush; a kernel that only loads what
// hll_max loads; for K1 and K2 the first design (scalar loads under the
// mask, a second fold launch), the new design's other folds (a second
// launch, a cooperative launch with a grid sync), the new design with
// four quads in flight, and kernels that only load what K1 and K2 load.
#include <cooperative_groups.h>

#include "../deequ_tpu_torch/csrc/kernels.cu"

namespace {

// hist16_count over n rows (a multiple of 4, x 16-byte aligned) with the
// flush chosen by `flush`: 0 as shipped (each block from its own word, one
// 64-bit atomic per non-zero word); 1 one 32-bit atomic per non-zero bin,
// every block from word 0; 2 no global atomics (the rows alone). Excluded
// rows are not added.
__global__ void __launch_bounds__(kHistThreads, 1)
hist16_flush_probe(const double* __restrict__ x, const uint8_t* __restrict__ live,
                   long long n, long long window, int32_t* __restrict__ out,
                   int flush) {
  extern __shared__ uint4 hist_words[];
  uint32_t* hist = reinterpret_cast<uint32_t*>(hist_words);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int excluded = 0;
  const long long windows = n > 0 ? (n + window - 1) / window : 0;
  for (int v = threadIdx.x; v < kHistWords / 4; v += kHistThreads)
    hist_words[v] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (long long w = blockIdx.x; w < windows; w += gridDim.x) {
    const long long start = w * window;
    const long long quads = min(window, n - start) >> 2;
    const double2* xq = reinterpret_cast<const double2*>(x + start);
    const uint8_t* mq = live + start;
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
    __syncthreads();
    const int first =
        flush == 0 ? (int)(((long long)blockIdx.x * (kHistWords / 4)) / gridDim.x) : 0;
    for (int t = threadIdx.x; t < kHistWords / 4; t += kHistThreads) {
      const int v = (t + first) % (kHistWords / 4);
      const uint4 c = hist_words[v];
      if (c.x | c.y | c.z | c.w) {
        const uint32_t words[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (flush == 0) {
            flush_word(out, 4 * v + k, words[k]);
          } else if (flush == 1) {
            if (words[k] & 0xFFFFu) atomicAdd(&out[8 * v + 2 * k], (int)(words[k] & 0xFFFFu));
            if (words[k] >> 16) atomicAdd(&out[8 * v + 2 * k + 1], (int)(words[k] >> 16));
          }
        }
        hist_words[v] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
  }
  if (excluded == -1) out[0] = 0;  // keeps the count live
}

// hll_max's loads and nothing else: the least time any K3 of this access
// pattern can take.
__global__ void __launch_bounds__(kHllThreads, 2)
hll_load_floor(const int32_t* __restrict__ codes, const uint8_t* __restrict__ m,
               long long n, int32_t* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * kHllThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kHllThreads;
  const int4* cq = reinterpret_cast<const int4*>(codes);
  uint32_t acc = 0;
  for (long long q = tid; q < (n >> 2); q += stride) {
    const int4 c = __ldg(cq + q);
    acc ^= (uint32_t)(c.x ^ c.y ^ c.z ^ c.w) ^ load_mask4(m + 4 * q);
  }
  if (acc == 0x9E3779B9u) out[0] = (int32_t)acc;  // keeps the loads live
}

// ---- K1, K2: the first design, as it shipped before the redesign -------

namespace earlier {


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;  // rows a thread covers before the grid grows

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

constexpr int kMaxBlocks = 8 * 132;

}  // namespace earlier

// ---- K1, K2: the new design's other folds and a load floor -------------

// (c) each block writes its partial; a second launch folds them
template <int U>
__global__ void __launch_bounds__(kMomentsThreads, 2)
moments_partials(const double* __restrict__ x, const uint8_t* __restrict__ m,
                 long long n, int head, Moments* __restrict__ part) {
  const Moments b = moments_block<U>(x, m, n, head);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
}

__global__ void __launch_bounds__(kMomentsThreads)
moments_fold_launch(const Moments* __restrict__ part, int parts, double* __restrict__ out) {
  moments_fold(part, parts, out);
}

__global__ void __launch_bounds__(kMomentsThreads, 2)
sumsq_partials(const double* __restrict__ x, const uint8_t* __restrict__ m,
               long long n, int head, const double* __restrict__ avg,
               Sum* __restrict__ part) {
  const Sum b = sumsq_block<kMomentsQuadsInFlight>(x, m, n, head, *avg);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
}

__global__ void __launch_bounds__(kMomentsThreads)
sumsq_fold_launch(const Sum* __restrict__ part, int parts, double* __restrict__ out) {
  sumsq_fold(part, parts, out);
}

// (b) one cooperative launch: every block writes its partial, the grid
// syncs, block 0 folds
__global__ void __launch_bounds__(kMomentsThreads, 2)
moments_grid_sync(const double* __restrict__ x, const uint8_t* __restrict__ m,
                  long long n, int head, Moments* __restrict__ part,
                  double* __restrict__ out) {
  const Moments b = moments_block<kMomentsQuadsInFlight>(x, m, n, head);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0) moments_fold(part, gridDim.x, out);
}

__global__ void __launch_bounds__(kMomentsThreads, 2)
sumsq_grid_sync(const double* __restrict__ x, const uint8_t* __restrict__ m,
                long long n, int head, const double* __restrict__ avg,
                Sum* __restrict__ part, double* __restrict__ out) {
  const Sum b = sumsq_block<kMomentsQuadsInFlight>(x, m, n, head, *avg);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0) sumsq_fold(part, gridDim.x, out);
}

// (a) as shipped, with U quads in flight a thread
template <int U>
__global__ void __launch_bounds__(kMomentsThreads, 2)
moments_last_block(const double* __restrict__ x, const uint8_t* __restrict__ m,
                   long long n, int head, Moments* __restrict__ part,
                   unsigned int* __restrict__ tickets, double* __restrict__ out) {
  const Moments b = moments_block<U>(x, m, n, head);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  if (drew_last_ticket(tickets)) moments_fold(part, gridDim.x, out);
}

template <int U>
__global__ void __launch_bounds__(kMomentsThreads, 2)
sumsq_last_block(const double* __restrict__ x, const uint8_t* __restrict__ m,
                 long long n, int head, const double* __restrict__ avg,
                 Sum* __restrict__ part, unsigned int* __restrict__ tickets,
                 double* __restrict__ out) {
  const Sum b = sumsq_block<U>(x, m, n, head, *avg);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  if (drew_last_ticket(tickets)) sumsq_fold(part, gridDim.x, out);
}

struct LoadsOnly {
  unsigned long long bits;
  __device__ void add(double v, bool live) {
    bits ^= (unsigned long long)__double_as_longlong(v) ^ (unsigned long long)live;
  }
};

// the new design's loads and nothing else: the least time any K1 or K2
// of this access pattern can take
template <int U>
__global__ void __launch_bounds__(kMomentsThreads, 2)
moments_load_floor(const double* __restrict__ x, const uint8_t* __restrict__ m,
                   long long n, int head, double* __restrict__ out) {
  LoadsOnly acc{0};
  for_each_row<U>(x, m, n, head, acc);
  if (acc.bits == 0x9E3779B97F4A7C15ull) out[0] = 0.0;  // keeps the loads live
}

// K1's rows with less work a row: a NaN flag and one compare each for min
// and max (4 FP64 operations a row instead of 5), the count by __popc of
// the quad's live bytes. Gives the shipped kernel's bits.
struct LeanMoments {
  Moments m;
  bool nan;
  __device__ void add(double v, bool live) {
    m.sum = m.sum + (live ? v : 0.0);
    const double lo = live ? v : CUDART_INF;
    const double hi = live ? v : -CUDART_INF;
    m.mn = lo < m.mn ? lo : m.mn;
    m.mx = hi > m.mx ? hi : m.mx;
    nan |= lo != lo;
  }
};

// for_each_row with the count taken a quad at a time
template <typename T>
__device__ __forceinline__ void lean_rows(const T* __restrict__ x, const uint8_t* __restrict__ m,
                                          long long n, int head, LeanMoments& acc) {
  const long long tid = (long long)blockIdx.x * kMomentsThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kMomentsThreads;
  unsigned int cnt = 0;
  if (tid < head) {
    acc.add((double)x[tid], m[tid] != 0);
    cnt += m[tid] != 0;
  }
  const long long quads = (n - head) >> 2;
  const T* xq = x + head;
  const uint8_t* mq = m + head;
  long long q = tid;
  for (; q + stride < quads; q += 2 * stride) {
    double v[2][4];
    uint32_t mk[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      load_quad(xq, q + u * stride, v[u]);
      mk[u] = load_mask4(mq + 4 * (q + u * stride));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      cnt += __popc(__vcmpne4(mk[u], 0u)) >> 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.add(v[u][j], mask_byte(mk[u], j));
    }
  }
  for (; q < quads; q += stride) {
    double v[4];
    load_quad(xq, q, v);
    const uint32_t mk = load_mask4(mq + 4 * q);
    cnt += __popc(__vcmpne4(mk, 0u)) >> 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.add(v[j], mask_byte(mk, j));
  }
  const long long tail = head + 4 * quads;
  if (tid < n - tail) {
    acc.add((double)x[tail + tid], m[tail + tid] != 0);
    cnt += m[tail + tid] != 0;
  }
  acc.m.cnt = cnt;
  if (acc.nan) acc.m.mn = acc.m.mx = CUDART_NAN;
}

__global__ void __launch_bounds__(kMomentsThreads, 2)
moments_lean(const double* __restrict__ x, const uint8_t* __restrict__ m, long long n,
             int head, Moments* __restrict__ part, unsigned int* __restrict__ tickets,
             double* __restrict__ out) {
  LeanMoments acc{Moments::identity(), false};
  lean_rows(x, m, n, head, acc);
  const Moments b = block_tree(acc.m);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  if (drew_last_ticket(tickets)) moments_fold(part, gridDim.x, out);
}

// the ticket as the first version drew it: two fences around a relaxed
// atomicInc
__device__ __forceinline__ bool drew_last_ticket_fences(unsigned int* tickets) {
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicInc(tickets, gridDim.x - 1) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  return s_last;
}

__global__ void __launch_bounds__(kMomentsThreads, 2)
moments_fences(const double* __restrict__ x, const uint8_t* __restrict__ m, long long n,
               int head, Moments* __restrict__ part, unsigned int* __restrict__ tickets,
               double* __restrict__ out) {
  const Moments b = moments_block<kMomentsQuadsInFlight>(x, m, n, head);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  if (drew_last_ticket_fences(tickets)) moments_fold(part, gridDim.x, out);
}

__global__ void __launch_bounds__(kMomentsThreads, 2)
sumsq_fences(const double* __restrict__ x, const uint8_t* __restrict__ m, long long n,
             int head, const double* __restrict__ avg, Sum* __restrict__ part,
             unsigned int* __restrict__ tickets, double* __restrict__ out) {
  const Sum b = sumsq_block<kMomentsQuadsInFlight>(x, m, n, head, *avg);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  if (drew_last_ticket_fences(tickets)) sumsq_fold(part, gridDim.x, out);
}

// K1 with its sum alone (count, min and max left out), folded as shipped:
// what the rest of a row's work costs
struct SumOnly {
  Sum acc;
  __device__ void add(double v, bool live) { acc.v = acc.v + (live ? v : 0.0); }
};

__global__ void __launch_bounds__(kMomentsThreads, 2)
moments_sum_only(const double* __restrict__ x, const uint8_t* __restrict__ m, long long n,
                 int head, Sum* __restrict__ part, unsigned int* __restrict__ tickets,
                 double* __restrict__ out) {
  SumOnly rows{Sum::identity()};
  for_each_row<kMomentsQuadsInFlight>(x, m, n, head, rows);
  const Sum b = block_tree(rows.acc);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  if (drew_last_ticket(tickets)) sumsq_fold(part, gridDim.x, out);
}

// the same bytes in the flattest order: lane after lane on consecutive
// double2 of x, then on consecutive words of the mask (n a multiple of 4,
// x 16-byte and the mask 4-byte aligned)
__global__ void __launch_bounds__(kMomentsThreads, 2)
flat_load_floor(const double* __restrict__ x, const uint8_t* __restrict__ m,
                long long n, double* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * kMomentsThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kMomentsThreads;
  const double2* x2 = reinterpret_cast<const double2*>(x);
  const uint32_t* mw = reinterpret_cast<const uint32_t*>(m);
  unsigned long long bits = 0;
  for (long long i = tid; i < n / 2; i += 2 * stride) {
    const double2 a = __ldg(x2 + i);
    const double2 b = i + stride < n / 2 ? __ldg(x2 + i + stride) : make_double2(0.0, 0.0);
    bits ^= (unsigned long long)(__double_as_longlong(a.x) ^ __double_as_longlong(a.y) ^
                                 __double_as_longlong(b.x) ^ __double_as_longlong(b.y));
  }
  for (long long i = tid; i < n / 4; i += stride) bits ^= __ldg(mw + i);
  if (bits == 0x9E3779B97F4A7C15ull) out[0] = 0.0;  // keeps the loads live
}

}  // namespace

extern "C" {

int probe_hist16_flush(const void* x, const void* live, long long n,
                       long long window, int blocks, void* out, int flush,
                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hist16_flush_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, kHistSmemBytes);
  if (err != cudaSuccess) return (int)err;
  hist16_flush_probe<<<blocks, kHistThreads, kHistSmemBytes, (cudaStream_t)stream>>>(
      (const double*)x, (const uint8_t*)live, n, window, (int32_t*)out, flush);
  return (int)cudaGetLastError();
}

int probe_hll_load_floor(const void* codes, const void* m, long long n, int blocks,
                         void* out, void* stream) {
  hll_load_floor<<<blocks, kHllThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)codes, (const uint8_t*)m, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

// K1 (kernel 0) or K2 (kernel 1) over n float64 rows, by `design`:
// 0 the first design (two launches, its own grid); 1 the new design with
// the last-block fold and U = 4 quads in flight; 2 the new design with a
// second fold launch; 3 with one cooperative launch and a grid sync;
// 4 and 5 the load floor with U = 2 and U = 4; 6 the same bytes read
// flat (x as consecutive double2 a lane, then the mask as consecutive
// words; n a multiple of 4, aligned inputs); 7 (K1 only) a leaner row:
// a NaN flag, one compare each for min and max, the count by __popc a
// quad; 8 (K1 only) the sum alone; 9 the partials with no fold; 10 the
// last-block fold with the first version's ticket (two fences around a
// relaxed atomicInc). head and
// blocks are
// moments_plan's (design 0 ignores them); scratch holds 4 * 1056 8-byte
// slots; tickets is a zeroed counter; avg is K2's.
int probe_moments(int kernel, int design, const void* x, const void* m, long long n,
                  int head, int blocks, const void* avg, void* scratch,
                  void* tickets, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const double* xd = (const double*)x;
  const uint8_t* mk = (const uint8_t*)m;
  const double* a = (const double*)avg;
  double* o = (double*)out;
  unsigned int* t = (unsigned int*)tickets;
  if (design == 0) {
    const int eb = earlier::grid_for(n, earlier::kMaxBlocks);
    if (kernel == 0) {
      long long* cnt = (long long*)scratch;
      double* sum = (double*)scratch + earlier::kMaxBlocks;
      double* mn = (double*)scratch + 2 * earlier::kMaxBlocks;
      double* mx = (double*)scratch + 3 * earlier::kMaxBlocks;
      earlier::moments_partial<double><<<eb, earlier::kThreads, 0, s>>>(xd, mk, n, cnt, sum, mn, mx);
      earlier::moments_final<<<1, earlier::kThreads, 0, s>>>(cnt, sum, mn, mx, eb, o);
    } else {
      earlier::sumsq_partial<double><<<eb, earlier::kThreads, 0, s>>>(xd, mk, n, a, (double*)scratch);
      earlier::sumsq_final<<<1, earlier::kThreads, 0, s>>>((const double*)scratch, eb, o);
    }
    return (int)cudaGetLastError();
  }
  if (blocks > kMomentsThreads) return (int)cudaErrorInvalidValue;
  Moments* mp = (Moments*)scratch;
  Sum* sp = (Sum*)scratch;
  if (design == 1) {
    if (kernel == 0) {
      moments_last_block<4><<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, mp, t, o);
    } else {
      sumsq_last_block<4><<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, a, sp, t, o);
    }
  } else if (design == 2) {
    if (kernel == 0) {
      moments_partials<kMomentsQuadsInFlight><<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, mp);
      moments_fold_launch<<<1, kMomentsThreads, 0, s>>>(mp, blocks, o);
    } else {
      sumsq_partials<<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, a, sp);
      sumsq_fold_launch<<<1, kMomentsThreads, 0, s>>>(sp, blocks, o);
    }
  } else if (design == 3) {
    void* args_m[] = {(void*)&xd, (void*)&mk, (void*)&n, (void*)&head, (void*)&mp, (void*)&o};
    void* args_s[] = {(void*)&xd, (void*)&mk, (void*)&n, (void*)&head, (void*)&a,
                      (void*)&sp, (void*)&o};
    const cudaError_t err =
        kernel == 0
            ? cudaLaunchCooperativeKernel((const void*)moments_grid_sync, dim3(blocks),
                                          dim3(kMomentsThreads), args_m, 0, s)
            : cudaLaunchCooperativeKernel((const void*)sumsq_grid_sync, dim3(blocks),
                                          dim3(kMomentsThreads), args_s, 0, s);
    if (err != cudaSuccess) return (int)err;
  } else if (design == 4) {
    moments_load_floor<2><<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, o);
  } else if (design == 5) {
    moments_load_floor<4><<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, o);
  } else if (design == 6) {
    flat_load_floor<<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, o);
  } else if (design == 7 && kernel == 0) {
    moments_lean<<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, mp, t, o);
  } else if (design == 8 && kernel == 0) {
    moments_sum_only<<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, sp, t, o);
  } else if (design == 10) {
    if (kernel == 0) {
      moments_fences<<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, mp, t, o);
    } else {
      sumsq_fences<<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, a, sp, t, o);
    }
  } else if (design == 9) {
    if (kernel == 0) {
      moments_partials<kMomentsQuadsInFlight><<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, mp);
    } else {
      sumsq_partials<<<blocks, kMomentsThreads, 0, s>>>(xd, mk, n, head, a, sp);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
