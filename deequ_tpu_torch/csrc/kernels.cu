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
// K1 (masked_moments) and K2 (masked_centered_sumsq) read 9 B/row (f64
// value + bool mask; 5 B/row for f32 x): 37.7 MB and 0.01127 ms for a
// 4,194,304-row batch. The first design ran 8 blocks of 256 threads per
// SM, one row per thread per step, and loaded x[i] inside `if (m[i])`:
// each step waited on two memory round trips in a row with one load in
// flight per thread, and a second launch folded the partials. It reached
// about 40% of the bound. This design:
// - Loads ahead of the mask. A thread takes quads of four rows: x as two
//   double2 (one float4 for f32) and the four mask bytes as one word
//   (load_mask4). It issues kMomentsQuadsInFlight quads' loads (72 bytes
//   for f64) before it uses any, and selects live rows in registers:
//   `sum + (live ? v : 0.0)` has the bits of skipping the row, since a
//   sum that starts at +0.0 is never -0.0. Reading x under a false mask
//   costs nothing: the bound counts all of x.
// - Occupancy: blocks of 512 threads, two per SM (__launch_bounds__ caps
//   the registers at 64), so an SM has 1024 threads x 72 B = 72 KB in
//   flight, four times the 18 KB that 3.35 TB/s x ~0.7 us asks of it.
// - The grid is moments_plan's: ceil(quads / 1024) blocks, at most 264
//   (two on each of the H100's 132 SMs). It is a function of n alone, so
//   the summation order, and with it every sum's bits, is the same on
//   every run and on every card with this build.
// - Alignment: the plan's head (0-1 rows of f64, 0-3 of f32) brings x to
//   16 bytes and is read scalar by the first threads of block 0; then
//   the quads, grid-stride; then a tail of up to three rows, read scalar.
//   The mask may sit at any address.
// - Order: each thread adds its head row, its quads in ascending order
//   and its tail row, one after another; then a warp tree
//   (__shfl_down_sync 16, 8, 4, 2, 1) and a tree over the block's 16
//   warp sums. cuda_kernels.masked_moments_blocked and
//   masked_centered_sumsq_blocked repeat this order in PyTorch and must
//   give the same bits.
// - One launch: each block writes its partial and draws a ticket with
//   one acquire-release atomic inc on a counter that wraps to 0 at
//   gridDim.x - 1. The block that draws the last ticket folds the
//   partials in index order with the same trees (grid <= 512: one partial
//   a thread), and its draw has left the counter at 0 for the next
//   launch. The wrapper keeps one counter per device and stream: launches
//   on one stream run one after another, so no two launches share a
//   counter at once. Against a second fold launch and a cooperative
//   launch with a grid sync, measured by tools/torch_kernel_probe.py,
//   this was the fastest (PERF.md). The fold's serial chain (the ticket's
//   round trip to L2, the partials' read, two trees) is what keeps K1
//   about 2.5 us above a kernel that only loads its bytes.
// - Min and max propagate NaN as the plain version and jnp.minimum do
//   (`v < mn || v != v`), never with the math library's min and max,
//   which return the other operand when one is NaN. Count, min
//   and max are exact in any order.
// - K2 writes (x - avg)^2 and its add as __dsub_rn, __dmul_rn and
//   __dadd_rn, so nvcc cannot contract them into an FMA and the PyTorch
//   emulation reproduces the kernel's bits.
// No float atomics anywhere.
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

constexpr int kHllRegisters = 512;  // HLL++ p = 9

// ---- vector loads shared by K1-K4 ---------------------------------------

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

// Quad q of four rows from a 16-byte aligned x, widened to double.
__device__ __forceinline__ void load_quad(const double* x, long long q, double (&v)[4]) {
  const double2* p = reinterpret_cast<const double2*>(x) + 2 * q;
  const double2 a = __ldg(p);
  const double2 b = __ldg(p + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void load_quad(const float* x, long long q, double (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x) + q);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// ---- K1, K2: the rows a thread reads, and the trees ---------------------

constexpr int kMomentsThreads = 512;
constexpr int kMomentsWarps = kMomentsThreads / 32;
constexpr int kMomentsQuadsInFlight = 2;  // quads a thread loads before using any

// Calls acc.add(v, live) for each of this thread's rows, in the order the
// blocked emulation repeats: row `tid` of the head (rows [0, head) bring
// x to 16 bytes), the thread's quads tid, tid + stride, ... ascending,
// then row `tid` of the tail (at most three rows). Loads of U quads are
// issued before any of them is used.
template <int U, typename T, typename Acc>
__device__ __forceinline__ void for_each_row(const T* __restrict__ x,
                                             const uint8_t* __restrict__ m,
                                             long long n, int head, Acc& acc) {
  const long long tid = (long long)blockIdx.x * kMomentsThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kMomentsThreads;
  if (tid < head) acc.add((double)x[tid], m[tid] != 0);
  const long long quads = (n - head) >> 2;
  const T* xq = x + head;
  const uint8_t* mq = m + head;
  long long q = tid;
  for (; q + (U - 1) * stride < quads; q += U * stride) {
    double v[U][4];
    uint32_t mk[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_quad(xq, q + u * stride, v[u]);
      mk[u] = load_mask4(mq + 4 * (q + u * stride));
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.add(v[u][j], mask_byte(mk[u], j));
  }
  for (; q < quads; q += stride) {
    double v[4];
    load_quad(xq, q, v);
    const uint32_t mk = load_mask4(mq + 4 * q);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.add(v[j], mask_byte(mk, j));
  }
  const long long tail = head + 4 * quads;
  if (tid < n - tail) acc.add((double)x[tail + tid], m[tail + tid] != 0);
}

// Lane 0 gets the warp's fold: lane i adds lane i + offset for offset 16,
// 8, 4, 2, 1.
template <typename V>
__device__ __forceinline__ V warp_tree(V v) {
  for (int offset = 16; offset > 0; offset >>= 1) v = V::combine(v, V::shfl_down(v, offset));
  return v;
}

// Thread 0 gets the block's fold: the warp trees, then warp 0's tree over
// the kMomentsWarps warp values and identities in its other lanes. Starts
// and ends with __syncthreads, so two calls may follow each other.
template <typename V>
__device__ __forceinline__ V block_tree(V v) {
  __shared__ V s_warp[kMomentsWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_tree(v);
  __syncthreads();
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_tree(lane < kMomentsWarps ? s_warp[lane] : V::identity());
  return v;
}

// True in the one block that draws the last ticket, after every block has
// written its partial. Thread 0, which stored the block's partial, draws
// with one acquire-release atomic inc at GPU scope: the release publishes
// the partial before the ticket, and in the block that draws last the
// acquire makes every other block's partial visible; __syncthreads passes
// that on to the block's other threads. (Two __threadfence() around a
// relaxed atomicInc cost 0.3-0.7 us more; PERF.md.) inc wraps the
// counter to 0 at gridDim.x - 1, so the last draw leaves it at 0 for the
// next launch on this stream.
__device__ __forceinline__ bool drew_last_ticket(unsigned int* tickets) {
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    unsigned int ticket;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(ticket)
                 : "l"(tickets), "r"(gridDim.x - 1)
                 : "memory");
    s_last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  return s_last;
}

// ---- K1: masked count / sum / min / max ---------------------------------

struct Moments {
  long long cnt;
  double sum;
  double mn;
  double mx;

  __device__ static Moments identity() { return {0, 0.0, CUDART_INF, -CUDART_INF}; }

  // NaN wins, as in the plain version (torch.min/max) and jnp.minimum
  __device__ static double lower(double a, double b) { return (b < a || b != b) ? b : a; }
  __device__ static double upper(double a, double b) { return (b > a || b != b) ? b : a; }

  __device__ static Moments combine(Moments a, Moments b) {
    return {a.cnt + b.cnt, a.sum + b.sum, lower(a.mn, b.mn), upper(a.mx, b.mx)};
  }

  __device__ static Moments shfl_down(Moments v, int offset) {
    return {__shfl_down_sync(0xffffffffu, v.cnt, offset),
            __shfl_down_sync(0xffffffffu, v.sum, offset),
            __shfl_down_sync(0xffffffffu, v.mn, offset),
            __shfl_down_sync(0xffffffffu, v.mx, offset)};
  }

  __device__ void add(double v, bool live) {
    cnt += live;
    sum = sum + (live ? v : 0.0);
    mn = lower(mn, live ? v : CUDART_INF);
    mx = upper(mx, live ? v : -CUDART_INF);
  }
};

// The block's fold of its rows; thread 0 holds it.
template <int U, typename T>
__device__ __forceinline__ Moments moments_block(const T* x, const uint8_t* m,
                                                 long long n, int head) {
  Moments acc = Moments::identity();
  for_each_row<U>(x, m, n, head, acc);
  return block_tree(acc);
}

// The fold of `parts` partials in index order (parts <= kMomentsThreads),
// written to out as 4 doubles by thread 0.
__device__ __forceinline__ void moments_fold(const Moments* part, int parts,
                                             double* out) {
  Moments p = Moments::identity();
  if ((int)threadIdx.x < parts) {
    // the partials come from other SMs: read them from L2, not L1
    p.cnt = __ldcg(&part[threadIdx.x].cnt);
    p.sum = __ldcg(&part[threadIdx.x].sum);
    p.mn = __ldcg(&part[threadIdx.x].mn);
    p.mx = __ldcg(&part[threadIdx.x].mx);
  }
  p = block_tree(p);
  if (threadIdx.x == 0) {
    out[0] = (double)p.cnt;
    out[1] = p.sum;
    out[2] = p.mn;
    out[3] = p.mx;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMomentsThreads, 2)
masked_moments_kernel(const T* __restrict__ x, const uint8_t* __restrict__ m,
                      long long n, int head, Moments* __restrict__ part,
                      unsigned int* __restrict__ tickets, double* __restrict__ out) {
  const Moments b = moments_block<kMomentsQuadsInFlight>(x, m, n, head);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  if (drew_last_ticket(tickets)) moments_fold(part, gridDim.x, out);
}

// ---- K2: masked centred sum of squares ----------------------------------

struct Sum {
  double v;

  __device__ static Sum identity() { return {0.0}; }
  __device__ static Sum combine(Sum a, Sum b) { return {a.v + b.v}; }
  __device__ static Sum shfl_down(Sum s, int offset) {
    return {__shfl_down_sync(0xffffffffu, s.v, offset)};
  }
};

struct CenteredSquares {
  double avg;
  Sum acc;

  // rounded apart, never one FMA: the emulation repeats these bits
  __device__ void add(double v, bool live) {
    const double d = __dsub_rn(v, avg);
    acc.v = __dadd_rn(acc.v, live ? __dmul_rn(d, d) : 0.0);
  }
};

template <int U, typename T>
__device__ __forceinline__ Sum sumsq_block(const T* x, const uint8_t* m, long long n,
                                           int head, double avg) {
  CenteredSquares rows{avg, Sum::identity()};
  for_each_row<U>(x, m, n, head, rows);
  return block_tree(rows.acc);
}

__device__ __forceinline__ void sumsq_fold(const Sum* part, int parts, double* out) {
  Sum p = Sum::identity();
  if ((int)threadIdx.x < parts) p.v = __ldcg(&part[threadIdx.x].v);
  p = block_tree(p);
  if (threadIdx.x == 0) out[0] = p.v;
}

template <typename T>
__global__ void __launch_bounds__(kMomentsThreads, 2)
centered_sumsq_kernel(const T* __restrict__ x, const uint8_t* __restrict__ m,
                      long long n, int head, const double* __restrict__ avg,
                      Sum* __restrict__ part, unsigned int* __restrict__ tickets,
                      double* __restrict__ out) {
  const Sum b = sumsq_block<kMomentsQuadsInFlight>(x, m, n, head, *avg);
  if (threadIdx.x == 0) part[blockIdx.x] = b;
  if (drew_last_ticket(tickets)) sumsq_fold(part, gridDim.x, out);
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

// out: 4 doubles (count, sum, min, max). head and blocks are the wrapper's
// plan (moments_plan); scratch: 4 * blocks 8-byte slots for the partials;
// tickets: this stream's counter, 0 between launches. x_is_f32 selects
// float over double input.
int dq_masked_moments(const void* x, int x_is_f32, const void* m, long long n,
                      int head, int blocks, void* scratch, void* tickets,
                      void* out, void* stream) {
  if (blocks > kMomentsThreads) return (int)cudaErrorInvalidValue;  // one partial a thread
  cudaStream_t s = (cudaStream_t)stream;
  Moments* part = (Moments*)scratch;
  if (x_is_f32) {
    masked_moments_kernel<float><<<blocks, kMomentsThreads, 0, s>>>(
        (const float*)x, (const uint8_t*)m, n, head, part, (unsigned int*)tickets,
        (double*)out);
  } else {
    masked_moments_kernel<double><<<blocks, kMomentsThreads, 0, s>>>(
        (const double*)x, (const uint8_t*)m, n, head, part, (unsigned int*)tickets,
        (double*)out);
  }
  return (int)cudaGetLastError();
}

// out: 1 double. avg: 1 double on the device. head, blocks, scratch (blocks
// doubles) and tickets as for dq_masked_moments.
int dq_centered_sumsq(const void* x, int x_is_f32, const void* m, long long n,
                      int head, int blocks, const void* avg, void* scratch,
                      void* tickets, void* out, void* stream) {
  if (blocks > kMomentsThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Sum* part = (Sum*)scratch;
  if (x_is_f32) {
    centered_sumsq_kernel<float><<<blocks, kMomentsThreads, 0, s>>>(
        (const float*)x, (const uint8_t*)m, n, head, (const double*)avg, part,
        (unsigned int*)tickets, (double*)out);
  } else {
    centered_sumsq_kernel<double><<<blocks, kMomentsThreads, 0, s>>>(
        (const double*)x, (const uint8_t*)m, n, head, (const double*)avg, part,
        (unsigned int*)tickets, (double*)out);
  }
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
