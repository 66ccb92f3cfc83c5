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
// K5 dq_dict_strings       replaces no TPU kernel: the JAX package
//                          classifies and hashes strings on the host
//                          (deequ_tpu/ops/strings.py classify and
//                          hash_strings). It runs that work over a large
//                          dictionary's UTF-8 bytes on the card.
// K6 dq_hist16_select      replaces no TPU kernel: the JAX package selects
//                          a quantile sketch's decimated sample from K4's
//                          bins on the host (deequ_tpu/analyzers/sketch.py
//                          host_finish_batch). It selects it on the card.
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
//
// K5 (classify_hash_dictionary) gives each row of a dictionary-coded
// string column DataType's class code and ApproxCountDistinct's packed HLL
// code, bit for bit those of ops/strings.py classify and hash_strings with
// hll.registers_from_hashes. Its bound is bytes: it reads the dictionary's
// int64 offsets and UTF-8 bytes and the rows' int32 codes once and writes
// 5 B a row. One SF 1 batch of TPC-H comments (1,048,576 rows, about
// 910,000 entries of 28 bytes) is about 43 MB, 13 us at 3.35 TB/s.
// - Entries: one thread an entry walks its bytes. A first pass counts
//   its code points (bytes that do not continue a lead) and its NULs: the
//   hash starts from the count of non-NUL code points and its length
//   bucket, so both precede the mixing. A second pass decodes UTF-8 and
//   feeds each code point, two to a 64-bit word, to hash_strings' rounds,
//   then zero words up to the bucket's width (8, 16, 32, 64 or 128 code
//   points); past 128 code points the string hashes in chunks of 128, each
//   chunk's hash seeding the next, and each chunk's NULs are counted
//   before it. The same pass runs classify's state machine: sign, one
//   space, digits and dots, `true`/`false`, and at the end one final Java
//   line terminator stripped (after trailing NULs within the cap, as the
//   host's bucketed route does). Registers stay O(1) a thread; nothing
//   goes through an (n, width) matrix. A second kernel gathers the
//   entries' two codes to the rows (-1, a null row, gives 0 and 0).
// - Bytes are read one at a time through L1: a warp's 32 entries lie
//   side by side, so its lanes' bytes share cache lines. The host work
//   this replaces took about 1-2 s a batch, so the first design stops at
//   one thread an entry.
//
// K6 (hist16_select) gives a quantile sketch's decimated sample of a batch:
// the values at ranks offset + stride * j of a stable sort of the live
// float64 rows, bit for bit those the host took from K4's bins (its bins
// again, the owning bins' rows, a stable sort, the ranks). Its bound is
// bytes: one read of x and the mask (9 B a row) and the sort of the rows
// of the bins that own a rank. Those are not a sliver: on TPC-H lineitem
// they are 63-100% of a batch (a column of few values puts every row in
// a rank's bin). So the sort is a real sort, and the design keeps each of
// its passes a streaming pass over at most n 12-byte (key, row) pairs:
// - A plan block reads K4's 65536 counts once: the count n of value bins,
//   the level, each rank's bin (a binary search of the cumulative
//   counts), the wanted bins (the two zero bins together) and each rank's
//   place among the wanted rows (its rank less the unwanted rows below
//   its bin). Nothing comes back to the host: every later launch reads
//   its sizes from the plan's state, so the batch stays asynchronous.
// - Compaction: one pass counts each block's wanted rows, a second writes
//   them, in row order, as (order-preserving 64-bit key, row index) pairs
//   (ballot and popc within a warp, the warps' counts scanned in shared
//   memory). -0.0 and +0.0 take one key, so among zeros row order decides,
//   as in a stable sort.
// - A stable LSD radix sort of the pairs by key, 8 bits a pass: each
//   block counts its contiguous share's digits, one block scans the
//   (digit, block) counts, and each block scatters its share in order
//   (__match_any_sync ranks a lane among its warp's equal digits; the
//   warps' counts are scanned in shared memory). A pass whose digit is
//   the same in every key (the compaction ORs and ANDs the keys) is
//   skipped, and with it the copy: integer-valued columns sort in two to
//   four passes.
// - A gather reads each rank's row and writes x at it, so the sample
//   keeps the row's own bits (a -0.0 stays -0.0).
// No torch.sort, CUB or thrust: the scratch (two pair buffers, the plan's
// tables, the per-block counts) is one allocation of the wrapper's.

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

// ---- K5: a dictionary's strings, classified and hashed -----------------

constexpr int kStringsThreads = 256;
constexpr int kStringsCap = 128;  // strings._BUCKET_CAP: code points a chunk hashes
constexpr int kHllP = 9;          // hll.P: register index bits
constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull;  // xxhash64's primes (hll._PRIME1-5)
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ull;
// class codes, as strings.CODE_*
constexpr int8_t kClassFractional = 1;
constexpr int8_t kClassIntegral = 2;
constexpr int8_t kClassBoolean = 3;
constexpr int8_t kClassString = 4;
constexpr uint64_t kTrue = 0x65757274ull;        // "true", first letter lowest
constexpr uint64_t kFalse = 0x65736C6166ull;     // "false"

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

// One round of hash_strings over a word of two code points.
__device__ __forceinline__ uint64_t mix_word(uint64_t acc, uint64_t word) {
  const uint64_t k = rotl64(word * kP2, 31) * kP1;
  return rotl64(acc ^ k, 27) * kP1 + kP4;
}

__device__ __forceinline__ uint64_t avalanche(uint64_t acc) {
  acc ^= acc >> 33;
  acc *= kP2;
  acc ^= acc >> 29;
  acc *= kP3;
  acc ^= acc >> 32;
  return acc;
}

__device__ __forceinline__ bool is_continuation(uint32_t byte) {
  return (byte & 0xC0u) == 0x80u;
}

// The code point that starts at data[p] (p < end), UTF-8 decoded, with p
// moved past it. A byte that continues no lead starts no code point: p
// moves past it and the call returns false. A lead takes the continuation
// bytes it announces, as far as they go and the entry's end allows
// (cuda_kernels._code_points decodes alike).
__device__ __forceinline__ bool next_code_point(const uint8_t* __restrict__ data,
                                                long long& p, long long end,
                                                uint32_t& cp) {
  const uint32_t c = data[p++];
  if (is_continuation(c)) return false;
  int more;
  if (c < 0x80u) {
    cp = c;
    more = 0;
  } else if (c < 0xE0u) {
    cp = c & 0x1Fu;
    more = 1;
  } else if (c < 0xF0u) {
    cp = c & 0x0Fu;
    more = 2;
  } else if (c < 0xF8u) {
    cp = c & 0x07u;
    more = 3;
  } else {
    cp = c;
    more = 0;
  }
  for (; more > 0 && p < end && is_continuation(data[p]); --more, ++p)
    cp = (cp << 6) | (data[p] & 0x3Fu);
  return true;
}

// classify's decision, one code point at a time. The body lies between
// the optional sign and space and the stripped tail, which is known only
// at the end; every code point of the tail (NULs, terminators) is neither
// a digit nor a dot, so `bad` counts from the body's start to the string's
// end and the tail is taken off at the end.
struct TypeClass {
  bool sign = false;
  long long start = 0;       // the body's first code point
  long long bad = 0;         // from start on: neither a digit nor a dot
  long long dots = 0;        // from start on
  bool is_true = true;       // the first four code points spell "true"
  bool is_false = true;      // the first five spell "false"
  long long last_nonzero = 0;  // one past the last non-NUL code point
  uint32_t nz1 = 0, nz2 = 0;   // the code points at last_nonzero - 1 and - 2
  uint32_t raw1 = 0, raw2 = 0; // the last two code points

  __device__ __forceinline__ void add(uint32_t cp, long long pos) {
    if (pos == 0) {
      sign = cp == '+' || cp == '-';
      start = sign || cp == ' ';
    } else if (pos == 1 && sign && cp == ' ') {
      start = 2;
    }
    if (pos >= start) {
      if (cp == '.')
        ++dots;
      else if (cp < '0' || cp > '9')
        ++bad;
    }
    if (pos < 4) is_true = is_true && cp == ((kTrue >> (8 * pos)) & 0xFFu);
    if (pos < 5) is_false = is_false && cp == ((kFalse >> (8 * pos)) & 0xFFu);
    if (cp != 0) {
      nz2 = raw1;
      nz1 = cp;
      last_nonzero = pos + 1;
    }
    raw2 = raw1;
    raw1 = cp;
  }

  // Within the cap, trailing NULs fall away first (the host's bucketed
  // route reads them as padding); past it, only the terminator does.
  __device__ __forceinline__ int8_t finish(long long len) const {
    const bool capped = len <= kStringsCap;
    long long body = capped ? last_nonzero : len;
    const uint32_t l1 = capped ? nz1 : raw1;
    const uint32_t l2 = capped ? nz2 : raw2;
    if (body > 0) {
      if (l1 == '\n') {
        --body;
        if (body > 0 && l2 == '\r') --body;
      } else if (l1 == 0x0Du || l1 == 0x85u || l1 == 0x2028u || l1 == 0x2029u) {
        --body;
      }
    }
    const long long body_bad = bad - (len - body);
    if (body_bad == 0 && dots == 1) return kClassFractional;
    if (body_bad == 0 && dots == 0) return kClassIntegral;
    if ((body == 4 && is_true) || (body == 5 && is_false)) return kClassBoolean;
    return kClassString;
  }
};

__device__ __forceinline__ int bucket_width(long long len) {
  int width = 8;
  while (width < len) width <<= 1;
  return width;
}

__global__ void __launch_bounds__(kStringsThreads)
dict_strings_entries(const long long* __restrict__ offsets,
                     const uint8_t* __restrict__ data, long long n,
                     unsigned long long seed, int8_t* __restrict__ classes,
                     int32_t* __restrict__ packed) {
  const long long stride = (long long)gridDim.x * kStringsThreads;
  for (long long i = (long long)blockIdx.x * kStringsThreads + threadIdx.x; i < n;
       i += stride) {
    const long long begin = offsets[i];
    const long long end = offsets[i + 1];
    long long len = 0, zeros = 0;
    for (long long p = begin; p < end; ++p) {
      const uint32_t c = data[p];
      len += !is_continuation(c);
      zeros += c == 0;
    }
    TypeClass type;
    uint64_t hash = seed;
    long long p = begin;
    long long pos = 0;
    long long left = len;
    do {
      const int chunk = (int)min(left, (long long)kStringsCap);
      const int width = len <= kStringsCap ? bucket_width(len) : kStringsCap;
      long long nuls = zeros;
      if (len > kStringsCap) {  // this chunk's NULs
        nuls = 0;
        int seen = 0;
        for (long long q = p; q < end; ++q) {
          const uint32_t c = data[q];
          if (is_continuation(c)) continue;
          if (seen == chunk) break;
          ++seen;
          nuls += c == 0;
        }
      }
      uint64_t acc = hash + kP5 + (uint64_t)(chunk - nuls) * kP2;
      uint64_t low = 0;
      for (int got = 0; got < chunk;) {
        uint32_t cp;
        if (!next_code_point(data, p, end, cp)) continue;
        type.add(cp, pos++);
        if (got & 1)
          acc = mix_word(acc, low | ((uint64_t)cp << 32));
        else
          low = cp;
        ++got;
      }
      if (chunk & 1) acc = mix_word(acc, low);
      for (int r = (chunk + 1) >> 1; r < width / 2; ++r) acc = mix_word(acc, 0);
      hash = avalanche(acc);
      left -= chunk;
    } while (left > 0);
    classes[i] = type.finish(len);
    // hll.registers_from_hashes: bit P - 1 set keeps the rank <= 64 - P + 1
    const uint64_t rest = (hash << kHllP) | (1ull << (kHllP - 1));
    const int rank = __clzll((long long)rest) + 1;
    packed[i] = (int32_t)(((hash >> (64 - kHllP)) << 6) | (uint64_t)rank);
  }
}

__global__ void __launch_bounds__(kStringsThreads)
dict_strings_rows(const int32_t* __restrict__ codes, long long rows,
                  const int8_t* __restrict__ entry_classes,
                  const int32_t* __restrict__ entry_packed, long long n,
                  int8_t* __restrict__ classes, int32_t* __restrict__ packed) {
  const long long stride = (long long)gridDim.x * kStringsThreads;
  for (long long r = (long long)blockIdx.x * kStringsThreads + threadIdx.x; r < rows;
       r += stride) {
    const int32_t c = codes[r];
    const bool live = c >= 0 && c < n;
    classes[r] = live ? entry_classes[c] : (int8_t)0;
    packed[r] = live ? entry_packed[c] : 0;
  }
}

// ---- K6: a quantile sketch's decimated sample ---------------------------

constexpr int kSelectThreads = 1024;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kSelectValueBins = 65409;  // cuda_kernels.SELECT_VALUE_BINS
constexpr int kSelectWarpBins = kHistBins / kSelectWarps;  // a plan warp's run of bins
constexpr int kSelectWantedWords = kHistBins / 32;  // the wanted bins, one bit each
constexpr int kSelectDigits = 256;
constexpr int kSelectPasses = 8;  // 8-bit digits of a 64-bit key
constexpr int kZeroBinNeg = 0x7FFF;  // -0.0's bin
constexpr int kZeroBinPos = 0x8000;  // +0.0's bin

// What the plan block and the compaction leave for the later launches.
struct SelectState {
  unsigned long long n;     // live rows of the value bins
  unsigned long long kept;  // ranks sampled
  unsigned long long m;     // rows of the wanted bins
  unsigned long long key_or;   // over the wanted rows' keys
  unsigned long long key_and;
  int parity[kSelectPasses + 1];  // the pair buffer holding the rows before pass p
};

// An exclusive prefix sum over the block's threads in thread order, and
// the block's total. Every thread of the block calls it.
__device__ __forceinline__ unsigned long long block_exclusive_sum(unsigned long long v,
                                                                  unsigned long long& total) {
  __shared__ unsigned long long s_warp[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < warps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[warps - 1];
  const unsigned long long before = (warp ? s_warp[warp - 1] : 0) + x - v;
  __syncthreads();  // s_warp is free for the next call
  return before;
}

// The prefix sums of f(bin) over the 65536 bins, in bin order, written to
// out (inclusive or exclusive), and their total. Warp w takes bins
// [w * kSelectWarpBins, ...), 32 consecutive bins a step, so every load is
// coalesced and no step waits on a barrier. One block of kSelectThreads.
template <typename F>
__device__ __forceinline__ void bins_prefix_sum(F f, bool inclusive, unsigned long long* out,
                                                unsigned long long& total) {
  const int lane = threadIdx.x & 31;
  const int first = (threadIdx.x >> 5) * kSelectWarpBins;
  unsigned long long mine = 0;
#pragma unroll 8
  for (int b = first + lane; b < first + kSelectWarpBins; b += 32) mine += f(b);
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, o);
  // lane 0 of warp w gets the warps before w, and passes it to its lanes
  unsigned long long base = block_exclusive_sum(lane == 0 ? mine : 0, total);
  base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll 4
  for (int b = first + lane; b < first + kSelectWarpBins; b += 32) {
    const unsigned long long v = f(b);
    unsigned long long x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    out[b] = base + (inclusive ? x : x - v);
    base += __shfl_sync(0xffffffffu, x, 31);
  }
}

__device__ __forceinline__ unsigned long long value_count(const int32_t* counts, int bin) {
  // a count is below 2^32 (hist16_plan), so read it unsigned
  return bin < kSelectValueBins ? (unsigned long long)(uint32_t)counts[bin] : 0ull;
}

__device__ __forceinline__ bool is_wanted(const uint32_t* wanted, int bin) {
  return (wanted[bin >> 5] >> (bin & 31)) & 1u;
}

__device__ __forceinline__ void load_wanted(const uint32_t* wanted, uint32_t* s_wanted) {
  for (int w = threadIdx.x; w < kSelectWantedWords; w += blockDim.x) s_wanted[w] = wanted[w];
  __syncthreads();
}

__device__ __forceinline__ bool select_row(const double* x, const uint8_t* live,
                                           const uint32_t* s_wanted, long long i) {
  return live[i] && is_wanted(s_wanted, sortable_bin16(x[i]));
}

// The 64-bit order-preserving key of a float64. -0.0 and +0.0 are equal
// values and take one key, so a stable sort keeps them in row order.
__device__ __forceinline__ unsigned long long sortable_key64(double v) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(v == 0.0 ? 0.0 : v);
  return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
}

// Whether pass p's digit differs between two wanted rows' keys.
__device__ __forceinline__ bool pass_runs(const SelectState* st, int pass) {
  return ((st->key_or ^ st->key_and) >> (8 * pass)) & 0xFFull;
}

// Rows [b * chunk, b * chunk + chunk) of the m pairs are block b's: whole
// tiles of kSelectThreads, the same for the count and the scatter.
__device__ __forceinline__ long long pair_chunk(unsigned long long m) {
  const unsigned long long share = (m + gridDim.x - 1) / gridDim.x;
  return (long long)((share + kSelectThreads - 1) / kSelectThreads * kSelectThreads);
}

// One block. The sizes, each rank's place among the wanted rows (pos,
// which first holds its bin) and the wanted bins.
__global__ void __launch_bounds__(kSelectThreads)
select_plan(const int32_t* __restrict__ counts, long long cap, SelectState* __restrict__ st,
            unsigned long long* __restrict__ cum, uint32_t* __restrict__ wanted,
            uint32_t* __restrict__ pos, double* __restrict__ stats) {
  __shared__ uint32_t s_wanted[kSelectWantedWords];
  unsigned long long n;
  bins_prefix_sum([&](int bin) { return value_count(counts, bin); }, true, cum, n);
  for (int w = threadIdx.x; w < kSelectWantedWords; w += kSelectThreads) s_wanted[w] = 0;
  __syncthreads();
  int level = 0;
  while (n > ((unsigned long long)cap << level)) ++level;
  const unsigned long long stride = 1ull << level;
  const unsigned long long offset = stride >> 1;
  const unsigned long long kept = n > offset ? (n - offset + stride - 1) / stride : 0;
  // each rank's bin: the first whose cumulative count passes the rank
  for (unsigned long long j = threadIdx.x; j < kept; j += kSelectThreads) {
    const unsigned long long rank = offset + stride * j;
    int lo = 0, hi = kHistBins - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] > rank) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    pos[j] = (uint32_t)lo;
    atomicOr(&s_wanted[lo >> 5], 1u << (lo & 31));
  }
  __syncthreads();
  if (threadIdx.x == 0 &&
      (is_wanted(s_wanted, kZeroBinNeg) || is_wanted(s_wanted, kZeroBinPos))) {
    s_wanted[kZeroBinNeg >> 5] |= 1u << (kZeroBinNeg & 31);
    s_wanted[kZeroBinPos >> 5] |= 1u << (kZeroBinPos & 31);
  }
  __syncthreads();
  // the unwanted rows below each bin, over cum
  unsigned long long unwanted;
  bins_prefix_sum(
      [&](int bin) { return is_wanted(s_wanted, bin) ? 0ull : value_count(counts, bin); },
      false, cum, unwanted);
  __syncthreads();
  for (unsigned long long j = threadIdx.x; j < kept; j += kSelectThreads)
    pos[j] = (uint32_t)(offset + stride * j - cum[pos[j]]);
  for (int w = threadIdx.x; w < kSelectWantedWords; w += kSelectThreads) wanted[w] = s_wanted[w];
  if (threadIdx.x == 0) {
    st->n = n;
    st->kept = kept;
    st->m = n - unwanted;
    st->key_or = 0;
    st->key_and = ~0ull;
    st->parity[0] = 0;
    stats[0] = (double)n;
    stats[1] = (double)level;
  }
}

// The wanted rows of block b's rows [b * chunk, b * chunk + chunk).
__global__ void __launch_bounds__(kSelectThreads)
select_count(const double* __restrict__ x, const uint8_t* __restrict__ live, long long n,
             long long chunk, const uint32_t* __restrict__ wanted,
             uint32_t* __restrict__ block_rows) {
  __shared__ uint32_t s_wanted[kSelectWantedWords];
  load_wanted(wanted, s_wanted);
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min(n, begin + chunk);
  unsigned long long mine = 0;
  for (long long i = begin + threadIdx.x; i < end; i += kSelectThreads)
    mine += select_row(x, live, s_wanted, i);
  unsigned long long total;
  block_exclusive_sum(mine, total);
  if (threadIdx.x == 0) block_rows[blockIdx.x] = (uint32_t)total;
}

// The wanted rows as (key, row) pairs in row order: block b writes its
// rows after the earlier blocks' (gridDim.x <= kSelectThreads).
__global__ void __launch_bounds__(kSelectThreads)
select_compact(const double* __restrict__ x, const uint8_t* __restrict__ live, long long n,
               long long chunk, const uint32_t* __restrict__ wanted,
               const uint32_t* __restrict__ block_rows, SelectState* __restrict__ st,
               unsigned long long* __restrict__ keys, uint32_t* __restrict__ rows) {
  __shared__ uint32_t s_wanted[kSelectWantedWords];
  __shared__ uint32_t s_warp_rows[kSelectWarps];
  load_wanted(wanted, s_wanted);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long base;
  block_exclusive_sum(threadIdx.x < blockIdx.x ? block_rows[threadIdx.x] : 0, base);
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min(n, begin + chunk);
  unsigned long long key_or = 0, key_and = ~0ull;
  for (long long tile = begin; tile < end; tile += kSelectThreads) {
    const long long i = tile + threadIdx.x;
    const bool take = i < end && select_row(x, live, s_wanted, i);
    const uint32_t ballot = __ballot_sync(0xffffffffu, take);
    if (lane == 0) s_warp_rows[warp] = __popc(ballot);
    __syncthreads();
    uint32_t before = 0, tile_rows = 0;
    for (int w = 0; w < kSelectWarps; ++w) {
      const uint32_t c = s_warp_rows[w];
      before += w < warp ? c : 0;
      tile_rows += c;
    }
    if (take) {
      const long long at = (long long)base + before + __popc(ballot & ((1u << lane) - 1));
      const unsigned long long key = sortable_key64(x[i]);
      keys[at] = key;
      rows[at] = (uint32_t)i;
      key_or |= key;
      key_and &= key;
    }
    base += tile_rows;
    __syncthreads();
  }
  for (int o = 16; o > 0; o >>= 1) {
    key_or |= __shfl_xor_sync(0xffffffffu, key_or, o);
    key_and &= __shfl_xor_sync(0xffffffffu, key_and, o);
  }
  if (lane == 0) {
    if (key_or) atomicOr(&st->key_or, key_or);
    if (~key_and) atomicAnd(&st->key_and, key_and);
  }
}

// Pass p: each block's count of each digit of its pairs, digit-major.
__global__ void __launch_bounds__(kSelectThreads)
select_digit_count(const SelectState* __restrict__ st, int pass,
                   const unsigned long long* __restrict__ keys, long long n,
                   uint32_t* __restrict__ digit_rows) {
  if (!pass_runs(st, pass)) return;
  __shared__ uint32_t s_rows[kSelectDigits];
  const unsigned long long* src = keys + (long long)st->parity[pass] * n;
  const unsigned long long m = st->m;
  const long long chunk = pair_chunk(m);
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min((long long)m, begin + chunk);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kSelectDigits) s_rows[threadIdx.x] = 0;
  __syncthreads();
  for (long long tile = begin; tile < end; tile += kSelectThreads) {
    const long long i = tile + threadIdx.x;
    const bool valid = i < end;
    // a lane past the end takes a digit of its own, so it adds nowhere
    const uint32_t digit =
        valid ? (uint32_t)(src[i] >> (8 * pass)) & 0xFFu : kSelectDigits + lane;
    const uint32_t peers = __match_any_sync(0xffffffffu, digit);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&s_rows[digit], (uint32_t)__popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < kSelectDigits)
    digit_rows[threadIdx.x * gridDim.x + blockIdx.x] = s_rows[threadIdx.x];
}

// Pass p: block d turns digit d's per-block counts into each block's
// first place among the digit's pairs, in place, and writes the digit's
// total. One block a digit; grid <= kSelectThreads.
__global__ void __launch_bounds__(kSelectThreads)
select_digit_scan(SelectState* __restrict__ st, int pass, uint32_t* __restrict__ digit_rows,
                  uint32_t* __restrict__ digit_total, int grid) {
  if (!pass_runs(st, pass)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) st->parity[pass + 1] = st->parity[pass];
    return;
  }
  uint32_t* row = digit_rows + (long long)blockIdx.x * grid;
  unsigned long long total;
  const unsigned long long before =
      block_exclusive_sum(threadIdx.x < grid ? row[threadIdx.x] : 0u, total);
  if (threadIdx.x < grid) row[threadIdx.x] = (uint32_t)before;
  if (threadIdx.x == 0) {
    digit_total[blockIdx.x] = (uint32_t)total;
    if (blockIdx.x == 0) st->parity[pass + 1] = st->parity[pass] ^ 1;
  }
}

// Pass p: each block's pairs to their digit's place, in their order.
__global__ void __launch_bounds__(kSelectThreads)
select_digit_scatter(const SelectState* __restrict__ st, int pass,
                     unsigned long long* __restrict__ keys, uint32_t* __restrict__ rows,
                     long long n, const uint32_t* __restrict__ digit_rows,
                     const uint32_t* __restrict__ digit_total) {
  if (!pass_runs(st, pass)) return;
  __shared__ uint32_t s_base[kSelectDigits];
  __shared__ uint32_t s_tile[kSelectDigits];
  __shared__ uint32_t s_warp[kSelectWarps][kSelectDigits];
  const long long from = st->parity[pass];
  const unsigned long long* src_keys = keys + from * n;
  const uint32_t* src_rows = rows + from * n;
  unsigned long long* dst_keys = keys + (from ^ 1) * n;
  uint32_t* dst_rows = rows + (from ^ 1) * n;
  const unsigned long long m = st->m;
  const long long chunk = pair_chunk(m);
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min((long long)m, begin + chunk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the digit's first place (the smaller digits' pairs) and this block's
  // first place within it
  unsigned long long unused;
  const unsigned long long digit_first =
      block_exclusive_sum(threadIdx.x < kSelectDigits ? digit_total[threadIdx.x] : 0u, unused);
  if (threadIdx.x < kSelectDigits)
    s_base[threadIdx.x] =
        (uint32_t)digit_first + digit_rows[threadIdx.x * gridDim.x + blockIdx.x];
  for (long long tile = begin; tile < end; tile += kSelectThreads) {
    for (int c = threadIdx.x; c < kSelectWarps * kSelectDigits; c += kSelectThreads)
      s_warp[c / kSelectDigits][c % kSelectDigits] = 0;
    const long long i = tile + threadIdx.x;
    const bool valid = i < end;
    unsigned long long key = 0;
    uint32_t row = 0;
    if (valid) {
      key = src_keys[i];
      row = src_rows[i];
    }
    const uint32_t digit = valid ? (uint32_t)(key >> (8 * pass)) & 0xFFu : kSelectDigits + lane;
    const uint32_t peers = __match_any_sync(0xffffffffu, digit);
    const uint32_t rank = __popc(peers & ((1u << lane) - 1));  // among the warp's equal digits
    __syncthreads();
    if (valid && rank == 0) s_warp[warp][digit] = __popc(peers);
    __syncthreads();
    if (threadIdx.x < kSelectDigits) {  // the warps' counts of one digit, scanned
      uint32_t run = 0;
      for (int w = 0; w < kSelectWarps; ++w) {
        const uint32_t c = s_warp[w][threadIdx.x];
        s_warp[w][threadIdx.x] = run;
        run += c;
      }
      s_tile[threadIdx.x] = run;
    }
    __syncthreads();
    if (valid) {
      const long long at = (long long)s_base[digit] + s_warp[warp][digit] + rank;
      dst_keys[at] = key;
      dst_rows[at] = row;
    }
    __syncthreads();
    if (threadIdx.x < kSelectDigits) s_base[threadIdx.x] += s_tile[threadIdx.x];
  }
}

// The value at each rank's place in the sorted pairs, from its row of x.
__global__ void __launch_bounds__(256)
select_gather(const SelectState* __restrict__ st, const double* __restrict__ x,
              const uint32_t* __restrict__ rows, long long n, const uint32_t* __restrict__ pos,
              long long cap, double* __restrict__ sample) {
  const long long j = (long long)blockIdx.x * 256 + threadIdx.x;
  if (j >= cap) return;
  const uint32_t* sorted = rows + (long long)st->parity[kSelectPasses] * n;
  sample[j] = j < (long long)st->kept ? x[sorted[pos[j]]] : 0.0;
}

// K6's scratch, carved from one allocation at `base` (null: sizes only).
struct SelectScratch {
  SelectState* state;
  unsigned long long* cum;
  uint32_t* wanted;
  uint32_t* pos;
  uint32_t* block_rows;
  uint32_t* digit_rows;
  uint32_t* digit_total;
  unsigned long long* keys;  // two buffers of n
  uint32_t* rows;            // two buffers of n
  size_t bytes;
};

SelectScratch select_scratch(void* base, long long n, long long cap, int grid) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) & ~size_t(255);
    return p + here;
  };
  SelectScratch s;
  s.state = reinterpret_cast<SelectState*>(take(sizeof(SelectState)));
  s.cum = reinterpret_cast<unsigned long long*>(take(sizeof(unsigned long long) * kHistBins));
  s.wanted = reinterpret_cast<uint32_t*>(take(sizeof(uint32_t) * kSelectWantedWords));
  s.pos = reinterpret_cast<uint32_t*>(take(sizeof(uint32_t) * cap));
  s.block_rows = reinterpret_cast<uint32_t*>(take(sizeof(uint32_t) * grid));
  s.digit_rows = reinterpret_cast<uint32_t*>(take(sizeof(uint32_t) * kSelectDigits * grid));
  s.digit_total = reinterpret_cast<uint32_t*>(take(sizeof(uint32_t) * kSelectDigits));
  s.keys = reinterpret_cast<unsigned long long*>(take(sizeof(unsigned long long) * 2 * n));
  s.rows = reinterpret_cast<uint32_t*>(take(sizeof(uint32_t) * 2 * n));
  s.bytes = at;
  return s;
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

// offsets: n + 1 int64 into data (UTF-8 bytes); codes: rows int32 entry
// indices, -1 for a null row. entry_classes and entry_packed: n int8 and n
// int32 of scratch; classes and packed: the rows' int8 and int32 outputs.
int dq_dict_strings(const void* offsets, const void* data, long long n,
                    unsigned long long seed, const void* codes, long long rows,
                    void* entry_classes, void* entry_packed, void* classes,
                    void* packed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const long long blocks = (n + kStringsThreads - 1) / kStringsThreads;
    const unsigned grid = (unsigned)(blocks < INT_MAX ? blocks : INT_MAX);
    dict_strings_entries<<<grid, kStringsThreads, 0, s>>>(
        (const long long*)offsets, (const uint8_t*)data, n, seed,
        (int8_t*)entry_classes, (int32_t*)entry_packed);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (rows > 0) {
    const long long blocks = (rows + kStringsThreads - 1) / kStringsThreads;
    const unsigned grid = (unsigned)(blocks < INT_MAX ? blocks : INT_MAX);
    dict_strings_rows<<<grid, kStringsThreads, 0, s>>>(
        (const int32_t*)codes, rows, (const int8_t*)entry_classes,
        (const int32_t*)entry_packed, n, (int8_t*)classes, (int32_t*)packed);
  }
  return (int)cudaGetLastError();
}

// Bytes of dq_hist16_select's scratch for n rows, a sample of cap and
// `grid` blocks (the wrapper's select_grid).
long long dq_hist16_select_scratch(long long n, long long cap, int grid) {
  return (long long)select_scratch(nullptr, n, cap, grid).bytes;
}

// x: n doubles, live: n bools, counts: hist16's 65536 int32 counts of the
// same rows. sample: cap doubles, zero past the kept ranks; stats: n and
// the level, as 2 doubles. scratch: dq_hist16_select_scratch bytes,
// 256-byte aligned. 1 <= grid <= kSelectThreads.
int dq_hist16_select(const void* x, const void* live, long long n, const void* counts,
                     long long cap, int grid, void* scratch, void* sample, void* stats,
                     void* stream) {
  if (grid < 1 || grid > kSelectThreads || cap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const SelectScratch w = select_scratch(scratch, n, cap, grid);
  const double* xd = (const double*)x;
  const uint8_t* lv = (const uint8_t*)live;
  const long long share = (n + grid - 1) / grid;
  const long long chunk = (share + kSelectThreads - 1) / kSelectThreads * kSelectThreads;
  select_plan<<<1, kSelectThreads, 0, s>>>((const int32_t*)counts, cap, w.state, w.cum,
                                           w.wanted, w.pos, (double*)stats);
  select_count<<<grid, kSelectThreads, 0, s>>>(xd, lv, n, chunk, w.wanted, w.block_rows);
  select_compact<<<grid, kSelectThreads, 0, s>>>(xd, lv, n, chunk, w.wanted, w.block_rows,
                                                 w.state, w.keys, w.rows);
  for (int pass = 0; pass < kSelectPasses; ++pass) {
    select_digit_count<<<grid, kSelectThreads, 0, s>>>(w.state, pass, w.keys, n, w.digit_rows);
    select_digit_scan<<<kSelectDigits, kSelectThreads, 0, s>>>(w.state, pass, w.digit_rows,
                                                               w.digit_total, grid);
    select_digit_scatter<<<grid, kSelectThreads, 0, s>>>(w.state, pass, w.keys, w.rows, n,
                                                         w.digit_rows, w.digit_total);
  }
  select_gather<<<(unsigned)((cap + 255) / 256), 256, 0, s>>>(w.state, xd, w.rows, n, w.pos,
                                                               cap, (double*)sample);
  return (int)cudaGetLastError();
}

}  // extern "C"
