// Design probe of the port's K3 and K4 kernels (tools/torch_kernel_probe.py).
// It includes the shipped kernels and adds two kernels the library has no
// use for: hist16_count with another flush, and a kernel that only loads
// what hll_max loads.
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

}  // extern "C"
