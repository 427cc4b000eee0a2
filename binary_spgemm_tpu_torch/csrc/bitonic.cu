// Row-wise bitonic sorts for Hopper (sm_90a), with a plain C interface for ctypes.
//
// K1  bitonic_sort_rows(x)            replaces binary_spgemm_tpu/ops/bitonic.py::bitonic_sort_rows
//     Each row of an int32 [k, L] array sorted ascending (signed compares).
// K2  fused_sort_compress(x, limit)   replaces binary_spgemm_tpu/ops/bitonic.py::fused_sort_compress
//     Sort the row; keep an entry if it differs from its left neighbour (position 0
//     always) and is below `limit`; set the rest to INT32_MAX; sort again.
//
// Design.  The TPU kernel held [B, L] row blocks in VMEM and found bitonic partners
// with two lane rotations per stage.  Here one thread block owns R whole rows
// (R = 1 from L = 2049 up; a few rows per block for short L).  It loads them into
// dynamic shared memory, pads each row to the next power of two P with INT32_MAX,
// runs the bitonic network there with __syncthreads between stages, and writes back
// the first L entries of each row: the padding is the largest value, so those are the
// sorted row.  K2 runs the network twice in the same block with the keep/demote pass
// between them, so the row makes one device-memory round trip instead of three.
// L may be anything from 1 up to 32768 (P * 4 bytes = 128 KB of shared memory).
//
// Bound on this card.  The least work is one read and one write of the array:
// 2 * 4 * k * L bytes over 3.35 TB/s.  The network itself runs in shared memory,
// log2(P) * (log2(P) + 1) / 2 stages of P / 2 compare-exchanges each, so this
// first, simple kernel is bound by shared-memory traffic and stage barriers, not by
// device memory.  Warp-shuffle stages for partner distances below 32, and
// register-resident sub-sorts, are the obvious next steps.
//
// Every entry point returns cudaGetLastError() after its launch; 0 means launched.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBlockSlots = 4096;  // a block holds at least this many slots when rows are short
constexpr int kMaxPow2 = 32768;    // longest padded row: 128 KB of shared memory

__device__ __forceinline__ void load_rows(const int* __restrict__ x, int* s, long long k,
                                          int L, int log_p, int n, long long row0) {
  const int P = 1 << log_p;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const long long row = row0 + (e >> log_p);
    const int c = e & (P - 1);
    s[e] = (c < L && row < k) ? x[row * L + c] : INT_MAX;
  }
  __syncthreads();
}

__device__ __forceinline__ void store_rows(int* __restrict__ out, const int* s, long long k,
                                           int L, int log_p, int n, long long row0) {
  const int P = 1 << log_p;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const long long row = row0 + (e >> log_p);
    const int c = e & (P - 1);
    if (c < L && row < k) out[row * L + c] = s[e];
  }
}

// Ascending bitonic network over each P-slot segment of s[0, n).
__device__ __forceinline__ void bitonic_network(int* s, int log_p, int n) {
  const int P = 1 << log_p;
  const int pairs = n >> 1;
  for (int kk = 2; kk <= P; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < pairs; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));  // lower slot of the pair: bit j clear
        const int a = s[i];
        const int b = s[i + j];
        const bool ascending = ((i & (P - 1)) & kk) == 0;
        if ((a > b) == ascending) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Keep s[e] if it differs from its left neighbour (first slot of a row always) and is
// below `limit`, else set it to INT_MAX.  Chunks of blockDim slots are walked from the
// top down, so no slot is demoted before its right neighbour has read it.
__device__ __forceinline__ void dedup_demote(int* s, int log_p, int n, int limit) {
  const int P = 1 << log_p;
  const int T = blockDim.x;
  for (int c = (n + T - 1) / T - 1; c >= 0; --c) {
    const int e = c * T + threadIdx.x;
    bool keep = true;
    if (e < n) {
      const int v = s[e];
      keep = ((e & (P - 1)) == 0 || v != s[e - 1]) && v < limit;
    }
    __syncthreads();
    if (!keep) s[e] = INT_MAX;
    __syncthreads();
  }
}

__global__ void sort_rows_kernel(const int* __restrict__ x, int* __restrict__ out, long long k,
                                 int L, int log_p, int rows_per_block) {
  extern __shared__ int s[];
  const int n = rows_per_block << log_p;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  load_rows(x, s, k, L, log_p, n, row0);
  bitonic_network(s, log_p, n);
  store_rows(out, s, k, L, log_p, n, row0);
}

__global__ void fused_sort_compress_kernel(const int* __restrict__ x, int* __restrict__ out,
                                           long long k, int L, int log_p, int rows_per_block,
                                           int limit) {
  extern __shared__ int s[];
  const int n = rows_per_block << log_p;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  load_rows(x, s, k, L, log_p, n, row0);
  bitonic_network(s, log_p, n);
  dedup_demote(s, log_p, n, limit);
  bitonic_network(s, log_p, n);
  store_rows(out, s, k, L, log_p, n, row0);
}

struct Launch {
  int log_p;
  int rows_per_block;
  dim3 grid;
  dim3 block;
  size_t smem;
};

// Returns false for shapes the kernels do not take.
bool plan_launch(long long k, int L, Launch* p) {
  if (k <= 0 || L <= 0) return false;
  int log_p = 0;
  while ((1 << log_p) < L) ++log_p;
  const int P = 1 << log_p;
  if (P > kMaxPow2) return false;
  long long r = P >= kBlockSlots ? 1 : kBlockSlots / P;
  if (r > k) r = k;
  const int n = (int)r * P;
  int threads = n / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  threads = ((threads + 31) / 32) * 32;
  p->log_p = log_p;
  p->rows_per_block = (int)r;
  p->grid = dim3((unsigned)((k + r - 1) / r));
  p->block = dim3(threads);
  p->smem = (size_t)n * sizeof(int);
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int bitonic_sort_rows(const void* x, void* out, long long k, int L, void* stream) {
  Launch p;
  if (!plan_launch(k, L, &p)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(sort_rows_kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  sort_rows_kernel<<<p.grid, p.block, p.smem, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, k, L, p.log_p, p.rows_per_block);
  return (int)cudaGetLastError();
}

extern "C" int fused_sort_compress(const void* x, void* out, long long k, int L, int limit,
                                   void* stream) {
  Launch p;
  if (!plan_launch(k, L, &p)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fused_sort_compress_kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  fused_sort_compress_kernel<<<p.grid, p.block, p.smem, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, k, L, p.log_p, p.rows_per_block, limit);
  return (int)cudaGetLastError();
}
