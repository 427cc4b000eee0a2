// Row-wise bitonic sorts for Hopper (sm_90a), with a plain C interface for ctypes.
//
// K1  bitonic_sort_rows(x)            replaces binary_spgemm_tpu/ops/bitonic.py::bitonic_sort_rows
//     Each row of an int32 [k, L] array sorted ascending (signed compares).  Two kernels,
//     chosen by L alone (ops/bitonic.py::k1_variant):
//       "reg"   sort_rows_reg_kernel   129 <= L <= 4096   registers and warp shuffles
//       "smem"  sort_rows_kernel       any other L         the whole network in shared memory
// K2  fused_sort_compress(x, limit)   replaces binary_spgemm_tpu/ops/bitonic.py::fused_sort_compress
//     Sort the row; keep an entry if it differs from its left neighbour (position 0
//     always) and is below `limit`; set the rest to INT32_MAX; sort again.
// P1  bitonic_network_rows(x, 1)      replaces benchmarks/pallas_sort.py::make_bitonic
// P2  bitonic_network_rows(x, lk0)    replaces benchmarks/ab_wruns.py::make_kernel
//     The same network over rows of a power-of-two length L, run only from the merge of
//     size 2^lk0 on: lk0 = 1 is the whole network (a sort); lk0 = log2(2w) skips the
//     merges that w-aligned sorted runs of alternating direction already satisfy.  K1's
//     two kernels run it, chosen by L as K1 chooses (bitonic_network_rows and
//     bitonic_network_rows_reg); K1 and K2 pass lk0 = 1.  A merge is skipped whole by a
//     test that is the same for every thread of the block, so the guard adds no
//     divergence and no template instantiation.
//
// Design.  The TPU kernel held [B, L] row blocks in VMEM and found bitonic partners
// with two lane rotations per stage.  Here a thread block owns whole rows.  It loads
// them into shared memory, pads each row to the next power of two P with INT32_MAX,
// runs the ascending bitonic network, and writes back the first L entries of each row:
// the padding is the largest value, so those are the sorted row.
//
// sort_rows_kernel (K1 "smem", and K2) runs every step of the network in shared memory
// with __syncthreads between steps: one block owns R rows (R = 1 from L = 2049 up), L
// may be anything from 1 up to 32768 (P * 4 bytes = 128 KB of shared memory).  K2 runs
// the network twice in the same block with the keep/demote pass between them, so the
// row makes one device-memory round trip instead of three.
//
// sort_rows_reg_kernel (K1 "reg", P = 2^8 ... 2^12) keeps the network out of shared
// memory where it can.  One block of 512 threads sorts 4096 slots (4096 / P rows);
// thread t holds the 8 contiguous slots i = 8t + e in registers.  A step with partner
// distance j runs on slot bits: j < 8 (bits 0-2) inside the thread's registers, 8 <= j
// < 256 (bits 3-7, the lane) by __shfl_xor_sync, j >= 256 (bits 8-11, the warp) in
// shared memory, entered once per merge of size >= 512.  At P = 4096 that is 33
// register steps, 35 shuffle steps and 10 shared-memory steps in 4 phases, against 78
// shared-memory steps in sort_rows_kernel.  The network is unrolled at compile time
// (template recursion over the steps), so every register index is a constant.
//
// Bound on this card.  The least work is one read and one write of the array:
// 2 * 4 * k * L bytes over 3.35 TB/s.  Both kernels do log2(P) * (log2(P) + 1) / 2 steps
// of P / 2 compare-exchanges per row, so they are bound by that work (shuffles, compares
// and, in sort_rows_kernel, shared-memory traffic and barriers), not by device memory.
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

// Ascending bitonic network over each P-slot segment of s[0, n), from the merge of size
// 2^log_kk0 on (log_kk0 = 1: the whole network).
__device__ __forceinline__ void bitonic_network(int* s, int log_p, int n, int log_kk0) {
  const int P = 1 << log_p;
  const int pairs = n >> 1;
  for (int kk = 1 << log_kk0; kk <= P; kk <<= 1) {
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
                                 int L, int log_p, int rows_per_block, int log_kk0) {
  extern __shared__ int s[];
  const int n = rows_per_block << log_p;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  load_rows(x, s, k, L, log_p, n, row0);
  bitonic_network(s, log_p, n, log_kk0);
  store_rows(out, s, k, L, log_p, n, row0);
}

__global__ void fused_sort_compress_kernel(const int* __restrict__ x, int* __restrict__ out,
                                           long long k, int L, int log_p, int rows_per_block,
                                           int limit) {
  extern __shared__ int s[];
  const int n = rows_per_block << log_p;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  load_rows(x, s, k, L, log_p, n, row0);
  bitonic_network(s, log_p, n, 1);
  dedup_demote(s, log_p, n, limit);
  bitonic_network(s, log_p, n, 1);
  store_rows(out, s, k, L, log_p, n, row0);
}

// ---- K1 "reg": registers and warp shuffles -------------------------------------------

constexpr int kRegThreads = 512;
constexpr int kRegPerThread = 8;                             // contiguous slots per thread
constexpr int kRegSlots = kRegThreads * kRegPerThread;       // 4096 slots per block
constexpr int kRegMinLogP = 8;                               // P = 256: L from 129
constexpr int kRegMaxLogP = 12;                              // P = 4096: L up to 4096

// Is the merge of size 2^LK ascending at slot i?  Within a row the slot is i & (P - 1);
// the last merge (2^LK == P) is ascending everywhere.
template <int LOG_P, int LK>
__device__ __forceinline__ bool ascending(int i) {
  return LK == LOG_P || (i & (1 << LK)) == 0;
}

__device__ __forceinline__ void order(int& a, int& b, bool up) {
  const int lo = min(a, b), hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// j = 2^LJ < 8: both slots in this thread's registers.
template <int LOG_P, int LK, int LJ>
__device__ __forceinline__ void register_step(int (&r)[kRegPerThread], int t) {
  constexpr int j = 1 << LJ;
#pragma unroll
  for (int e = 0; e < kRegPerThread; ++e) {
    if ((e & j) == 0) order(r[e], r[e | j], ascending<LOG_P, LK>(t * kRegPerThread + e));
  }
}

// 8 <= j < 256: slot bit LJ is lane bit LJ - 3.  Each lane of a pair derives "ascending"
// from its own slots (they agree above bit LJ); the lower lane keeps the min when the
// merge ascends, the upper lane the max.
template <int LOG_P, int LK, int LJ>
__device__ __forceinline__ void shuffle_step(int (&r)[kRegPerThread], int t) {
  constexpr int m = 1 << (LJ - 3);
  const bool lower = (t & m) == 0;
  const bool keep_min = lower == ascending<LOG_P, LK>(t * kRegPerThread);
#pragma unroll
  for (int e = 0; e < kRegPerThread; ++e) {
    const int o = __shfl_xor_sync(0xffffffffu, r[e], m);
    r[e] = keep_min ? min(r[e], o) : max(r[e], o);
  }
}

// j >= 256: across warps, in shared memory; 2048 pairs, 4 per thread, consecutive
// threads on consecutive slots.
template <int LOG_P, int LK, int LJ>
__device__ __forceinline__ void shared_step(int* s, int t) {
  constexpr int j = 1 << LJ;
#pragma unroll
  for (int q = 0; q < kRegSlots / 2 / kRegThreads; ++q) {
    const int p = q * kRegThreads + t;
    const int i = 2 * p - (p & (j - 1));  // lower slot of the pair: bit j clear
    int a = s[i], b = s[i + j];
    order(a, b, ascending<LOG_P, LK>(i));
    s[i] = a;
    s[i + j] = b;
  }
  __syncthreads();
}

// Thread t's 8 slots are two 16-byte words of shared memory.  Threads 4-7 of each
// group of 8 take the two words in the other order, so the 8 threads that share a
// 16-byte access phase touch 8 distinct 16-byte bank groups.
__device__ __forceinline__ void to_shared(const int (&r)[kRegPerThread], int* s, int t) {
  const int h = (t >> 2) & 1;
  int4* w = reinterpret_cast<int4*>(s) + 2 * t;
  const int4 lo = make_int4(r[0], r[1], r[2], r[3]);
  const int4 hi = make_int4(r[4], r[5], r[6], r[7]);
  w[h] = h ? hi : lo;
  w[h ^ 1] = h ? lo : hi;
}

__device__ __forceinline__ void from_shared(int (&r)[kRegPerThread], const int* s, int t) {
  const int h = (t >> 2) & 1;
  const int4* w = reinterpret_cast<const int4*>(s) + 2 * t;
  const int4 a = w[h], b = w[h ^ 1];
  const int4 lo = h ? b : a, hi = h ? a : b;
  r[0] = lo.x, r[1] = lo.y, r[2] = lo.z, r[3] = lo.w;
  r[4] = hi.x, r[5] = hi.y, r[6] = hi.z, r[7] = hi.w;
}

template <int LOG_P, int LK, int LJ>
__device__ __forceinline__ void shared_steps(int* s, int t) {
  shared_step<LOG_P, LK, LJ>(s, t);
  if constexpr (LJ > 8) shared_steps<LOG_P, LK, LJ - 1>(s, t);
}

template <int LOG_P, int LK, int LJ>
__device__ __forceinline__ void lane_steps(int (&r)[kRegPerThread], int t) {
  if constexpr (LJ >= 3) {
    shuffle_step<LOG_P, LK, LJ>(r, t);
  } else {
    register_step<LOG_P, LK, LJ>(r, t);
  }
  if constexpr (LJ > 0) lane_steps<LOG_P, LK, LJ - 1>(r, t);
}

// The merge of size 2^LK: steps j = 2^(LK-1) down to 1.
template <int LOG_P, int LK>
__device__ __forceinline__ void merge(int (&r)[kRegPerThread], int* s, int t) {
  if constexpr (LK - 1 >= 8) {
    // Each thread wrote its own slots and reads back only its own, so the barrier
    // before the shared steps is the only one the round trip needs.
    to_shared(r, s, t);
    __syncthreads();
    shared_steps<LOG_P, LK, LK - 1>(s, t);
    from_shared(r, s, t);
  }
  lane_steps<LOG_P, LK, (LK - 1 < 7 ? LK - 1 : 7)>(r, t);
}

// The merges of size 2^LK ... P, each skipped whole below 2^lk0.  A merge leaves the
// thread's slots in its registers, so a skipped one leaves the next merge's phases as
// they would be: a merge of size >= 512 always enters shared memory from registers.
template <int LOG_P, int LK>
__device__ __forceinline__ void sort_network(int (&r)[kRegPerThread], int* s, int t,
                                             int lk0) {
  if (LK >= lk0) merge<LOG_P, LK>(r, s, t);
  if constexpr (LK < LOG_P) sort_network<LOG_P, LK + 1>(r, s, t, lk0);
}

template <int LOG_P>
__global__ void __launch_bounds__(kRegThreads)
    sort_rows_reg_kernel(const int* __restrict__ x, int* __restrict__ out, long long k, int L,
                         int lk0) {
  __shared__ __align__(16) int s[kRegSlots];
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * (kRegSlots >> LOG_P);
  load_rows(x, s, k, L, LOG_P, kRegSlots, row0);
  int r[kRegPerThread];
  from_shared(r, s, t);
  sort_network<LOG_P, 1>(r, s, t, lk0);
  to_shared(r, s, t);
  __syncthreads();
  store_rows(out, s, k, L, LOG_P, kRegSlots, row0);
}

template <int LOG_P>
cudaError_t launch_reg(const int* x, int* out, long long k, int L, int lk0,
                       cudaStream_t stream) {
  constexpr long long rows = kRegSlots >> LOG_P;
  sort_rows_reg_kernel<LOG_P><<<(unsigned)((k + rows - 1) / rows), kRegThreads, 0, stream>>>(
      x, out, k, L, lk0);
  return cudaGetLastError();
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

// K1 "smem" over rows of any L up to kMaxPow2, from the merge of size 2^log_kk0 on.
cudaError_t launch_smem(const void* x, void* out, long long k, int L, int log_kk0,
                        void* stream) {
  Launch p;
  if (!plan_launch(k, L, &p)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(sort_rows_kernel, p.smem);
  if (err != cudaSuccess) return err;
  sort_rows_kernel<<<p.grid, p.block, p.smem, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, k, L, p.log_p, p.rows_per_block, log_kk0);
  return cudaGetLastError();
}

// K1 "reg": 129 <= L <= 4096 only (rows padded to P = 2^8 ... 2^12).
cudaError_t launch_reg_any(const void* x, void* out, long long k, int L, int lk0,
                           void* stream) {
  if (k <= 0 || L <= (1 << (kRegMinLogP - 1)) || L > (1 << kRegMaxLogP))
    return cudaErrorInvalidValue;
  int log_p = 0;
  while ((1 << log_p) < L) ++log_p;
  const int* xi = (const int*)x;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (log_p) {
    case 8: return launch_reg<8>(xi, o, k, L, lk0, st);
    case 9: return launch_reg<9>(xi, o, k, L, lk0, st);
    case 10: return launch_reg<10>(xi, o, k, L, lk0, st);
    case 11: return launch_reg<11>(xi, o, k, L, lk0, st);
    default: return launch_reg<12>(xi, o, k, L, lk0, st);
  }
}

// The network kernels take rows of a power-of-two length only, and a first merge
// 2^log_kk0 with 1 <= log_kk0 <= 16 (past log2(L) no merge runs: a copy).
bool network_args(int L, int log_kk0) {
  return L > 0 && (L & (L - 1)) == 0 && log_kk0 >= 1 && log_kk0 <= 16;
}

}  // namespace

extern "C" int bitonic_sort_rows(const void* x, void* out, long long k, int L, void* stream) {
  return (int)launch_smem(x, out, k, L, 1, stream);
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

extern "C" int bitonic_sort_rows_reg(const void* x, void* out, long long k, int L,
                                     void* stream) {
  return (int)launch_reg_any(x, out, k, L, 1, stream);
}

// P1/P2 through K1's shared-memory kernel (the L that k1_variant gives "smem").
extern "C" int bitonic_network_rows(const void* x, void* out, long long k, int L, int log_kk0,
                                    void* stream) {
  if (!network_args(L, log_kk0)) return (int)cudaErrorInvalidValue;
  return (int)launch_smem(x, out, k, L, log_kk0, stream);
}

// P1/P2 through K1's register kernel (128 < L <= 4096).
extern "C" int bitonic_network_rows_reg(const void* x, void* out, long long k, int L,
                                        int log_kk0, void* stream) {
  if (!network_args(L, log_kk0)) return (int)cudaErrorInvalidValue;
  return (int)launch_reg_any(x, out, k, L, log_kk0, stream);
}
