// Row-wise bitonic sorts for Hopper (sm_90a), with a plain C interface for ctypes.
//
// K1  bitonic_sort_rows(x)            replaces binary_spgemm_tpu/ops/bitonic.py::bitonic_sort_rows
//     Each row of an int32 [k, L] array sorted ascending (signed compares).  Three
//     kernels, chosen by L alone (ops/bitonic.py::k1_variant):
//       "warp"  sort_rows_warp_kernel   1 <= L <= 128        one warp a row: registers
//                                                            and warp shuffles only
//       "reg"   sort_rows_reg_kernel    129 <= L <= 4096     registers and warp shuffles
//       "wide"  sort_rows_wide_kernel   4097 <= L <= 32768   one row a block: registers,
//                                                            shuffles, shared memory
//                                                            across warps
//     and the yardstick they are timed against, launched by no path:
//       "smem"  sort_rows_kernel        1 <= L <= 32768      the whole network in shared
//                                                            memory
//     The TPU kernel takes L = 4096 only; the JAX package sorts longer rows with lax.sort.
// K2  fused_sort_compress(x, limit)   replaces binary_spgemm_tpu/ops/bitonic.py::fused_sort_compress
//     Sort the row; keep an entry if it differs from its left neighbour (position 0
//     always) and is below `limit`; set the rest to INT32_MAX; sort again.  After the
//     first sort the kept entries are ascending and distinct and every other entry
//     becomes INT32_MAX, so the second sort's result is the kept entries packed to the
//     front of the row in the same order, then INT32_MAX up to L: a stream compaction.
//     K2 is K1's kernel for the row's window (the same k1_variant) with the kCompress
//     epilogue in place of the store, on the sorted slots still in registers: the keep
//     mask (a slot's left neighbour is in the same thread's registers, except for its
//     first slot's: from the lane before by __shfl_up_sync in the warp kernel, from
//     shared memory, which holds the sorted row for the store, in the block kernels),
//     an exclusive scan of the kept counts over the row's threads (shuffles in a warp,
//     shared memory across the warps of a row), then the kept values written to their
//     packed places and INT32_MAX from the row's count to L.  The earlier design,
//     fused_sort_compress_kernel (two whole networks in shared memory with a dedup pass
//     between), is the "smem" yardstick, launched by no path.
// P1  bitonic_network_rows(x, 1)      replaces benchmarks/pallas_sort.py::make_bitonic
// P2  bitonic_network_rows(x, lk0)    replaces benchmarks/ab_wruns.py::make_kernel
//     The same network over rows of a power-of-two length L, run only from the merge of
//     size 2^lk0 on: lk0 = 1 is the whole network (a sort); lk0 = log2(2w) skips the
//     merges that w-aligned sorted runs of alternating direction already satisfy.  K1's
//     kernels run it, chosen by L as K1 chooses (bitonic_network_rows_warp,
//     bitonic_network_rows_reg and bitonic_network_rows_wide); K1 and K2 pass
//     lk0 = 1.  A merge is skipped whole by a test that is the same for every thread
//     of the block, so the guard adds no divergence and no template instantiation.
//
// Design.  The TPU kernel held [B, L] row blocks in VMEM and found bitonic partners
// with two lane rotations per stage.  Here a warp or a thread block owns whole rows,
// pads each row to the next power of two P with INT32_MAX, runs the ascending bitonic
// network, and writes back the first L entries of each row: the padding is the largest
// value, so those are the sorted row.
//
// sort_rows_kernel (the "smem" yardstick, K1's earlier design) runs every step of the network in
// shared memory with __syncthreads between steps: one block owns R rows (R = 1 from L =
// 2049 up), L may be anything from 1 up to 32768 (P * 4 bytes = 128 KB of shared
// memory).  fused_sort_compress_kernel runs it twice in the same block with the
// keep/demote pass between them.
//
// sort_rows_warp_kernel (K1 "warp", P = 2^0 ... 2^7) holds a row in one warp's
// registers: lane l holds the N = max(1, P / 32) contiguous slots N l + e of its warp's
// slots (one row from P = 32 up, 32 / P rows below), partner distances below N run
// inside the lane and the rest by __shfl_xor_sync, so it uses no shared memory and no
// barrier.  Steps by place at P = 128: 13 register, 15 shuffle; P = 64: 6 register, 15
// shuffle; P <= 32: every step a shuffle.  A block is 8 independent warps.  Rows whose
// start is (4 N)-byte aligned (L % N == 0) load and store N slots a lane as one vector.
// Its time goes to instructions (a few a slot and step), so K1 and K2 run the wide
// kernel's all-ascending form, which has no direction selects (chip_smoke.py times it
// beside the alternating form, the network's, at [65536, 128]).
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
// sort_rows_wide_kernel (K1 "wide", P = 2^13 ... 2^15) carries the register kernel's
// placement to one row a block: thread t holds N contiguous slots, partner distances
// below N run inside the thread, the next five bits by __shfl_xor_sync, the warp bits in
// shared memory, entered once per merge that reaches them.  Steps by place, for each
// block shape (threads x slots a thread) built (launch_wide; ops/bitonic.py::wide_block
// picks one by L):
//   P = 8192: 512 x 16, 46 register, 35 shuffle, 10 shared-memory steps in 4 phases
//   P = 8192: 256 x 32, 55 register, 30 shuffle, 6 shared-memory steps in 3 phases
//   P = 16384: 512 x 32, 60 register, 35 shuffle, 10 shared-memory steps in 4 phases
//   P = 16384: 1024 x 16, 50 register, 40 shuffle, 15 shared-memory steps in 5 phases
//   P = 32768: 1024 x 32, 65 register, 40 shuffle, 15 shared-memory steps in 5 phases
//   P = 32768: 512 x 64, 75 register, 35 shuffle, 10 shared-memory steps in 4 phases
// against 91, 105 and 120 shared-memory steps in sort_rows_kernel.  It runs the
// all-ascending form of the network (each merge opens by comparing a slot with its
// mirror), in which the INT32_MAX padding never moves, so it neither loads, stores nor
// sorts the padding: a warp whose slots all lie at or past L skips every register and
// shuffle step, and a shared step skips a pair whose upper slot does.  Rows of 4352
// slots cost about 4352 / 8192 of a full row's register and shuffle work.  A 16-byte
// word swizzle keeps the round trips and the shared steps free of bank conflicts.
//
// Bound on this card.  The least work is one read and one write of the array:
// 2 * 4 * k * L bytes over 3.35 TB/s.  The kernels do log2(P) * (log2(P) + 1) / 2 steps
// of P / 2 compare-exchanges per row, so they are bound by that work (shuffles and
// shared-memory accesses, which share one pipe, integer compares and barriers), not by
// device memory.  K2's epilogue adds O(P) work a row to one sort.
//
// Every entry point returns cudaGetLastError() after its launch; 0 means launched.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBlockSlots = 4096;  // a block holds at least this many slots when rows are short
constexpr int kMaxPow2 = 32768;    // longest padded row: 128 KB of shared memory

// A launch above 48 KB of dynamic shared memory must first raise the kernel's limit
// (an attribute of the current device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

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

// ---- K2's epilogue, shared by the warp, register and wide kernels --------------------

// Bit e: keep slot e of a thread's N sorted slots: it is the first slot of its row
// (`first`, for e = 0) or differs from its left neighbour (`left`, the slot before the
// thread's first), and it is below `limit`.  INT32_MAX is never below an int32 limit,
// so the padding is never kept.
template <int N>
__device__ __forceinline__ unsigned keep_mask(const int (&r)[N], int left, bool first,
                                              int limit) {
  static_assert(N <= 32, "a thread's keep mask is 32 bits");
  unsigned keep = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const bool differs = e ? r[e] != r[e - 1] : (first || r[0] != left);
    keep |= (unsigned)(differs && r[e] < limit) << e;
  }
  return keep;
}

// Inclusive sum of v over aligned groups of WIDTH lanes.
template <int WIDTH>
__device__ __forceinline__ int inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < WIDTH; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d, WIDTH);
    if ((lane & (WIDTH - 1)) >= d) v += o;
  }
  return v;
}

// The kept slots of a thread to their packed places put(p, value), p = from, from + 1, ...
template <int N, typename Put>
__device__ __forceinline__ void scatter_kept(const int (&r)[N], unsigned keep, int from,
                                             Put put) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (keep >> e & 1) put(from++, r[e]);
  }
}

// store_rows for K2: column c of a row is its packed slot below the row's kept count,
// INT32_MAX from there to L.
__device__ __forceinline__ void store_packed(int* __restrict__ out, const int* s,
                                             const int* row_kept, long long k, int L,
                                             int log_p, int n, long long row0) {
  const int P = 1 << log_p;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const long long row = row0 + (e >> log_p);
    const int c = e & (P - 1);
    if (c < L && row < k) out[row * L + c] = c < row_kept[e >> log_p] ? s[e] : INT_MAX;
  }
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

// kCompress: K2.  A row is P / 8 >= 32 threads, so whole warps; the left neighbour of a
// thread's first slot is read back from shared memory, where the sorted slots are.
template <int LOG_P, bool kCompress>
__global__ void __launch_bounds__(kRegThreads)
    sort_rows_reg_kernel(const int* __restrict__ x, int* __restrict__ out, long long k, int L,
                         int lk0, int limit) {
  __shared__ __align__(16) int s[kRegSlots];
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * (kRegSlots >> LOG_P);
  load_rows(x, s, k, L, LOG_P, kRegSlots, row0);
  int r[kRegPerThread];
  from_shared(r, s, t);
  sort_network<LOG_P, 1>(r, s, t, lk0);
  to_shared(r, s, t);
  __syncthreads();
  if constexpr (kCompress) {
    constexpr int kRowThreads = (1 << LOG_P) / kRegPerThread;
    constexpr int kRowWarps = kRowThreads / 32;
    __shared__ int warp_kept[kRegThreads / 32];
    __shared__ int row_kept[kRegSlots >> kRegMinLogP];
    const int lane = t & 31, warp = t >> 5;
    const bool first = (t & (kRowThreads - 1)) == 0;
    const unsigned keep =
        keep_mask(r, first ? 0 : s[kRegPerThread * t - 1], first, limit);
    const int kept = __popc(keep);
    const int inc = inclusive_sum<32>(kept, lane);
    if (lane == 31) warp_kept[warp] = inc;
    __syncthreads();  // every left neighbour read, every warp's count written
    const int w0 = warp & ~(kRowWarps - 1);
    int before = inc - kept, total = 0;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) {
      const int v = warp_kept[w0 + w];
      total += v;
      if (w0 + w < warp) before += v;
    }
    int* row_s = s + ((kRegPerThread * t) & ~((1 << LOG_P) - 1));
    scatter_kept(r, keep, before, [&](int p, int v) { row_s[p] = v; });
    if (first) row_kept[t / kRowThreads] = total;
    __syncthreads();
    store_packed(out, s, row_kept, k, L, LOG_P, kRegSlots, row0);
  } else {
    store_rows(out, s, k, L, LOG_P, kRegSlots, row0);
  }
}

template <int LOG_P, bool kCompress>
cudaError_t launch_reg(const int* x, int* out, long long k, int L, int lk0, int limit,
                       cudaStream_t stream) {
  constexpr long long rows = kRegSlots >> LOG_P;
  sort_rows_reg_kernel<LOG_P, kCompress>
      <<<(unsigned)((k + rows - 1) / rows), kRegThreads, 0, stream>>>(x, out, k, L, lk0, limit);
  return cudaGetLastError();
}

// ---- K1 "wide": one row a block, registers, shuffles and shared memory ---------------
//
// Rows of 4097 <= L <= 32768 slots, padded to P = 2^13 ... 2^15.  One block of T =
// P / N threads sorts one row; thread t holds the N contiguous slots i = N t + e in
// registers (the caller picks N).  A step with partner distance 2^LJ runs on
// slot bits: LJ < LOG_N inside the thread, LOG_N <= LJ < LOG_N + 5 (the lane) by
// __shfl_xor_sync, LJ >= LOG_N + 5 (the warp) in shared memory, entered once per merge
// that has such steps.
//
// kSort (K1) runs the all-ascending form of the network: the merge of size 2^LK first
// compares slot i with its mirror i ^ (2^LK - 1), then i with i ^ 2^LJ, and every
// compare-exchange keeps the minimum in the lower slot.  A slot at or past L then holds
// INT32_MAX from load to store and every compare-exchange that touches it is a no-op,
// so the kernel neither loads nor stores the padding: a warp whose slots all lie at or
// past L skips every register and shuffle step (the test is the same for all its
// lanes), a shared-memory pair whose upper slot lies at or past L is neither read nor
// written, and a thread takes INT32_MAX for a slot past L without reading it.
// !kSort (P1/P2) runs the alternating form over rows of exactly P slots (no padding)
// from the merge of size 2^lk0 on, as the other two kernels do.

constexpr int kWideMinLogP = 13;  // L from 4097
constexpr int kWideMaxLogP = 15;  // L up to 32768

// Shared-memory word of slot i: bits 2-4 of i XOR-ed with three bits at or above bit 5
// (bit max(5, LOG_N) up).  It permutes the 16-byte words inside each aligned run of 32
// slots, so a warp's 32 consecutive slots still fill the 32 banks once, and the 8
// threads of a 16-byte access phase that each take word c of their own N slots reach 8
// distinct 16-byte bank groups.
template <int LOG_N>
__device__ __forceinline__ int swz(int i) {
  constexpr int kShift = LOG_N > 5 ? LOG_N : 5;
  return i ^ (((i >> kShift) & 7) << 2);
}

template <int LOG_N>
__device__ __forceinline__ void wide_to_shared(const int (&r)[1 << LOG_N], int* s, int t) {
#pragma unroll
  for (int c = 0; c < (1 << LOG_N) / 4; ++c) {
    *reinterpret_cast<int4*>(s + swz<LOG_N>((t << LOG_N) + 4 * c)) =
        make_int4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
  }
}

template <int LOG_N>
__device__ __forceinline__ void wide_from_shared(int (&r)[1 << LOG_N], const int* s, int t) {
#pragma unroll
  for (int c = 0; c < (1 << LOG_N) / 4; ++c) {
    const int4 w = *reinterpret_cast<const int4*>(s + swz<LOG_N>((t << LOG_N) + 4 * c));
    r[4 * c] = w.x, r[4 * c + 1] = w.y, r[4 * c + 2] = w.z, r[4 * c + 3] = w.w;
  }
}

__device__ __forceinline__ void keep_min_low(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// LJ < LOG_N: both slots in this thread's registers.  The first step of a kSort merge
// pairs e with its mirror e ^ (2^LK - 1) inside the thread (LK <= LOG_N).
template <int LOG_P, int LOG_N, bool kSort, int LK, int LJ>
__device__ __forceinline__ void wide_register_step(int (&r)[1 << LOG_N], int t) {
  constexpr int j = 1 << LJ;
  constexpr bool kMirror = kSort && LJ == LK - 1;
#pragma unroll
  for (int e = 0; e < (1 << LOG_N); ++e) {
    if ((e & j) != 0) continue;
    if constexpr (kMirror) {
      keep_min_low(r[e], r[e ^ ((1 << LK) - 1)]);
    } else if constexpr (kSort) {
      keep_min_low(r[e], r[e | j]);
    } else {
      order(r[e], r[e | j], ascending<LOG_P, LK>((t << LOG_N) + e));
    }
  }
}

// LOG_N <= LJ < LOG_N + 5: slot bit LJ is lane bit LJ - LOG_N.  The lower lane of a
// pair keeps the min when the merge ascends at its slots, the upper lane the max.  The
// first step of a kSort merge pairs slot e of a lane with slot N - 1 - e of the lane
// whose bits below LK - LOG_N are flipped, so both of a pair's shuffles go out before
// either register changes.
template <int LOG_P, int LOG_N, bool kSort, int LK, int LJ>
__device__ __forceinline__ void wide_shuffle_step(int (&r)[1 << LOG_N], int t) {
  constexpr int N = 1 << LOG_N;
  const bool lower = (t & (1 << (LJ - LOG_N))) == 0;
  if constexpr (kSort && LJ == LK - 1 && N == 1) {
    const int o = __shfl_xor_sync(0xffffffffu, r[0], (1 << LK) - 1);
    r[0] = lower ? min(r[0], o) : max(r[0], o);
  } else if constexpr (kSort && LJ == LK - 1) {
    constexpr int m = (1 << (LK - LOG_N)) - 1;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int a = __shfl_xor_sync(0xffffffffu, r[N - 1 - e], m);
      const int b = __shfl_xor_sync(0xffffffffu, r[e], m);
      r[e] = lower ? min(r[e], a) : max(r[e], a);
      r[N - 1 - e] = lower ? min(r[N - 1 - e], b) : max(r[N - 1 - e], b);
    }
  } else {
    constexpr int m = 1 << (LJ - LOG_N);
    const bool keep_min = kSort ? lower : lower == ascending<LOG_P, LK>(t << LOG_N);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int o = __shfl_xor_sync(0xffffffffu, r[e], m);
      r[e] = keep_min ? min(r[e], o) : max(r[e], o);
    }
  }
}

// LJ >= LOG_N + 5: across warps, in shared memory; P / 2 pairs, N / 2 a thread,
// consecutive threads on consecutive lower slots.  kSort skips a pair whose upper slot
// lies at or past L (a no-op), reading and writing neither slot.
template <int LOG_P, int LOG_N, bool kSort, int LK, int LJ>
__device__ __forceinline__ void wide_shared_step(int* s, int t, int L) {
  constexpr int T = 1 << (LOG_P - LOG_N);
  constexpr int j = 1 << LJ;
  constexpr bool kMirror = kSort && LJ == LK - 1;
#pragma unroll
  for (int q = 0; q < (1 << LOG_N) / 2; ++q) {
    const int p = q * T + t;
    const int i = 2 * p - (p & (j - 1));  // lower slot of the pair: bit LJ clear
    const int u = kMirror ? i ^ ((1 << LK) - 1) : i + j;
    if (kSort && u >= L) continue;
    int a = s[swz<LOG_N>(i)], b = s[swz<LOG_N>(u)];
    if constexpr (kSort) {
      keep_min_low(a, b);
    } else {
      order(a, b, ascending<LOG_P, LK>(i));
    }
    s[swz<LOG_N>(i)] = a;
    s[swz<LOG_N>(u)] = b;
  }
  __syncthreads();
}

template <int LOG_P, int LOG_N, bool kSort, int LK, int LJ>
__device__ __forceinline__ void wide_shared_steps(int* s, int t, int L) {
  wide_shared_step<LOG_P, LOG_N, kSort, LK, LJ>(s, t, L);
  if constexpr (LJ > LOG_N + 5) wide_shared_steps<LOG_P, LOG_N, kSort, LK, LJ - 1>(s, t, L);
}

template <int LOG_P, int LOG_N, bool kSort, int LK, int LJ>
__device__ __forceinline__ void wide_lane_steps(int (&r)[1 << LOG_N], int t) {
  if constexpr (LJ >= LOG_N) {
    wide_shuffle_step<LOG_P, LOG_N, kSort, LK, LJ>(r, t);
  } else {
    wide_register_step<LOG_P, LOG_N, kSort, LK, LJ>(r, t);
  }
  if constexpr (LJ > 0) wide_lane_steps<LOG_P, LOG_N, kSort, LK, LJ - 1>(r, t);
}

// The merge of size 2^LK.  `active`: this warp holds a slot below L (always, for
// !kSort); an idle warp still reaches every barrier.
template <int LOG_P, int LOG_N, bool kSort, int LK>
__device__ __forceinline__ void wide_merge(int (&r)[1 << LOG_N], int* s, int t, int L,
                                           bool active) {
  constexpr int kLane = LOG_N + 5;  // first warp bit of the slot
  if constexpr (LK - 1 >= kLane) {
    // Each thread writes its own slots and reads back only its own, so the barrier
    // before the shared steps is the only one the round trip needs.
    if (active) wide_to_shared<LOG_N>(r, s, t);
    __syncthreads();
    wide_shared_steps<LOG_P, LOG_N, kSort, LK, LK - 1>(s, t, L);
    if (active) wide_from_shared<LOG_N>(r, s, t);
  }
  if (active) wide_lane_steps<LOG_P, LOG_N, kSort, LK, (LK - 1 < kLane ? LK - 1 : kLane - 1)>(r, t);
}

template <int LOG_P, int LOG_N, bool kSort, int LK>
__device__ __forceinline__ void wide_network(int (&r)[1 << LOG_N], int* s, int t, int L,
                                             bool active, int lk0) {
  if (LK >= lk0) wide_merge<LOG_P, LOG_N, kSort, LK>(r, s, t, L, active);
  if constexpr (LK < LOG_P) wide_network<LOG_P, LOG_N, kSort, LK + 1>(r, s, t, L, active, lk0);
}

// kCompress (with kSort): K2.  The row is the whole block; an idle warp keeps nothing.
template <int LOG_P, int LOG_N, bool kSort, bool kCompress>
__global__ void __launch_bounds__(1 << (LOG_P - LOG_N))
    sort_rows_wide_kernel(const int* __restrict__ x, int* __restrict__ out, int L, int lk0,
                          int limit) {
  constexpr int N = 1 << LOG_N, T = 1 << (LOG_P - LOG_N);
  extern __shared__ __align__(16) int ws[];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * L;
  for (int c = t; c < L; c += T) ws[swz<LOG_N>(c)] = x[base + c];  // slots below L only
  __syncthreads();
  const bool active = kSort ? ((t & ~31) << LOG_N) < L : true;  // the warp's first slot
  int r[N];
  if (active) {
    wide_from_shared<LOG_N>(r, ws, t);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if ((t << LOG_N) + e >= L) r[e] = INT_MAX;  // the padding, never read
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) r[e] = INT_MAX;
  }
  wide_network<LOG_P, LOG_N, kSort, 1>(r, ws, t, L, active, lk0);
  if (active) wide_to_shared<LOG_N>(r, ws, t);
  __syncthreads();
  if constexpr (kCompress) {
    static_assert(kSort, "K2 runs the all-ascending form");
    __shared__ int warp_kept[32];
    const int lane = t & 31, warp = t >> 5;
    const unsigned keep =
        active ? keep_mask(r, t ? ws[swz<LOG_N>((t << LOG_N) - 1)] : 0, t == 0, limit) : 0u;
    const int kept = __popc(keep);
    const int inc = inclusive_sum<32>(kept, lane);
    if (lane == 31) warp_kept[warp] = inc;
    __syncthreads();  // every left neighbour read, every warp's count written
    int before = inc - kept, total = 0;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) {
      const int v = warp_kept[w];
      total += v;
      if (w < warp) before += v;
    }
    scatter_kept(r, keep, before, [&](int p, int v) { ws[swz<LOG_N>(p)] = v; });
    __syncthreads();
    for (int c = t; c < L; c += T) out[base + c] = c < total ? ws[swz<LOG_N>(c)] : INT_MAX;
  } else {
    for (int c = t; c < L; c += T) out[base + c] = ws[swz<LOG_N>(c)];
  }
}

template <int LOG_P, int LOG_N, bool kSort, bool kCompress = false>
cudaError_t launch_wide_shape(const int* x, int* out, long long k, int L, int lk0, int limit,
                              cudaStream_t stream) {
  constexpr size_t smem = sizeof(int) << LOG_P;
  const auto kernel = sort_rows_wide_kernel<LOG_P, LOG_N, kSort, kCompress>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)k, 1 << (LOG_P - LOG_N), smem, stream>>>(x, out, L, lk0, limit);
  return cudaGetLastError();
}

// K1 "wide" (kSort) for 4097 <= L <= 32768, or the network (!kSort) over rows of
// L = 8192, 16384 or 32768 from the merge of size 2^lk0 on, with thread blocks of
// P / 2^log_n threads holding 2^log_n slots each.  The caller picks log_n
// (ops/bitonic.py::wide_block, from the times of benchmarks/k1_wide_shapes.py); the
// switches below are the block shapes built, and any other is refused.  The network
// form's direction selects take more registers: it spills at 512 x 32 (P = 16384)
// and 1024 x 32 (P = 32768), so it is built at 1024 x 16 and 512 x 64 there.  K2
// (kCompress) is built at the K1 shapes that wide_block picks.
template <bool kSort, bool kCompress>
cudaError_t launch_wide(const void* x, void* out, long long k, int L, int lk0, int limit,
                        int log_n, void* stream) {
  if (k <= 0 || k > INT_MAX || L <= (1 << (kWideMinLogP - 1)) || L > (1 << kWideMaxLogP) ||
      log_n < 0 || log_n > 7)
    return cudaErrorInvalidValue;
  int log_p = 0;
  while ((1 << log_p) < L) ++log_p;
  if (!kSort && L != (1 << log_p)) return cudaErrorInvalidValue;
  const int* xi = (const int*)x;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (kCompress) {
    switch (log_p * 8 + log_n) {
      case 13 * 8 + 4: return launch_wide_shape<13, 4, true, true>(xi, o, k, L, 1, limit, st);
      case 13 * 8 + 5: return launch_wide_shape<13, 5, true, true>(xi, o, k, L, 1, limit, st);
      case 14 * 8 + 5: return launch_wide_shape<14, 5, true, true>(xi, o, k, L, 1, limit, st);
      case 15 * 8 + 5: return launch_wide_shape<15, 5, true, true>(xi, o, k, L, 1, limit, st);
    }
  } else if constexpr (kSort) {
    switch (log_p * 8 + log_n) {
      case 13 * 8 + 4: return launch_wide_shape<13, 4, true>(xi, o, k, L, lk0, 0, st);
      case 13 * 8 + 5: return launch_wide_shape<13, 5, true>(xi, o, k, L, lk0, 0, st);
      case 14 * 8 + 4: return launch_wide_shape<14, 4, true>(xi, o, k, L, lk0, 0, st);
      case 14 * 8 + 5: return launch_wide_shape<14, 5, true>(xi, o, k, L, lk0, 0, st);
      case 15 * 8 + 5: return launch_wide_shape<15, 5, true>(xi, o, k, L, lk0, 0, st);
      case 15 * 8 + 6: return launch_wide_shape<15, 6, true>(xi, o, k, L, lk0, 0, st);
    }
  } else {
    switch (log_p * 8 + log_n) {
      case 13 * 8 + 5: return launch_wide_shape<13, 5, false>(xi, o, k, L, lk0, 0, st);
      case 14 * 8 + 4: return launch_wide_shape<14, 4, false>(xi, o, k, L, lk0, 0, st);
      case 15 * 8 + 6: return launch_wide_shape<15, 6, false>(xi, o, k, L, lk0, 0, st);
    }
  }
  return cudaErrorInvalidValue;
}

// ---- K1 "warp": one warp a row, in registers -----------------------------------------
//
// Rows of 1 <= L <= 128 slots, padded to P = 2^LOG_P <= 128.  Lane l of a warp holds the
// N = max(1, P / 32) contiguous slots N l + e of the warp's 32 N slots: one row from
// P = 32 up, 32 / P rows below.  Merge 2^LK runs its steps 2^(LK-1) ... 1 as the wide
// kernel's lane steps: slot bits below LOG_N inside the lane, the rest (at most the 5
// lane bits, the row being at most 32 N slots) by __shfl_xor_sync; kSort (K1, K2) in the
// all-ascending form, where the padding, INT32_MAX, stays at the end, !kSort (P1/P2) in
// the alternating form from the merge of size 2^lk0 on.
// kCompress: K2, the row's lanes a segment of the warp, so the keep mask, the scan of
// the kept counts and the row's count are shuffles, and the kept values go straight to
// device memory at their packed places.

constexpr int kWarpThreads = 256;  // 8 independent warps a block
constexpr int kWarpMaxLogP = 7;    // P = 128: L up to 128

template <int N>
__device__ __forceinline__ void load_vec(int (&r)[N], const int* p) {
  if constexpr (N == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else if constexpr (N == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    r[0] = v.x, r[1] = v.y;
  } else {
    r[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(int* p, const int (&r)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(r[0], r[1], r[2], r[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

template <int LOG_P, int LOG_N, bool kSort, int LK>
__device__ __forceinline__ void warp_network(int (&r)[1 << LOG_N], int lane, int lk0) {
  if constexpr (LK <= LOG_P) {
    if (LK >= lk0) wide_lane_steps<LOG_P, LOG_N, kSort, LK, LK - 1>(r, lane);
    warp_network<LOG_P, LOG_N, kSort, LK + 1>(r, lane, lk0);
  }
}

// `vec`: every row starts 4 N-byte aligned (L % N == 0 and aligned arrays), so a lane
// whose first column is below L loads and stores its N slots as one vector.
template <int LOG_P, bool kSort, bool kCompress>
__global__ void __launch_bounds__(kWarpThreads)
    sort_rows_warp_kernel(const int* __restrict__ x, int* __restrict__ out, long long k, int L,
                          int lk0, int limit, bool vec) {
  constexpr int LOG_N = LOG_P > 5 ? LOG_P - 5 : 0, N = 1 << LOG_N;
  constexpr int kRowLanes = (1 << LOG_P) / N;  // 32 from P = 32 up, else P
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  const long long row = warp * (32 / kRowLanes) + lane / kRowLanes;
  const int c0 = (lane & (kRowLanes - 1)) << LOG_N;  // the lane's first column
  const bool live = row < k;                          // rows past k: INT32_MAX, no store
  int r[N];
  if (live && vec && c0 < L) {
    load_vec(r, x + row * L + c0);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) r[e] = live && c0 + e < L ? x[row * L + c0 + e] : INT_MAX;
  }
  warp_network<LOG_P, LOG_N, kSort, 1>(r, lane, lk0);
  if constexpr (kCompress) {
    const int left = __shfl_up_sync(0xffffffffu, r[N - 1], 1);
    const unsigned keep = keep_mask(r, left, c0 == 0, limit);
    const int kept = __popc(keep);
    const int inc = inclusive_sum<kRowLanes>(kept, lane);
    const int total = __shfl_sync(0xffffffffu, inc, kRowLanes - 1, kRowLanes);
    if (!live) return;
    int* o = out + row * L;
    scatter_kept(r, keep, inc - kept, [&](int p, int v) { o[p] = v; });
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (c0 + e >= total && c0 + e < L) o[c0 + e] = INT_MAX;
    }
  } else {
    if (!live) return;
    int* o = out + row * L + c0;
    if (vec) {
      if (c0 < L) store_vec(o, r);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (c0 + e < L) o[e] = r[e];
      }
    }
  }
}

template <int LOG_P, bool kSort, bool kCompress>
cudaError_t launch_warp(const int* x, int* out, long long k, int L, int lk0, int limit,
                        cudaStream_t stream) {
  constexpr int N = LOG_P > 5 ? 1 << (LOG_P - 5) : 1;
  constexpr long long rows = (kWarpThreads / 32) * (32 * N >> LOG_P);
  const long long blocks = (k + rows - 1) / rows;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool vec = L % N == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
                    (4 * N - 1)) == 0;
  sort_rows_warp_kernel<LOG_P, kSort, kCompress>
      <<<(unsigned)blocks, kWarpThreads, 0, stream>>>(x, out, k, L, lk0, limit, vec);
  return cudaGetLastError();
}

// K1 "warp" (and K2, the network) for 1 <= L <= 128.
template <bool kSort, bool kCompress>
cudaError_t launch_warp_any(const void* x, void* out, long long k, int L, int lk0, int limit,
                            void* stream) {
  if (k <= 0 || L <= 0 || L > (1 << kWarpMaxLogP)) return cudaErrorInvalidValue;
  int log_p = 0;
  while ((1 << log_p) < L) ++log_p;
  const int* xi = (const int*)x;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (log_p) {
    case 0: return launch_warp<0, kSort, kCompress>(xi, o, k, L, lk0, limit, st);
    case 1: return launch_warp<1, kSort, kCompress>(xi, o, k, L, lk0, limit, st);
    case 2: return launch_warp<2, kSort, kCompress>(xi, o, k, L, lk0, limit, st);
    case 3: return launch_warp<3, kSort, kCompress>(xi, o, k, L, lk0, limit, st);
    case 4: return launch_warp<4, kSort, kCompress>(xi, o, k, L, lk0, limit, st);
    case 5: return launch_warp<5, kSort, kCompress>(xi, o, k, L, lk0, limit, st);
    case 6: return launch_warp<6, kSort, kCompress>(xi, o, k, L, lk0, limit, st);
    default: return launch_warp<7, kSort, kCompress>(xi, o, k, L, lk0, limit, st);
  }
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

// K1 "smem" (the yardstick) over rows of any L up to kMaxPow2, from the merge of size
// 2^log_kk0 on.
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

// K1 "reg" (and K2, the network): 129 <= L <= 4096 only (rows padded to P = 2^8 ... 2^12).
template <bool kCompress>
cudaError_t launch_reg_any(const void* x, void* out, long long k, int L, int lk0, int limit,
                           void* stream) {
  if (k <= 0 || L <= (1 << (kRegMinLogP - 1)) || L > (1 << kRegMaxLogP))
    return cudaErrorInvalidValue;
  int log_p = 0;
  while ((1 << log_p) < L) ++log_p;
  const int* xi = (const int*)x;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (log_p) {
    case 8: return launch_reg<8, kCompress>(xi, o, k, L, lk0, limit, st);
    case 9: return launch_reg<9, kCompress>(xi, o, k, L, lk0, limit, st);
    case 10: return launch_reg<10, kCompress>(xi, o, k, L, lk0, limit, st);
    case 11: return launch_reg<11, kCompress>(xi, o, k, L, lk0, limit, st);
    default: return launch_reg<12, kCompress>(xi, o, k, L, lk0, limit, st);
  }
}

// The network kernels take rows of a power-of-two length only, and a first merge
// 2^log_kk0 with 1 <= log_kk0 <= 16 (past log2(L) no merge runs: a copy).
bool network_args(int L, int log_kk0) {
  return L > 0 && (L & (L - 1)) == 0 && log_kk0 >= 1 && log_kk0 <= 16;
}

}  // namespace

// K1 "smem", the yardstick.
extern "C" int bitonic_sort_rows(const void* x, void* out, long long k, int L, void* stream) {
  return (int)launch_smem(x, out, k, L, 1, stream);
}

extern "C" int bitonic_sort_rows_warp(const void* x, void* out, long long k, int L,
                                      void* stream) {
  return (int)launch_warp_any<true, false>(x, out, k, L, 1, 0, stream);
}

extern "C" int bitonic_sort_rows_reg(const void* x, void* out, long long k, int L,
                                     void* stream) {
  return (int)launch_reg_any<false>(x, out, k, L, 1, 0, stream);
}

extern "C" int bitonic_sort_rows_wide(const void* x, void* out, long long k, int L,
                                      int log_n, void* stream) {
  return (int)launch_wide<true, false>(x, out, k, L, 1, 0, log_n, stream);
}

// K2 "smem", the earlier design: the yardstick.
extern "C" int fused_sort_compress_smem(const void* x, void* out, long long k, int L,
                                        int limit, void* stream) {
  Launch p;
  if (!plan_launch(k, L, &p)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fused_sort_compress_kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  fused_sort_compress_kernel<<<p.grid, p.block, p.smem, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, k, L, p.log_p, p.rows_per_block, limit);
  return (int)cudaGetLastError();
}

// K2 through K1's kernel for the row's window, with the compaction epilogue.
extern "C" int fused_sort_compress_warp(const void* x, void* out, long long k, int L,
                                        int limit, void* stream) {
  return (int)launch_warp_any<true, true>(x, out, k, L, 1, limit, stream);
}

extern "C" int fused_sort_compress_reg(const void* x, void* out, long long k, int L,
                                       int limit, void* stream) {
  return (int)launch_reg_any<true>(x, out, k, L, 1, limit, stream);
}

extern "C" int fused_sort_compress_wide(const void* x, void* out, long long k, int L,
                                        int limit, int log_n, void* stream) {
  return (int)launch_wide<true, true>(x, out, k, L, 1, limit, log_n, stream);
}

// P1/P2 through K1's shared-memory kernel: the yardstick for the network.
extern "C" int bitonic_network_rows(const void* x, void* out, long long k, int L, int log_kk0,
                                    void* stream) {
  if (!network_args(L, log_kk0)) return (int)cudaErrorInvalidValue;
  return (int)launch_smem(x, out, k, L, log_kk0, stream);
}

// P1/P2 through K1's warp kernel (L <= 128).
extern "C" int bitonic_network_rows_warp(const void* x, void* out, long long k, int L,
                                         int log_kk0, void* stream) {
  if (!network_args(L, log_kk0)) return (int)cudaErrorInvalidValue;
  return (int)launch_warp_any<false, false>(x, out, k, L, log_kk0, 0, stream);
}

// P1/P2 through K1's register kernel (128 < L <= 4096).
extern "C" int bitonic_network_rows_reg(const void* x, void* out, long long k, int L,
                                        int log_kk0, void* stream) {
  if (!network_args(L, log_kk0)) return (int)cudaErrorInvalidValue;
  return (int)launch_reg_any<false>(x, out, k, L, log_kk0, 0, stream);
}

// P1/P2 through K1's wide kernel, in the alternating form (L = 8192, 16384, 32768).
extern "C" int bitonic_network_rows_wide(const void* x, void* out, long long k, int L,
                                         int log_kk0, int log_n, void* stream) {
  if (!network_args(L, log_kk0)) return (int)cudaErrorInvalidValue;
  return (int)launch_wide<false, false>(x, out, k, L, log_kk0, 0, log_n, stream);
}
