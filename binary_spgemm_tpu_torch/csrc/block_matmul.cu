// Grouped block matmul-accumulate for Hopper (sm_90a), with a plain C interface for ctypes.
//
// K3  grouped_block_matmul   replaces binary_spgemm_tpu/ops/pallas_bsr.py::grouped_block_matmul
//     (kernel `_kernel` :32-44, pallas_call :73).  Pairs i, sorted by output block seg[i], each
//     add A[ka[i]] @ B[kb[i]] into out[seg[i]]: bf16 b x b tiles (0/1 values), f32 counts, so
//     counts are exact and `> 0` is the OR.  Every output block s in [0, n_out) is written, one
//     that no pair visits as zeros.  The TPU's `first` flags are implied by the sorted seg.
//     Pair indices are not range-checked against nA / nB on the host (that would need a host
//     sync per launch); a pair whose ka or kb is out of range is skipped, so no block reads
//     outside the operands.
//
// Bound on this card: bytes.  Each input tile read once and each output tile written once is
// (nA + nB) * b^2 * 2 + n_out * b^2 * 4 bytes (about 106 MB on the blocked-32k-b128 plan:
// 0.0316 ms at 3.35 TB/s), against 2 * npairs * b^3 operations (4.7 GFLOP there: 0.005 ms at
// 989 TFLOP/s).  Two thirds of those bytes are the f32 output.
//
// Two kernels; the wrapper picks one from b and the operands' alignment alone
// (ops/block_matmul.py::k3_variant):
//
// "pipe"  grouped_block_matmul_pipe_kernel<T>, for b a multiple of 8 from 8 to 128 with both
//     tile arrays 16-byte aligned.  The TPU kernel walked the pairs in one sequential grid
//     while its pipeline fetched the next pair's tiles; here that becomes a persistent walk
//     with an asynchronous tile ring:
//     - Persistent grid: G = min(n_out, SMs x blocks per SM) blocks (the wrapper's k3_grid);
//       block c walks the output blocks s = c, c + G, c + 2G, ...  Neighbouring blocks take
//       neighbouring output blocks at the same time, so tiles that one block row shares are
//       read from L2 together.
//     - Ring: S = 2 stages of padded A and B tiles in dynamic shared memory, filled by
//       16-byte cp.async.cg copies (a half-warp per tile row, a pair's 2 b^2 / 8 copies all
//       in flight together), one commit group per pair.  The copies of the walk's pair
//       t + S - 1 are started before the MMAs of pair t, also when it belongs to a later
//       output block; cp.async.wait_group S - 1 and a barrier then hand pair t to the MMAs.
//       The padding around a ragged b is zeroed once, as the copies never write it.  (A
//       third stage, which fits at b = 128, was tried and was not faster.)
//     - MMAs: mma.sync m16n8k16 bf16 products into f32 registers, fed by ldmatrix (B
//       transposed on the way), the 8 warps laid out 2 x 4 over the T x T grid of 16 x 16
//       fragments, so a warp loads each A and each B fragment it needs once per k step (at
//       b = 128: 4 A and 2 B ldmatrix.x4 for 16 MMAs).  wgmma is not used: the plan's
//       tensor-core work is about a sixth of its bytes bound.
//     - Epilogue: at an output block's last pair every thread streams its accumulators
//       straight from registers to out[s] (__stcs, evict-first) as 8-byte stores; the 4
//       threads that share a row write 32 contiguous bytes, so every 32-byte sector is
//       written whole.  No barrier, no staging: the stores drain while the warps go on with
//       the next pair, whose copies are already in flight.  (Staging the tile in shared
//       memory for 16-byte stores or for one bulk TMA copy was tried and was not faster.)
//       An output block with no pair gets 16-byte streaming zero stores alone, when the
//       walk passes it.
//     - Pair ranges: each output block's pair range comes from a binary search in seg; the
//       ranges of 256 output blocks of the walk are searched at once, one per thread, so the
//       searches' dependent loads overlap.
//     - Shared memory at b = 128: 2 x 69,632 bytes of ring and 2,048 of ranges, so one
//       block per SM; the limit is raised once per instantiation and device.
//     - A long pair group runs on one block, its pairs one after another through the ring.
// "simple"  grouped_block_matmul_kernel<T>, every other b from 1 to 128 (and misaligned
//     tiles): one block per output block, pair range by binary search, the tiles loaded
//     synchronously into zero-padded shared memory, wmma products, the f32 tile written once
//     through shared memory.  Nothing overlaps the loads with the MMAs.
//
// Every entry point returns cudaGetLastError() after its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlock = 128;

// First i in [lo, n) with seg[i] >= s, or n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ seg, int lo, int n, int s) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First i in [0, n) with seg[i] >= s, or n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ seg, int n, int s) {
  return lower_bound(seg, 0, n, s);
}

// Copy the contiguous b x b tile `src` into shared memory `dst` (row stride ld); with
// `vec`, 16-byte loads (b a multiple of 8 and both operands 16-byte aligned).
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int b, int ld, bool vec) {
  if (vec) {
    const int per_row = b >> 3;
    const int n = b * per_row;
    const uint4* v = reinterpret_cast<const uint4*>(src);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / per_row;
      const int c = (e - r * per_row) << 3;
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v[e];
    }
  } else {
    const int n = b * b;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / b;
      dst[r * ld + (e - r * b)] = src[e];
    }
  }
}

template <int T>  // the padded tile is 16 T x 16 T
struct Tile {
  static constexpr int kPad = 16 * T;
  static constexpr int kLd = kPad + 8;   // bf16 row stride: rows stay 16-byte aligned
  static constexpr int kLdc = kPad + 4;  // f32 row stride of the staged output
  static constexpr int kFrags = T * T;
  static constexpr int kPerWarp = (kFrags + kWarps - 1) / kWarps;
  static constexpr size_t kOperandBytes = 2ull * kPad * kLd * sizeof(__nv_bfloat16);
  static constexpr size_t kOutBytes = 1ull * kPad * kLdc * sizeof(float);
  static constexpr size_t kSmem = kOperandBytes > kOutBytes ? kOperandBytes : kOutBytes;
};

template <int T>
__global__ void __launch_bounds__(kThreads)
    grouped_block_matmul_kernel(const int* __restrict__ seg, const int* __restrict__ ka,
                                const int* __restrict__ kb, int npairs,
                                const __nv_bfloat16* __restrict__ a,
                                const __nv_bfloat16* __restrict__ bm, long long n_a,
                                long long n_b, float* __restrict__ out, int b, bool vec) {
  using P = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem[];  // the only shared memory
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + P::kPad * P::kLd;
  const int s = blockIdx.x;
  // every thread searches (the same addresses, so the loads broadcast)
  const int lo = lower_bound(seg, npairs, s);
  const int hi = lower_bound(seg, npairs, s + 1);

  if (b != P::kPad) {  // zero the padding once: loads never write it
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n = (int)(P::kOperandBytes / sizeof(uint4));
    for (int e = threadIdx.x; e < n; e += blockDim.x) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const long long tile = (long long)b * b;

  fragment<accumulator, 16, 16, 16, float> acc[P::kPerWarp];
#pragma unroll
  for (int i = 0; i < P::kPerWarp; ++i) nvcuda::wmma::fill_fragment(acc[i], 0.0f);

  for (int p = lo; p < hi; ++p) {
    const long long ia = ka[p];
    const long long ib = kb[p];
    if (ia < 0 || ia >= n_a || ib < 0 || ib >= n_b) continue;  // the same for every thread
    load_tile(a + ia * tile, sa, b, P::kLd, vec);
    load_tile(bm + ib * tile, sb, b, P::kLd, vec);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < P::kPerWarp; ++i) {
      const int f = warp + i * kWarps;
      if (f < P::kFrags) {
        const int fr = f / T;
        const int fc = f - fr * T;
#pragma unroll
        for (int k = 0; k < T; ++k) {
          fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major> fa;
          fragment<matrix_b, 16, 16, 16, __nv_bfloat16, row_major> fb;
          nvcuda::wmma::load_matrix_sync(fa, sa + fr * 16 * P::kLd + k * 16, P::kLd);
          nvcuda::wmma::load_matrix_sync(fb, sb + k * 16 * P::kLd + fc * 16, P::kLd);
          nvcuda::wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
    __syncthreads();  // every warp is done with this pair's tiles
  }

  // stage the f32 tile in shared memory (over the operand tiles), then write the b x b
  // part of it to out[s] with consecutive threads on consecutive addresses
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < P::kPerWarp; ++i) {
    const int f = warp + i * kWarps;
    if (f < P::kFrags) {
      const int fr = f / T;
      const int fc = f - fr * T;
      nvcuda::wmma::store_matrix_sync(sc + fr * 16 * P::kLdc + fc * 16, acc[i], P::kLdc,
                                      mem_row_major);
    }
  }
  __syncthreads();
  float* o = out + (long long)s * tile;
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    const int r = e / b;
    o[e] = sc[r * P::kLdc + (e - r * b)];
  }
}

template <int T>
cudaError_t launch(const int* seg, const int* ka, const int* kb, int npairs,
                   const __nv_bfloat16* a, const __nv_bfloat16* bm, long long n_a,
                   long long n_b, float* out, int n_out, int b, bool vec, cudaStream_t stream) {
  const size_t smem = Tile<T>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_block_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  grouped_block_matmul_kernel<T><<<n_out, kThreads, smem, stream>>>(seg, ka, kb, npairs, a, bm,
                                                                     n_a, n_b, out, b, vec);
  return cudaGetLastError();
}

// ---- "pipe": the persistent kernel with an asynchronous tile ring -------------------------

template <int T>  // the padded tile is 16 T x 16 T
struct PipeTile {
  static constexpr int kPad = 16 * T;
  static constexpr int kLd = kPad + 8;  // bf16 row stride: rows 16-byte aligned, 4 banks apart
  static constexpr int kTileElems = kPad * kLd;
  static constexpr size_t kStageBytes = 2ull * kTileElems * sizeof(__nv_bfloat16);  // A and B
  static constexpr int kStages = 2;
  static constexpr size_t kRingBytes = kStages * kStageBytes;
  // after the ring, the pair ranges of kThreads output blocks of the walk, as int2
  static constexpr size_t kSmem = kRingBytes + kThreads * sizeof(int2);
  static constexpr int kWarpCols = 4;  // the 8 warps as 2 x 4 over the 16 x 16 fragments
  static constexpr int kFr = (T + 1) / 2;                      // fragment rows per warp
  static constexpr int kFc = (T + kWarpCols - 1) / kWarpCols;  // fragment columns per warp
};
static_assert(PipeTile<8>::kSmem <= 232448, "b = 128 must fit one block's shared memory");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the 16-byte copies of the contiguous b x b tile `src` to shared memory at `dst` (row
// stride ld elements): a half-warp per row, b / 8 pieces of it.
__device__ __forceinline__ void copy_tile_async(const __nv_bfloat16* __restrict__ src,
                                                uint32_t dst, int b, int ld) {
  const int lane = threadIdx.x & 31;
  const int piece = lane & 15;
  if (piece >= (b >> 3)) return;
  for (int r = ((threadIdx.x >> 5) << 1) | (lane >> 4); r < b; r += 2 * kWarps) {
    cp_async16(dst + (uint32_t)(r * ld + piece * 8) * 2u, src + r * b + piece * 8);
  }
}

// Four 8 x 8 bf16 matrices from shared memory (lane l gives a row address of matrix l / 8),
// as mma.sync fragments; transposed with `.trans`.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) @ b (16 x 8, col): bf16 in, f32 out
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Write zeros to the b x b tile o: a warp per row, one 16-byte streaming store per lane
// (b / 4 <= 32 of them).
__device__ __forceinline__ void store_zeros(float* __restrict__ o, int b) {
  const int lane = threadIdx.x & 31;
  if (lane >= (b >> 2)) return;
  for (int r = threadIdx.x >> 5; r < b; r += kWarps) {
    __stcs(reinterpret_cast<float4*>(o + (long long)r * b) + lane,
           make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_block_matmul_pipe_kernel(const int* __restrict__ seg, const int* __restrict__ ka,
                                     const int* __restrict__ kb, int npairs,
                                     const __nv_bfloat16* __restrict__ a,
                                     const __nv_bfloat16* __restrict__ bm, long long n_a,
                                     long long n_b, float* __restrict__ out, int n_out, int b) {
  using P = PipeTile<T>;
  constexpr int S = P::kStages;
  extern __shared__ __align__(128) unsigned char smem[];  // the only shared memory
  int2* ranges = reinterpret_cast<int2*>(smem + P::kRingBytes);  // [kThreads]
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  {  // zero the ring once: the copies write the b x b corner only, so the padding stays zero
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int e = threadIdx.x; e < (int)(P::kRingBytes / 16); e += kThreads) {
      z[e] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const long long tile = (long long)b * b;
  const int grid = (int)gridDim.x;
  // the walk's fetch cursor: output block fs, the w-th of the walk; its pairs end at fhi,
  // the next pair is fp
  int w = -1, fs = 0, fp = -1, fhi = 0;
  // Move the cursor to the walk's next pair (false past the end); an output block that it
  // passes with no pair is written as zeros there.  Every thread moves it alike.  The pair
  // ranges of kThreads output blocks of the walk are searched at once, one per thread, so
  // the searches' dependent loads overlap.
  auto advance = [&]() -> bool {
    ++fp;
    while (fp >= fhi) {
      const long long next = blockIdx.x + (long long)(++w) * grid;
      if (next >= n_out) return false;
      fs = (int)next;
      if (w % kThreads == 0) {
        __syncthreads();  // every thread is done with the ranges before
        const long long sj = next + (long long)threadIdx.x * grid;
        if (sj < n_out) {
          const int lo = lower_bound(seg, npairs, (int)sj);
          ranges[threadIdx.x] = make_int2(lo, lower_bound(seg, lo, npairs, (int)sj + 1));
        }
        __syncthreads();
      }
      const int2 r = ranges[w % kThreads];
      fp = r.x;
      fhi = r.y;
      if (fp == fhi) store_zeros(out + fs * tile, b);
    }
    return true;
  };
  // One step of the ring: move the cursor to the walk's next pair and start its tile copies
  // into stage st as one commit group; past the walk's end, or where ka or kb is out of
  // range, the group is empty, so each step commits exactly one.  Returns whether there is
  // a pair, and sets its output block, whether it is its block's last pair, and whether it
  // counts.
  bool walking = true;
  auto fetch = [&](int st, int& s, bool& last, bool& ok) -> bool {
    walking = walking && advance();
    ok = false;
    if (walking) {
      s = fs;
      last = fp == fhi - 1;
      const long long ia = ka[fp];
      const long long ib = kb[fp];
      ok = ia >= 0 && ia < n_a && ib >= 0 && ib < n_b;
      if (ok) {
        const uint32_t dst = ring_s + (uint32_t)(st * P::kStageBytes);
        copy_tile_async(a + ia * tile, dst, b, P::kLd);
        copy_tile_async(bm + ib * tile, dst + (uint32_t)P::kTileElems * 2u, b, P::kLd);
      }
    }
    cp_async_commit();
    return walking;
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = (warp / P::kWarpCols) * P::kFr;  // this warp's first fragment row
  const int c0 = (warp % P::kWarpCols) * P::kFc;  // and column
  // this lane's ldmatrix row: of A (rows 0-15, columns 0 / 8) and of B (rows 0-15, columns
  // 0 / 8, transposed), in bytes from the fragment's corner
  const uint32_t a_lane = (uint32_t)((lane & 15) * P::kLd + (lane >> 4) * 8) * 2u;
  const uint32_t b_lane = (uint32_t)(((lane & 7) + (lane & 8)) * P::kLd + (lane >> 4) * 8) * 2u;
  // acc[i][n]: rows 16 (r0 + i) + lane / 4 (+ 8), columns 8 (2 c0 + n) + 2 (lane % 4) (+ 1)
  float acc[P::kFr][2 * P::kFc][4];
#pragma unroll
  for (int i = 0; i < P::kFr; ++i) {
#pragma unroll
    for (int n = 0; n < 2 * P::kFc; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    }
  }

  // the S pairs in the ring, oldest first (pair t is q[0]): output block, last pair of its
  // block, counts, exists
  int q_s[S];
  bool q_last[S], q_ok[S], q_has[S];
#pragma unroll
  for (int i = 0; i < S - 1; ++i) q_has[i] = fetch(i, q_s[i], q_last[i], q_ok[i]);
  if (!q_has[0]) return;  // no pair on this block's walk: its output blocks are zeros
  for (int t = 0;; ++t) {  // pair t of the walk, in ring stage t % S
    // pair t + S - 1's copies go out before pair t's MMAs, across output blocks too
    q_has[S - 1] = fetch((t + S - 1) % S, q_s[S - 1], q_last[S - 1], q_ok[S - 1]);
    cp_async_wait<S - 1>();
    __syncthreads();  // pair t's tiles are in shared memory, for every thread
    if (q_ok[0]) {
      const uint32_t sa = ring_s + (uint32_t)((t % S) * P::kStageBytes);
      const uint32_t sb = sa + (uint32_t)P::kTileElems * 2u;
#pragma unroll
      for (int k = 0; k < T; ++k) {
        uint32_t fa[P::kFr][4];
        uint32_t fb[P::kFc][4];
#pragma unroll
        for (int i = 0; i < P::kFr; ++i) {
          if (r0 + i < T) {
            ldmatrix_x4(fa[i], sa + a_lane + (uint32_t)((r0 + i) * 16 * P::kLd + k * 16) * 2u);
          }
        }
#pragma unroll
        for (int j = 0; j < P::kFc; ++j) {
          if (c0 + j < T) {
            ldmatrix_x4_trans(fb[j],
                              sb + b_lane + (uint32_t)(k * 16 * P::kLd + (c0 + j) * 16) * 2u);
          }
        }
#pragma unroll
        for (int i = 0; i < P::kFr; ++i) {
#pragma unroll
          for (int j = 0; j < P::kFc; ++j) {
            if (r0 + i < T && c0 + j < T) {
              mma_16816(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
              mma_16816(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
            }
          }
        }
      }
    }
    if (q_last[0]) {  // output block s is complete: stream it out, restart at zero
      float* o = out + q_s[0] * tile;
#pragma unroll
      for (int i = 0; i < P::kFr; ++i) {
#pragma unroll
        for (int n = 0; n < 2 * P::kFc; ++n) {
          const int row = (r0 + i) * 16 + (lane >> 2);
          const int col = (2 * c0 + n) * 8 + 2 * (lane & 3);
          if (col < b) {  // b is a multiple of 8: a pair of columns is in or out together
            if (row < b) {
              __stcs(reinterpret_cast<float2*>(o + row * b + col),
                     make_float2(acc[i][n][0], acc[i][n][1]));
            }
            if (row + 8 < b) {
              __stcs(reinterpret_cast<float2*>(o + (row + 8) * b + col),
                     make_float2(acc[i][n][2], acc[i][n][3]));
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
        }
      }
    }
    if (!q_has[1]) break;
    __syncthreads();  // every warp is done with stage t % S before the next step refills it
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      q_s[i] = q_s[i + 1];
      q_last[i] = q_last[i + 1];
      q_ok[i] = q_ok[i + 1];
      q_has[i] = q_has[i + 1];
    }
  }
}

constexpr int kMaxDevices = 64;

// Raise the pipe kernel's dynamic shared-memory limit, once per instantiation and device.
template <int T>
cudaError_t prepare_pipe() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(grouped_block_matmul_pipe_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)PipeTile<T>::kSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <int T>
cudaError_t pipe_per_sm(int* per_sm) {
  const cudaError_t err = prepare_pipe<T>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, grouped_block_matmul_pipe_kernel<T>, kThreads, PipeTile<T>::kSmem);
}

template <int T>
cudaError_t launch_pipe(const int* seg, const int* ka, const int* kb, int npairs,
                        const __nv_bfloat16* a, const __nv_bfloat16* bm, long long n_a,
                        long long n_b, float* out, int n_out, int b, int grid,
                        cudaStream_t stream) {
  const cudaError_t err = prepare_pipe<T>();
  if (err != cudaSuccess) return err;
  grouped_block_matmul_pipe_kernel<T><<<grid, kThreads, PipeTile<T>::kSmem, stream>>>(
      seg, ka, kb, npairs, a, bm, n_a, n_b, out, n_out, b);
  return cudaGetLastError();
}

// f(std::integral_constant<int, T>) for the padded-tile parameter T = ceil(b / 16), 1 <= b <= 128
template <typename F>
cudaError_t with_tiles(int b, F&& f) {
  switch ((b + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool pipe_takes(int b) { return b >= 8 && b <= kMaxBlock && b % 8 == 0; }

}  // namespace

// out[s] = sum of a_blocks[ka[i]] @ b_blocks[kb[i]] over the pairs i with seg[i] == s, for
// every s in [0, n_out); seg (int32 [npairs]) sorted ascending.  a_blocks bf16 [n_a, b, b],
// b_blocks bf16 [n_b, b, b], out f32 [n_out, b, b], all contiguous, 1 <= b <= 128.
extern "C" int grouped_block_matmul(const void* seg, const void* ka, const void* kb, int npairs,
                                    const void* a_blocks, const void* b_blocks, long long n_a,
                                    long long n_b, void* out, int n_out, int b, void* stream) {
  if (b < 1 || b > kMaxBlock || npairs < 0 || n_out <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (b % 8) == 0 && aligned16(a_blocks) && aligned16(b_blocks);
  const int* s = (const int*)seg;
  const int* pa = (const int*)ka;
  const int* pb = (const int*)kb;
  const __nv_bfloat16* ta = (const __nv_bfloat16*)a_blocks;
  const __nv_bfloat16* tb = (const __nv_bfloat16*)b_blocks;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((b + 15) / 16) {
    case 1: return (int)launch<1>(s, pa, pb, npairs, ta, tb, n_a, n_b, o, n_out, b, vec, st);
    case 2: return (int)launch<2>(s, pa, pb, npairs, ta, tb, n_a, n_b, o, n_out, b, vec, st);
    case 3: return (int)launch<3>(s, pa, pb, npairs, ta, tb, n_a, n_b, o, n_out, b, vec, st);
    case 4: return (int)launch<4>(s, pa, pb, npairs, ta, tb, n_a, n_b, o, n_out, b, vec, st);
    case 5: return (int)launch<5>(s, pa, pb, npairs, ta, tb, n_a, n_b, o, n_out, b, vec, st);
    case 6: return (int)launch<6>(s, pa, pb, npairs, ta, tb, n_a, n_b, o, n_out, b, vec, st);
    case 7: return (int)launch<7>(s, pa, pb, npairs, ta, tb, n_a, n_b, o, n_out, b, vec, st);
    default: return (int)launch<8>(s, pa, pb, npairs, ta, tb, n_a, n_b, o, n_out, b, vec, st);
  }
}

// The same function through the "pipe" kernel, on a persistent grid of `grid` blocks (at
// least 1; blocks past n_out find nothing to do).  8 <= b <= 128 with b % 8 == 0, and
// a_blocks, b_blocks and out 16-byte aligned.
extern "C" int grouped_block_matmul_pipe(const void* seg, const void* ka, const void* kb,
                                         int npairs, const void* a_blocks, const void* b_blocks,
                                         long long n_a, long long n_b, void* out, int n_out, int b,
                                         int grid, void* stream) {
  if (!pipe_takes(b) || npairs < 0 || n_out <= 0 || grid < 1 || !aligned16(a_blocks) ||
      !aligned16(b_blocks) || !aligned16(out)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)with_tiles(b, [&](auto t) {
    return launch_pipe<decltype(t)::value>(
        (const int*)seg, (const int*)ka, (const int*)kb, npairs,
        (const __nv_bfloat16*)a_blocks, (const __nv_bfloat16*)b_blocks, n_a, n_b, (float*)out,
        n_out, b, grid, (cudaStream_t)stream);
  });
}

// Blocks of the "pipe" kernel for tile side b that one SM holds at once, into *per_sm, on
// the current device (raising its shared-memory limit there first).
extern "C" int grouped_block_matmul_pipe_per_sm(int b, int* per_sm) {
  if (!pipe_takes(b) || per_sm == nullptr) return (int)cudaErrorInvalidValue;
  return (int)with_tiles(b, [&](auto t) { return pipe_per_sm<decltype(t)::value>(per_sm); });
}
