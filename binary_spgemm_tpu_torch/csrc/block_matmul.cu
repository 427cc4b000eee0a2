// Grouped block matmul-accumulate for Hopper (sm_90a), with a plain C interface for ctypes.
//
// K3  grouped_block_matmul   replaces binary_spgemm_tpu/ops/pallas_bsr.py::grouped_block_matmul
//     Pairs i, sorted by output block seg[i], each add A[ka[i]] @ B[kb[i]] into out[seg[i]]:
//     bf16 b x b tiles (0/1 values), f32 counts, so counts are exact and `> 0` is the OR.
//
// Design.  The TPU kernel walked the pairs in one sequential grid and kept the current
// output block in VMEM while consecutive pairs hit it, zeroing it on each group's first
// pair.  Blocks on this card run in no order, so the sequential grid becomes a loop inside
// one thread block: one block per output block s (the scratch block included) finds its
// pair range [lo, hi) by binary search in the sorted seg (no host sync and no staged
// offsets; the TPU's `first` flags are implied by seg), and for each pair loads the A and
// B tiles into shared memory and accumulates bf16 tensor-core products (nvcuda::wmma
// 16x16x16) in f32 registers.  The tile is written once at the end through shared memory,
// coalesced; a block with no pair writes zeros, so every element of out is written.
// Any b from 1 to 128 works: the tile is padded with zeros in shared memory to the next
// multiple of 16, and the ragged edge is masked on load and store.
//
// Bound on this card: bytes.  Each input tile read once and each output tile written once
// is (nA + nB) * b^2 * 2 + n_out * b^2 * 4 bytes (about 106 MB on the blocked-32k-b128
// plan: 0.032 ms at 3.35 TB/s), against 2 * npairs * b^3 operations (4.8 GFLOP there:
// 0.005 ms at 989 TFLOP/s).  What this first design leaves on the table: the tile loads
// are not overlapped with the MMAs (no cp.async / TMA ring), A tiles are re-read by every
// output block that uses them, and wmma is not wgmma.
//
// Pair indices are not range-checked against nA / nB on the host (that would need a host
// sync per launch); a pair whose ka or kb is out of range is skipped here, so no block
// reads outside the operands.
//
// Every entry point returns cudaGetLastError() after its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

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

// First i in [0, n) with seg[i] >= s, or n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ seg, int n, int s) {
  int lo = 0, hi = n;
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
