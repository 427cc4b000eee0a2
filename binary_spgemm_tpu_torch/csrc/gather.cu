// Class-table row gathers of the sliced-ELL expansion for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// P3  class_gather        replaces benchmarks/pallas_gather.py::pallas_gather
//     One width class of one dispatch group: table int32 [nc, w] (padded with the
//     sentinel n_cols), positions and row ids int32 [g, pad].  Slot (i, e * w + j) of the
//     group's candidate stream gets the pair (rows[i, e], table[pos[i, e], j]), or
//     (rows_pad, n_cols) where the column is a sentinel or the row id is not below
//     rows_pad.  Two int32 outputs, the row and column streams.
// P4  class_gather_keys   replaces benchmarks/pallas_gather.py::pallas_gather_keys
//     The same gather fused with the key pack: (row << shift) | col, and the sentinel key
//     (rows_pad << shift) | n_cols for invalid slots.  One int32 output.
//
// Both compute ops/ell.py::_expand_class_2d of the port (and so the JAX package's
// _expand_class / _expand_class_2d).  A position outside [0, nc) is taken as JAX's
// indexing takes it: a negative one counts from the end, then the index is clamped to
// [0, nc - 1].
//
// Design.  The TPU prototype held the whole table in VMEM and streamed blocks of
// positions.  Here the table stays in device memory and is read through the read-only
// path: a class table of the main path is at most a few MB and sits in the 50 MB L2.
// One thread per output slot, in a grid-stride loop: blockIdx.y walks the group's g
// rows, the x dimension the pad * w slots of the row, so neighbouring threads write
// neighbouring slots (coalesced stores) and read neighbouring words of one table row.
// The w threads of one entry read its position and row id once each, as a broadcast.
// Offsets into the inputs and outputs are 64-bit: a group of the largest plan holds more
// than 2^27 slots.  The kernel writes straight into its column span [col0, col0 + pad * w)
// of the caller's group stream (row stride out_stride), so the stream needs no
// concatenation.  Inputs may be column slices of wider arrays (row strides pos_stride,
// rows_stride, unit column stride).
//
// Bound on this card.  The least traffic is one read of the positions and row ids, one
// read of the table (L2-resident, counted once) and one write of each output slot: for
// P3, 8 * g * pad + 4 * nc * w + 8 * g * pad * w bytes over 3.35 TB/s; P4 writes half of
// the output.  One compare, select and (P4) shift per slot is far below the compute
// rate, so both are bound by bytes.
//
// Every entry point returns cudaGetLastError() after its launch; 0 means launched.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridX = 4096;
constexpr int kMaxGridY = 65535;

template <bool kKeys>
__global__ void __launch_bounds__(kThreads)
class_gather_kernel(const int* __restrict__ table, int nc, int w,
                    const int* __restrict__ pos, long long pos_stride,
                    const int* __restrict__ rows, long long rows_stride, int g,
                    unsigned span, int* __restrict__ out_a, int* __restrict__ out_b,
                    long long out_stride, long long col0, int rows_pad, int n_cols,
                    int shift, int sentinel_key) {
  const unsigned uw = (unsigned)w;
  const unsigned step = gridDim.x * blockDim.x;
  for (int i = blockIdx.y; i < g; i += gridDim.y) {
    const int* pos_i = pos + (long long)i * pos_stride;
    const int* rows_i = rows + (long long)i * rows_stride;
    const long long base = (long long)i * out_stride + col0;
    for (unsigned c = blockIdx.x * blockDim.x + threadIdx.x; c < span; c += step) {
      const unsigned e = c / uw;
      const unsigned j = c - e * uw;
      int p = __ldg(pos_i + e);
      if (p < 0) p += nc;
      p = min(max(p, 0), nc - 1);
      const int col = __ldg(table + (long long)p * w + j);
      const int r = __ldg(rows_i + e);
      const bool valid = col < n_cols && r < rows_pad;
      if (kKeys) {
        out_a[base + c] =
            valid ? (int)(((unsigned)r << shift) | (unsigned)col) : sentinel_key;
      } else {
        out_a[base + c] = valid ? r : rows_pad;
        out_b[base + c] = valid ? col : n_cols;
      }
    }
  }
}

bool plan_grid(int g, int pad, int w, int nc, unsigned* span, dim3* grid) {
  if (g <= 0 || pad <= 0 || w <= 0 || nc <= 0) return false;
  const long long s = (long long)pad * w;
  if (s > INT_MAX) return false;
  *span = (unsigned)s;
  const long long bx = (s + kThreads - 1) / kThreads;
  *grid = dim3((unsigned)(bx < kMaxGridX ? bx : kMaxGridX),
               (unsigned)(g < kMaxGridY ? g : kMaxGridY));
  return true;
}

}  // namespace

// P3: row and column streams.  Returns cudaErrorInvalidValue, launching nothing, for
// g, pad, w or nc below 1 or pad * w past INT_MAX (the wrapper launches no empty call).
extern "C" int class_gather(const void* table, int nc, int w, const void* pos,
                            long long pos_stride, const void* rows, long long rows_stride,
                            int g, int pad, void* out_rows, void* out_cols,
                            long long out_stride, long long col0, int rows_pad, int n_cols,
                            void* stream) {
  unsigned span;
  dim3 grid;
  if (!plan_grid(g, pad, w, nc, &span, &grid)) return (int)cudaErrorInvalidValue;
  class_gather_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)table, nc, w, (const int*)pos, pos_stride, (const int*)rows, rows_stride,
      g, span, (int*)out_rows, (int*)out_cols, out_stride, col0, rows_pad, n_cols, 0, 0);
  return (int)cudaGetLastError();
}

// P4: packed keys (row << shift) | col, sentinel_key for invalid slots.
extern "C" int class_gather_keys(const void* table, int nc, int w, const void* pos,
                                 long long pos_stride, const void* rows,
                                 long long rows_stride, int g, int pad, void* out,
                                 long long out_stride, long long col0, int rows_pad,
                                 int n_cols, int shift, int sentinel_key, void* stream) {
  unsigned span;
  dim3 grid;
  if (!plan_grid(g, pad, w, nc, &span, &grid) || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  class_gather_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)table, nc, w, (const int*)pos, pos_stride, (const int*)rows, rows_stride,
      g, span, (int*)out, nullptr, out_stride, col0, rows_pad, n_cols, shift, sentinel_key);
  return (int)cudaGetLastError();
}
