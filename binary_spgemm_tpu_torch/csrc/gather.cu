// Class-table row gathers of the sliced-ELL expansion for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// P3  class_gather_group        replaces benchmarks/pallas_gather.py::pallas_gather
//     Every gathered width class of one dispatch group in one launch.  Class k has a
//     table int32 [nc, w] (padded with the sentinel n_cols) and positions and row ids int32
//     [g, pad]; slot (i, e * w + j) of its column span [col0, col0 + pad * w) of the
//     group's candidate stream gets the pair (rows[i, e], table[pos[i, e], j]), or
//     (rows_pad, n_cols) where the column is a sentinel or the row id is not below
//     rows_pad.  Two int32 outputs, the row and column streams.
// P4  class_gather_keys_group   replaces benchmarks/pallas_gather.py::pallas_gather_keys
//     The same gather fused with the key pack: (row << shift) | col, and the sentinel key
//     (rows_pad << shift) | n_cols for invalid slots.  One int32 output.
//
// Both compute ops/ell.py::_expand_class_2d of the port (and so the JAX package's
// _expand_class / _expand_class_2d) for each class.  A position outside [0, nc) is taken
// as JAX's indexing takes it: a negative one counts from the end, then the index is
// clamped to [0, nc - 1].
//
// Bound on this card.  The least traffic is one read of the positions and row ids, one
// read of each table (L2-resident, counted once) and one write of each output slot: for
// P3, 8 * g * pad + 4 * nc * w + 8 * g * pad * w bytes a class over 3.35 TB/s; P4 writes
// half of the output.  A compare, select and (P4) shift per slot is far below the compute
// rate, so both are bound by the bytes they write.
//
// Design.  The TPU prototype held the whole table in VMEM and streamed blocks of
// positions.  Here a class table of the serving paths is at most about 1 MB and stays in
// the 50 MB L2, so the output stores are the traffic that counts:
// - One launch per dispatch group.  The classes travel by value as one kernel parameter
//   (GroupArgs, at most kMaxClasses of them, under the 4 KB parameter limit; the wrapper
//   splits a longer list into several launches), read in place through
//   __grid_constant__, so a group needs no host-to-device copy.  Each class's span of a
//   stream row is cut into tiles of kQuadsPerTile runs of 4 slots; blockIdx.x is a tile
//   of the whole group, found by a binary search over the classes' first tiles held in
//   shared memory, and blockIdx.y walks the group's g rows.
// - 16-byte stores.  A thread owns runs of 4 consecutive slots at a 16-byte aligned
//   output address and writes each with one int4 store per output; kUnroll runs a thread
//   per tile keep that many runs' loads in flight.  The 0-3 slots before the first
//   aligned address and after the last run of each row's span (col0 or the row stride not
//   a multiple of 4) are written one by one.  The runs' stores stream past the L2
//   (__stcs): on an H100, plain stores were slower on every serving path's group, by up
//   to a fifth, and no faster for K1's read of the bench stream right after.
// - One division per run: (e, j) of the run's first slot from a multiply-high by a magic
//   number the wrapper computes for w, then j steps and wraps into the next entry.  A
//   position and a row id are loaded once per entry a run touches.  Table rows start
//   wherever the flat concatenation of the tables put them, so the table is read as
//   4-byte loads through the read-only path: the alignment is on the output side only.
// Offsets into the inputs and outputs are 64-bit: a group of the largest plans holds more
// than 2^27 slots.  Inputs may be column slices of wider arrays (row strides pos_stride,
// rows_stride, unit column stride).
//
// Every entry point returns cudaGetLastError() after its launch; 0 means launched.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // runs of 4 slots a thread per tile
constexpr unsigned kQuadsPerTile = kThreads * kUnroll;
constexpr int kMaxClasses = 48;
constexpr int kMaxGridY = 65535;

// One gathered class; the layout is mirrored by ops/gather.py::_ClassDesc.
struct ClassDesc {
  const int* table;       // [nc, w], contiguous
  const int* pos;         // [g, pad], row stride pos_stride
  const int* rows;        // [g, pad], row stride rows_stride
  long long pos_stride;
  long long rows_stride;
  long long col0;         // the span's first column in the group stream
  unsigned span;          // pad * w slots a stream row
  unsigned magic;         // c / w == (__umulhi(c, magic) + c) >> mshift for c < 2^31
  int w;
  int nc;
  int mshift;
  unsigned tile0;         // the class's first tile (blockIdx.x); set by the launcher
};

struct GroupArgs {
  ClassDesc cls[kMaxClasses];
  int n_classes;
};

// the kernel's other parameters take under 64 bytes
static_assert(sizeof(GroupArgs) + 64 <= 4096, "kernel parameters past 4 KB");

// One stream row of one class: where its entries and table are.
struct Row {
  const int* table;
  const int* pos;
  const int* rows;
  int w, nc;
  unsigned magic;
  int mshift;
};

// The table row of entry e (its position clamped as JAX clamps) and the entry's row id.
__device__ __forceinline__ const int* entry(const Row& R, unsigned e, int* r) {
  int p = __ldg(R.pos + e);
  if (p < 0) p += R.nc;
  p = min(max(p, 0), R.nc - 1);
  *r = __ldg(R.rows + e);
  return R.table + (size_t)p * R.w;
}

struct Pack {
  int rows_pad, n_cols, key_shift, sentinel_key;
};

template <bool kKeys>
__device__ __forceinline__ void pack(const Pack& P, int r, int col, int* a, int* b) {
  const bool valid = col < P.n_cols && r < P.rows_pad;
  if (kKeys) {
    *a = valid ? (int)(((unsigned)r << P.key_shift) | (unsigned)col) : P.sentinel_key;
  } else {
    *a = valid ? r : P.rows_pad;
    *b = valid ? col : P.n_cols;
  }
}

// Slots c ... c + n - 1 of the row (n <= 4, all inside the span).
template <bool kKeys, int n>
__device__ __forceinline__ void gather_run(const Row& R, const Pack& P, unsigned c,
                                           int (&a)[4], int (&b)[4]) {
  unsigned e = (__umulhi(c, R.magic) + c) >> R.mshift;
  int j = (int)(c - e * (unsigned)R.w);
  int r;
  const int* trow = entry(R, e, &r);
#pragma unroll
  for (int k = 0; k < n; ++k) {
    pack<kKeys>(P, r, __ldg(trow + j), &a[k], &b[k]);
    if (k + 1 < n && ++j == R.w) {
      j = 0;
      trow = entry(R, ++e, &r);
    }
  }
}

__device__ __forceinline__ void store4(int* dst, const int (&v)[4]) {
  __stcs(reinterpret_cast<int4*>(dst), make_int4(v[0], v[1], v[2], v[3]));
}

template <bool kKeys>
__global__ void __launch_bounds__(kThreads)
class_gather_group_kernel(const __grid_constant__ GroupArgs args, int g,
                          int* __restrict__ out_a, int* __restrict__ out_b,
                          long long out_stride, Pack P) {
  __shared__ unsigned s_tile0[kMaxClasses];
  const int n = args.n_classes;
  if ((int)threadIdx.x < n) s_tile0[threadIdx.x] = args.cls[threadIdx.x].tile0;
  __syncthreads();
  int lo = 0, hi = n - 1;  // the last class whose first tile is at or before this one
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_tile0[mid] <= blockIdx.x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const ClassDesc& d = args.cls[lo];
  const unsigned span = d.span;
  const unsigned tile = blockIdx.x - d.tile0;
  const unsigned q0 = tile * kQuadsPerTile + threadIdx.x;
  for (int i = blockIdx.y; i < g; i += gridDim.y) {
    const Row R{d.table, d.pos + (long long)i * d.pos_stride,
                d.rows + (long long)i * d.rows_stride, d.w, d.nc, d.magic, d.mshift};
    int* a_i = out_a + (long long)i * out_stride + d.col0;
    int* b_i = kKeys ? nullptr : out_b + (long long)i * out_stride + d.col0;
    // slots before the first 16-byte aligned address, then whole runs, then the rest
    const unsigned head = min(span, (unsigned)((16 - ((size_t)a_i & 15)) & 15) >> 2);
    const unsigned nq = (span - head) >> 2;
    if (tile == 0 && threadIdx.x < 8) {
      const unsigned c = threadIdx.x < 4 ? threadIdx.x : head + 4 * nq + threadIdx.x - 4;
      if (c < (threadIdx.x < 4 ? head : span)) {
        int a[4], b[4];
        gather_run<kKeys, 1>(R, P, c, a, b);
        a_i[c] = a[0];
        if (!kKeys) b_i[c] = b[0];
      }
    }
    int va[kUnroll][4], vb[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned q = q0 + u * kThreads;
      if (q < nq) gather_run<kKeys, 4>(R, P, head + 4 * q, va[u], vb[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned q = q0 + u * kThreads;
      if (q < nq) {
        store4(a_i + head + 4 * q, va[u]);
        if (!kKeys) store4(b_i + head + 4 * q, vb[u]);
      }
    }
  }
}

unsigned tiles_of(unsigned span) {
  const unsigned t = ((span >> 2) + kQuadsPerTile - 1) / kQuadsPerTile;
  return t ? t : 1;  // a span shorter than one run still has its head slots
}

template <bool kKeys>
int launch_group(const ClassDesc* classes, int n, int g, int* out_a, int* out_b,
                 long long out_stride, const Pack& P, void* stream) {
  if (n < 1 || n > kMaxClasses || g < 1 || ((size_t)out_a & 3) ||
      (!kKeys && ((size_t)out_a & 15) != ((size_t)out_b & 15)))
    return (int)cudaErrorInvalidValue;
  GroupArgs args = {};
  long long tiles = 0;
  for (int k = 0; k < n; ++k) {
    const ClassDesc& c = classes[k];
    if (c.w < 1 || c.nc < 1 || c.span < 1 || c.span > INT_MAX || c.span % c.w)
      return (int)cudaErrorInvalidValue;
    args.cls[k] = c;
    args.cls[k].tile0 = (unsigned)tiles;
    tiles += tiles_of(c.span);
  }
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  args.n_classes = n;
  const dim3 grid((unsigned)tiles, (unsigned)(g < kMaxGridY ? g : kMaxGridY));
  class_gather_group_kernel<kKeys><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      args, g, out_a, out_b, out_stride, P);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper checks these against its own copy of the layout before its first launch.
extern "C" int class_gather_desc_bytes() { return (int)sizeof(ClassDesc); }
extern "C" int class_gather_max_classes() { return kMaxClasses; }

// P3: row and column streams of n classes of one group (g rows).  Returns
// cudaErrorInvalidValue, launching nothing, for n outside [1, kMaxClasses], g below 1, a
// class with an empty span, a span past INT_MAX or not a multiple of w, outputs not 4-byte
// aligned or whose addresses differ modulo 16.
extern "C" int class_gather_group(const void* classes, int n, int g, void* out_rows,
                                  void* out_cols, long long out_stride, int rows_pad,
                                  int n_cols, void* stream) {
  return launch_group<false>((const ClassDesc*)classes, n, g, (int*)out_rows,
                             (int*)out_cols, out_stride, Pack{rows_pad, n_cols, 0, 0},
                             stream);
}

// P4: packed keys (row << shift) | col, sentinel_key for invalid slots.
extern "C" int class_gather_keys_group(const void* classes, int n, int g, void* out,
                                       long long out_stride, int rows_pad, int n_cols,
                                       int shift, int sentinel_key, void* stream) {
  if (shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  return launch_group<true>((const ClassDesc*)classes, n, g, (int*)out, nullptr, out_stride,
                            Pack{rows_pad, n_cols, shift, sentinel_key}, stream);
}
