// Word-aligned logical ops with clean-tile skipping, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/word_logical.py
// (word_logical, body _kernel): out = op(a, b) for op in {and, or, xor,
// andnot} over (R, C) 32-bit words, with one DIRTY / CLEAN0 / CLEAN1 flag
// per (8, 1024) tile of each operand.  The words are the int32 bit-casts
// that the Python side holds; here they are read as uint32.
//
// What bounds it on an H100: bytes.  One word op per 4 bytes moved is far
// below the card's operations-per-byte line, so the least time is the
// dirty tiles of a and b that the result depends on, read once, plus the
// R * C * 4 bytes of the output, written once, at 3.35 TB/s.
//
// Design: one block of 256 threads per (8, 1024) tile.  The block reads
// the two tile flags first.  A clean operand is never loaded: its words
// are the constant 0 or 0xFFFFFFFF.  A dirty operand is not loaded either
// when the other side's constant decides the result alone (AND with a
// clean-0 tile, OR with a clean-1 tile, ANDNOT with a clean-0 a or a
// clean-1 b).  Loads and stores are 16 bytes a thread, neighbouring threads
// on neighbouring addresses: thread t handles words 4t..4t+3 of each of the
// tile's 8 rows.  The n-ary reduction of the executor is one launch of
// csrc/logical_reduce.cu instead of a tree of these.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 8;
constexpr int kBlockCols = 1024;
constexpr int kThreads = kBlockCols / 4;  // one uint4 per thread per row

constexpr int kDirty = 0;
constexpr int kClean0 = 1;
constexpr int kClean1 = 2;

constexpr int kAnd = 0;
constexpr int kOr = 1;
constexpr int kXor = 2;
constexpr int kAndNot = 3;

__device__ __forceinline__ uint32_t apply(int op, uint32_t a, uint32_t b) {
  switch (op) {
    case kAnd: return a & b;
    case kOr: return a | b;
    case kXor: return a ^ b;
    case kAndNot:
    default: return a & ~b;
  }
}

__device__ __forceinline__ uint4 apply4(int op, uint4 a, uint4 b) {
  return make_uint4(apply(op, a.x, b.x), apply(op, a.y, b.y),
                    apply(op, a.z, b.z), apply(op, a.w, b.w));
}

// Whether a clean tile of one side with flag f fixes the result whatever
// the other side holds.  `left` says whether the clean side is a.
__device__ __forceinline__ bool decides(int op, int f, bool left) {
  if (f == kDirty) return false;
  switch (op) {
    case kAnd: return f == kClean0;
    case kOr: return f == kClean1;
    case kXor: return false;
    default: return left ? f == kClean0 : f == kClean1;  // a & ~b
  }
}

__global__ void __launch_bounds__(kThreads)
word_logical_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                    const int32_t* __restrict__ flags_a,
                    const int32_t* __restrict__ flags_b,
                    uint4* __restrict__ out, int64_t cols, int64_t grid_cols,
                    int op) {
  const int64_t tile = blockIdx.x;
  const int64_t tile_r = tile / grid_cols;
  const int64_t tile_c = tile - tile_r * grid_cols;
  const int fa = flags_a[tile];
  const int fb = flags_b[tile];
  const bool load_a = fa == kDirty && !decides(op, fb, false);
  const bool load_b = fb == kDirty && !decides(op, fa, true);
  const uint32_t ca = fa == kClean1 ? 0xFFFFFFFFu : 0u;
  const uint32_t cb = fb == kClean1 ? 0xFFFFFFFFu : 0u;
  const uint4 const_a = make_uint4(ca, ca, ca, ca);
  const uint4 const_b = make_uint4(cb, cb, cb, cb);

  const int64_t row_vecs = cols / 4;  // uint4 per row
  int64_t idx = tile_r * kBlockRows * row_vecs + tile_c * kThreads
                + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kBlockRows; ++r, idx += row_vecs) {
    const uint4 va = load_a ? a[idx] : const_a;
    const uint4 vb = load_b ? b[idx] : const_b;
    out[idx] = apply4(op, va, vb);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.  The
// caller guarantees rows % 8 == 0, cols % 1024 == 0, 16-byte aligned
// contiguous buffers, and (rows / 8, cols / 1024) flags per operand.
extern "C" int word_logical_launch(const void* a, const void* b,
                                   const void* flags_a, const void* flags_b,
                                   void* out, int64_t rows, int64_t cols,
                                   int op, void* stream) {
  const int64_t grid_cols = cols / kBlockCols;
  const int64_t tiles = (rows / kBlockRows) * grid_cols;
  if (tiles > 0) {
    word_logical_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<const int32_t*>(flags_a),
        static_cast<const int32_t*>(flags_b), static_cast<uint4*>(out), cols,
        grid_cols, op);
  }
  return static_cast<int>(cudaGetLastError());
}
