// Bit packing of a bool matrix into 32-bit words, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitpack_kernel.py
// (bitpack, body _kernel): (N, L) bools, row-major, become
// (ceil(N / 32), L) words, and bit i of word w of column l is
// bits[32 w + i, l] (the codec's little-endian convention).  The TPU kernel
// packs (1024, 128) tiles as a weighted sum with weights 2^i and needs N
// and L padded to that tile; this one takes any N and L, and rows past N
// are zero bits.  The words are written as uint32 into the int32 tensor
// that the Python side holds.
//
// What bounds it on an H100: bytes.  A compare, a shift and an or per
// input byte is far below the card's operations-per-byte line, so the
// least time is the N * L input bytes read once plus the
// ceil(N / 32) * L * 4 output bytes written once, at 3.35 TB/s.
//
// Design: one thread per output word (w, l).  A block's 256 threads take
// 256 neighbouring columns of one word row, so for each of the 32 input
// rows a warp reads 32 contiguous bytes (one sector) and its stores of 32
// words are 128 contiguous bytes.  The thread issues its 32 byte loads
// unrolled, then builds the word with shifts.  grid.x covers the columns,
// grid.y walks the word rows (strided past 65,535).  A warp that spans 32
// rows of one column and packs with __ballot_sync would read bytes L
// apart; a shared-memory transpose with 16-byte loads is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordBits = 32;
constexpr int64_t kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
bitpack_kernel(const uint8_t* __restrict__ bits, uint32_t* __restrict__ words,
               int64_t n_rows, int64_t cols, int64_t n_words) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (l >= cols) return;
  for (int64_t w = blockIdx.y; w < n_words; w += gridDim.y) {
    const int64_t row0 = w * kWordBits;
    const uint8_t* p = bits + row0 * cols + l;
    uint32_t word = 0;
    if (row0 + kWordBits <= n_rows) {
      uint8_t b[kWordBits];
#pragma unroll
      for (int i = 0; i < kWordBits; ++i) b[i] = p[i * cols];
#pragma unroll
      for (int i = 0; i < kWordBits; ++i) {
        word |= static_cast<uint32_t>(b[i] != 0) << i;
      }
    } else {
      const int rows = static_cast<int>(n_rows - row0);
      for (int i = 0; i < rows; ++i) {
        word |= static_cast<uint32_t>(p[i * cols] != 0) << i;
      }
    }
    words[w * cols + l] = word;
  }
}

}  // namespace

// Packs a contiguous (n_rows, cols) bool matrix (one byte a value) into
// ceil(n_rows / 32) x cols words.  Launches on `stream`; returns
// cudaGetLastError() of the launch.  The caller guarantees n_rows >= 1 and
// cols >= 1.
extern "C" int bitpack_launch(const void* bits, void* words, int64_t n_rows,
                              int64_t cols, void* stream) {
  if (n_rows <= 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_words = (n_rows + kWordBits - 1) / kWordBits;
  const int64_t grid_x = (cols + kThreads - 1) / kThreads;
  if (grid_x >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(grid_x),
                  static_cast<unsigned int>(n_words < kMaxGridY ? n_words
                                                                : kMaxGridY));
  bitpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<uint32_t*>(words),
      n_rows, cols, n_words);
  return static_cast<int>(cudaGetLastError());
}
