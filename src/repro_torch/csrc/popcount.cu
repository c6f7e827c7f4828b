// Set-bit counts of a 32-bit word matrix, for sm_90a.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/popcount.py:
// popcount_total (body _kernel: one int32 partial per (8, 1024) tile, summed
// by the wrapper in int32) and popcount_rows (body _kernel_rows: per-row
// counts accumulated over the column tiles).  The words are the int32
// bit-casts that the Python side holds; here they are read as uint32 and
// counted with __popc, where the TPU kernel counts them with SWAR.
//
// Sums are taken in 32-bit unsigned arithmetic and written as int32.  That
// is the reference's int32 sum with wrap: each of its tile partials is at
// most 8 * 1024 * 32 = 262,144, so its only wrap is in the final sum, and
// addition mod 2^32 gives the same bits in any order.  Nothing is padded:
// the TPU's (8, 1024) tiling is not needed here, and a zero word counts 0.
//
// What bounds them on an H100: bytes.  One __popc and one add per 4 bytes
// read is far below the card's operations-per-byte line, so the least
// time is the R * C * 4 input bytes read once (plus R * 4 or 4 output
// bytes) at 3.35 TB/s.
//
// Design.  popcount_rows: one block of 256 threads per row; the threads
// walk the row with 16-byte loads (neighbouring threads on neighbouring
// addresses) when the rows are 16-byte aligned, else with 4-byte loads;
// a __shfl_xor_sync butterfly and a shared-memory step sum the block.
// popcount_total: a grid-stride loop over the flat words on a grid sized
// to fill every SM, the same block sum, then one atomicAdd per block into
// a 32-bit counter that the launch zeroes first.  Making them fast (more
// loads in flight, splitting long rows across blocks) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 8;  // 2048 threads a SM

__device__ __forceinline__ unsigned popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Sum of v over the block, mod 2^32; the result is valid in thread 0.
// Called once per block.
__device__ __forceinline__ unsigned block_sum(unsigned v) {
  __shared__ unsigned warp_sums[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
  }
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
popcount_rows_kernel(const uint32_t* __restrict__ a,
                     int32_t* __restrict__ out, int64_t cols) {
  const int64_t row = blockIdx.x;
  const uint32_t* r = a + row * cols;
  unsigned count = 0;
  if (kVec) {
    const uint4* rv = reinterpret_cast<const uint4*>(r);
    const int64_t n = cols / 4;
#pragma unroll 4
    for (int64_t j = threadIdx.x; j < n; j += kThreads) count += popc4(rv[j]);
  } else {
    for (int64_t j = threadIdx.x; j < cols; j += kThreads) {
      count += __popc(r[j]);
    }
  }
  count = block_sum(count);
  if (threadIdx.x == 0) out[row] = static_cast<int32_t>(count);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
popcount_total_kernel(const uint32_t* __restrict__ a,
                      unsigned* __restrict__ out, int64_t n) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  unsigned count = 0;
  int64_t tail = 0;  // first word the scalar loop counts
  if (kVec) {
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const int64_t nv = n / 4;
#pragma unroll 4
    for (int64_t j = first; j < nv; j += stride) count += popc4(av[j]);
    tail = nv * 4;
  }
  for (int64_t j = tail + first; j < n; j += stride) count += __popc(a[j]);
  count = block_sum(count);
  if (threadIdx.x == 0) atomicAdd(out, count);
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  return static_cast<int>(err);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Per-row set bits of a contiguous (rows, cols) word matrix into rows
// int32 counts.  Launches on `stream`; returns cudaGetLastError() of the
// launch.  The caller guarantees 1 <= rows < 2^31 and cols >= 1.
extern "C" int popcount_rows_launch(const void* a, void* out, int64_t rows,
                                    int64_t cols, void* stream) {
  if (rows <= 0 || cols <= 0 || rows >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int grid = static_cast<unsigned int>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* words = static_cast<const uint32_t*>(a);
  int32_t* counts = static_cast<int32_t*>(out);
  if (cols % 4 == 0 && aligned16(a)) {
    popcount_rows_kernel<true><<<grid, kThreads, 0, s>>>(words, counts, cols);
  } else {
    popcount_rows_kernel<false><<<grid, kThreads, 0, s>>>(words, counts,
                                                          cols);
  }
  return static_cast<int>(cudaGetLastError());
}

// Total set bits of n contiguous words, mod 2^32, into one 32-bit counter
// (read as int32 by the caller).  Zeroes the counter, then launches, both
// on `stream`; returns the first CUDA error.  The caller guarantees n >= 1.
extern "C" int popcount_total_launch(const void* a, void* out, int64_t n,
                                     void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t merr = cudaMemsetAsync(out, 0, sizeof(unsigned), s);
  if (merr != cudaSuccess) return static_cast<int>(merr);
  const bool vec = aligned16(a);
  const int64_t per_thread = vec ? 4 : 1;
  const int64_t needed =
      (n + per_thread * kThreads - 1) / (per_thread * kThreads);
  const int64_t full = static_cast<int64_t>(sms) * kCtasPerSm;
  const unsigned int grid =
      static_cast<unsigned int>(needed < full ? needed : full);
  const uint32_t* words = static_cast<const uint32_t*>(a);
  unsigned* total = static_cast<unsigned*>(out);
  if (vec) {
    popcount_total_kernel<true><<<grid, kThreads, 0, s>>>(words, total, n);
  } else {
    popcount_total_kernel<false><<<grid, kThreads, 0, s>>>(words, total, n);
  }
  return static_cast<int>(cudaGetLastError());
}
