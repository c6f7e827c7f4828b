// Per-block squared L2 norms of a flat gradient, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grad_compress.py
// (block_sqnorms, body _kernel): out[b] = sum_{i<256} g[256 b + i]^2 in
// float32, for the block-sparse gradient exchange's keep mask.  The TPU
// kernel cuts the blocks into tiles of 512 and needs the block count to be
// a multiple of its tile; this one takes any n_blocks >= 1.
//
// What bounds it on an H100: bytes.  Two flops per 4 bytes read is far
// below the card's operations-per-byte line, so the least time is the
// n_blocks * 1024 input bytes read once plus the n_blocks * 4 output bytes
// written once, at 3.35 TB/s.
//
// Design: one warp per 256-value block.  Lane l reads float4 number l and
// number l + 32 of the block, so each of the two loads of a warp is 512
// contiguous bytes; the lane's eight squares are summed in registers, the
// 32 partial sums by a __shfl_xor_sync butterfly, and lane 0 writes the
// block's norm.  Warps walk the blocks with a grid-stride loop over a grid
// sized to fill every SM once, so any block count fits one launch.  Making
// it fast (more loads in flight per warp, fusing the threshold) is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kValuesPerBlock = 256;
constexpr int kVecsPerBlock = kValuesPerBlock / 4;  // float4 per block
constexpr int kThreads = 256;                       // 8 warps a CUDA block
constexpr int kWarpsPerCta = kThreads / 32;
constexpr int kCtasPerSm = 8;                       // 64 warps a SM

__device__ __forceinline__ float sq4(float4 v, float s) {
  s = fmaf(v.x, v.x, s);
  s = fmaf(v.y, v.y, s);
  s = fmaf(v.z, v.z, s);
  return fmaf(v.w, v.w, s);
}

__global__ void __launch_bounds__(kThreads)
block_sqnorms_kernel(const float4* __restrict__ g, float* __restrict__ out,
                     int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kThreads
                         + threadIdx.x) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerCta;
  for (int64_t b = first; b < n_blocks; b += stride) {
    const float4* row = g + b * kVecsPerBlock;
    const float4 v0 = row[lane];
    const float4 v1 = row[lane + 32];
    float s = sq4(v1, sq4(v0, 0.0f));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if (lane == 0) out[b] = s;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.  The
// caller guarantees a contiguous, 16-byte aligned float32 input of
// n_blocks * 256 values and an n_blocks float32 output.
extern "C" int block_sqnorms_launch(const void* g, void* out,
                                    int64_t n_blocks, void* stream) {
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (n_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  const int64_t full = static_cast<int64_t>(sms) * kCtasPerSm;
  const unsigned int grid =
      static_cast<unsigned int>(needed < full ? needed : full);
  block_sqnorms_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(g), static_cast<float*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}
