// n-ary word-aligned logical reduction with clean-block skipping, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/word_logical.py:74
// (word_logical) as src/repro/kernels/ops.py:178 (logical_reduce) drives it:
// a tree of pairwise launches that halves the rows each round.  Here one
// launch folds up to kMaxRows operand rows of C 32-bit words into one result
// row, reading each operand where it lies:
//
//     out = fold_op(pos rows) & ~OR(neg rows)      op in {and, or, xor}
//
// With no neg rows that is logical_reduce; with op = and it is the
// executor's AND-NOT node, AND(pos) \ OR(neg).  Each row has its own flag
// row, one DIRTY / CLEAN0 / CLEAN1 flag per 1024 words (exact or
// conservative: a clean flag never stands for a block that is not
// constant).  The words are the int32 bit-casts that the Python side holds;
// here they are read as uint32.
//
// What bounds it on an H100: bytes.  One word op per 4 bytes read is far
// below the card's operations-per-byte line, so the least time is the DIRTY
// row blocks that the result needs, read once, plus the result row and its
// flag row written once, at 3.35 TB/s.
//
// Design:
// - Operands in place.  Row and flag-row pointers go by value in the
//   kernel's parameter struct (about 2 KB), so nothing is stacked, padded
//   or copied to the device first.  More rows than kMaxRows chain launches
//   on the host side, each later one taking the running result as an extra
//   pos operand (slot kMaxRows).
// - Flags first.  A block owns 256 words of one 1024-word flag column.  It
//   reads that column's flag of every row and lists the DIRTY rows in
//   shared memory.  An absorbing flag (CLEAN0 of a pos row under and,
//   CLEAN1 under or, CLEAN1 of a neg row) makes the block write the
//   constant and read nothing; CLEAN identity rows drop out; under xor a
//   CLEAN1 row flips the result.  Only listed rows are read.
// - Bytes in flight.  Four blocks a flag column give 256 blocks at 65,536
//   words and 512 at 131,072, two to four on each of the 132 SMs, all
//   resident at once (47 registers a thread).  A block's 256 threads are
//   four row groups of 64: thread q of a group owns four words of the
//   slice, and the group takes every fourth listed row, kUnroll rows at a
//   time, all their 16-byte loads issued before any is folded: 16 KB in
//   flight a block, 32-64 KB a SM.  The four groups' partial results meet
//   in shared memory.  Plain loads beat a ring of 1 KB cp.async.bulk
//   copies here (PERF.md, Findings); 8 rows in flight a group would take 80
//   registers, too many for 512 blocks in one wave.
// - The result's flag row.  The four blocks of a flag column form a thread
//   block cluster: each ORs two bits of its words (some word != 0, some
//   word != ~0) into shared memory, and rank 0 reads the four through
//   distributed shared memory and writes the column's exact flag.  A
//   chained launch, or any later use on the device, keeps the skip.
// - Edges.  C need not be a multiple of 1024: a block masks the words past
//   C, and the flag of the ragged last column describes the words present.
//   Rows that are not 16-byte aligned, or C not a multiple of 4, take the
//   template's scalar form: thread q's words are q, q + 64, q + 128 and
//   q + 192, read with 4-byte loads.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 128;               // operand rows a launch takes
constexpr int kMaxSlots = kMaxRows + 1;     // + a chain's running result
constexpr int kFlagCols = 1024;             // words per flag
constexpr int kSlice = 256;                 // words per block
constexpr int kCluster = kFlagCols / kSlice;
constexpr int kLanes = kSlice / 4;          // threads across the slice
constexpr int kGroups = 4;                  // row groups a block
constexpr int kThreads = kLanes * kGroups;
constexpr int kUnroll = 4;                  // rows in flight a group

constexpr int kDirty = 0;
constexpr int kClean0 = 1;
constexpr int kClean1 = 2;

constexpr int kAnd = 0;
constexpr int kOr = 1;
constexpr int kXor = 2;

struct Params {
  const uint32_t* rows[kMaxSlots];
  const int32_t* flags[kMaxSlots];   // null: the row's blocks are DIRTY
  uint32_t* out;
  int32_t* out_flags;
  int64_t cols;
  int n_rows;                        // slots [0, n_pos) pos, then neg
  int n_pos;
  int op;
};

__device__ __forceinline__ uint4 splat(uint32_t w) {
  return make_uint4(w, w, w, w);
}

__device__ __forceinline__ uint4 apply(int op, uint4 a, uint4 b) {
  switch (op) {
    case kAnd: return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case kOr: return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    default: return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  }
}

// Thread q's four words of a row segment: words 4q .. 4q+3 with one
// 16-byte load, or words q, q + 64, q + 128, q + 192 with 4-byte loads.
// Words at or past nw read as 0 and are never stored.
template <bool kVec>
__device__ __forceinline__ uint4 load4(const uint32_t* seg, int q, int nw) {
  if constexpr (kVec) {
    return 4 * q < nw ? __ldg(reinterpret_cast<const uint4*>(seg) + q)
                      : splat(0u);
  } else {
    uint4 v;
    v.x = q < nw ? __ldg(seg + q) : 0u;
    v.y = q + kLanes < nw ? __ldg(seg + q + kLanes) : 0u;
    v.z = q + 2 * kLanes < nw ? __ldg(seg + q + 2 * kLanes) : 0u;
    v.w = q + 3 * kLanes < nw ? __ldg(seg + q + 3 * kLanes) : 0u;
    return v;
  }
}

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
logical_reduce_kernel(const __grid_constant__ Params p) {
  __shared__ int list[kMaxSlots];      // pos from the front, neg from the back
  __shared__ const uint32_t* seg[kMaxSlots];   // the listed rows' segments
  __shared__ uint4 part_pos[kGroups][kLanes];
  __shared__ uint4 part_neg[kGroups][kLanes];
  __shared__ int n_listed_pos, n_listed_neg, pos_absorbed, neg_absorbed, flip;
  __shared__ uint32_t bits;

  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int q = t % kLanes;
  const int g = t / kLanes;
  const int64_t fc = blockIdx.x / kCluster;        // flag column
  const int64_t c0 = fc * kFlagCols + static_cast<int64_t>(
      cluster.block_rank()) * kSlice;
  const int64_t left = p.cols - c0;
  const int nw = left <= 0 ? 0 : (left < kSlice ? static_cast<int>(left)
                                                 : kSlice);

  if (t == 0) n_listed_pos = n_listed_neg = pos_absorbed = neg_absorbed =
      flip = 0;
  __syncthreads();

  for (int r = t; r < p.n_rows; r += kThreads) {
    const int f = p.flags[r] == nullptr ? kDirty : p.flags[r][fc];
    if (r < p.n_pos) {
      if (f == kDirty) {
        list[atomicAdd(&n_listed_pos, 1)] = r;
      } else if (p.op == kXor) {
        if (f == kClean1) atomicXor(&flip, 1);
      } else if ((p.op == kAnd) == (f == kClean0)) {
        atomicOr(&pos_absorbed, 1);   // and with 0, or with ~0
      }
    } else if (f == kDirty) {
      list[kMaxSlots - 1 - atomicAdd(&n_listed_neg, 1)] = r;
    } else if (f == kClean1) {
      atomicOr(&neg_absorbed, 1);     // x & ~~0 == 0
    }
  }
  __syncthreads();

  // the pos side's starting value, and the listed rows still needed
  const uint32_t identity = p.op == kAnd ? ~0u : 0u;
  uint32_t init = identity;
  int n_pos = n_listed_pos;
  int n_neg = n_listed_neg;
  if (pos_absorbed) {
    init = ~init;
    n_pos = 0;
  }
  if (flip) init = ~init;
  if (neg_absorbed || (pos_absorbed && p.op == kAnd)) {
    init = 0;
    n_pos = n_neg = 0;
  }
  const int n_tasks = n_pos + n_neg;
  for (int j = t; j < n_tasks; j += kThreads) {
    const int r = j < n_pos ? list[j] : list[kMaxSlots - 1 - (j - n_pos)];
    seg[j] = p.rows[r] + c0;
  }
  __syncthreads();

  // group g folds listed rows g, g + 4, ..., kUnroll of them a round
  uint4 acc = splat(identity);
  uint4 sub = splat(0u);
  if (nw > 0) {
    for (int j0 = g; j0 < n_tasks; j0 += kUnroll * kGroups) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kGroups;
        v[u] = j < n_tasks ? load4<kVec>(seg[j], q, nw) : splat(0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kGroups;
        if (j < n_pos) {
          acc = apply(p.op, acc, v[u]);
        } else if (j < n_tasks) {
          sub = apply(kOr, sub, v[u]);
        }
      }
    }
  }
  part_pos[g][q] = acc;
  part_neg[g][q] = sub;
  __syncthreads();

  bool nonzero = false;
  bool not_ones = false;
  if (g == 0 && nw > 0) {
    acc = splat(init);
    sub = splat(0u);
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      acc = apply(p.op, acc, part_pos[h][q]);
      sub = apply(kOr, sub, part_neg[h][q]);
    }
    const uint32_t res[4] = {acc.x & ~sub.x, acc.y & ~sub.y, acc.z & ~sub.z,
                             acc.w & ~sub.w};
    if constexpr (kVec) {
      if (4 * q < nw) {
        reinterpret_cast<uint4*>(p.out + c0)[q] =
            make_uint4(res[0], res[1], res[2], res[3]);
        nonzero = (res[0] | res[1] | res[2] | res[3]) != 0u;
        not_ones = (res[0] & res[1] & res[2] & res[3]) != ~0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = q + i * kLanes;
        if (w < nw) {
          p.out[c0 + w] = res[i];
          nonzero |= res[i] != 0u;
          not_ones |= res[i] != ~0u;
        }
      }
    }
  }

  // the flag column's exact flag: bit 0 some word != 0, bit 1 some word
  // != ~0, ORed over the cluster; CLEAN0 = 1, CLEAN1 = 2, DIRTY = 0 is
  // that OR xor 3
  const int any_nonzero = __syncthreads_or(nonzero);
  const int any_not_ones = __syncthreads_or(not_ones);
  if (t == 0) bits = (any_nonzero ? 1u : 0u) | (any_not_ones ? 2u : 0u);
  cluster.sync();
  if (t == 0 && cluster.block_rank() == 0) {
    uint32_t all = 0;
    for (int r = 0; r < kCluster; ++r) all |= *cluster.map_shared_rank(&bits, r);
    p.out_flags[fc] = static_cast<int32_t>(all ^ 3u);
  }
  cluster.sync();                     // rank 0 has read every rank's bits
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.  `rows`
// and `flags` are host arrays of `n_rows` device pointers (a flag pointer
// may be null); slots [0, n_pos) are pos rows.  The caller guarantees
// 1 <= n_pos <= n_rows <= kMaxRows + 1, cols >= 1, contiguous rows of
// `cols` words, flag rows of at least ceil(cols / 1024) entries, an output
// row of `cols` words and a flag row of ceil(cols / 1024), and, when `vec`
// is set, 16-byte aligned rows and output with cols % 4 == 0.
extern "C" int logical_reduce_launch(const void* const* rows,
                                     const void* const* flags, int n_rows,
                                     int n_pos, void* out, void* out_flags,
                                     int64_t cols, int op, int vec,
                                     void* stream) {
  if (n_rows < 1 || n_rows > kMaxSlots || n_pos < 1 || n_pos > n_rows ||
      cols < 1 || op < kAnd || op > kXor)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int r = 0; r < kMaxSlots; ++r) {
    p.rows[r] = r < n_rows ? static_cast<const uint32_t*>(rows[r]) : nullptr;
    p.flags[r] = r < n_rows ? static_cast<const int32_t*>(flags[r]) : nullptr;
  }
  p.out = static_cast<uint32_t*>(out);
  p.out_flags = static_cast<int32_t*>(out_flags);
  p.cols = cols;
  p.n_rows = n_rows;
  p.n_pos = n_pos;
  p.op = op;
  const int64_t blocks = (cols + kFlagCols - 1) / kFlagCols * kCluster;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    logical_reduce_kernel<true><<<static_cast<unsigned int>(blocks),
                                  kThreads, 0, s>>>(p);
  } else {
    logical_reduce_kernel<false><<<static_cast<unsigned int>(blocks),
                                   kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
