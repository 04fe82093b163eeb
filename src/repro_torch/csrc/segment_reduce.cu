// Sorted segment reduce: the keyed fold above SPARSE_KEY_THRESHOLD keys.
//
// Replaces the Pallas kernel src/repro/kernels/segment_reduce.py:
// segment_reduce_pallas (body _kernel).  As there, the wrapper sorts the
// lanes by segment outside the kernel (masked lanes to a sentinel segment
// past every tile) and cuts the sorted stream into per-tile ranges with a
// searchsorted; the kernel is the body that reduces each tile's range.
//
// Computes, per segment g of [0, n_seg),
//   out[g] = fold_{sorted lanes i with sseg[i] == g, in order} sval[i],
// starting from init[g] (or the op's neutral element), for sum, max and
// min; a count counts the segment's lanes from zero and adds init once, as
// the JAX package's kernels do.  The sort is stable, so the lanes of one
// segment come in lane order and a float sum adds the same terms in the
// same order as a sequential scatter-add into the running state: no
// atomics, the same result every run.
//
// Bound on this card: it reads each live lane once (segment and value, 8
// bytes) and init, and writes out (8 bytes per segment), so device-memory
// bytes bound it: at the keyed dataplane's shape the 1.6e7-segment state
// in and out outweighs the ~5e5 live lanes.
//
// Design: one block per tile of 512 segments, 256 threads, each thread two
// segments at a stride of 256, so init loads and out stores are coalesced.
// A thread finds its segment's run in the tile's range by two binary
// searches.  The block then stages the range through shared memory in
// chunks of 2048 values, loaded by all its threads together (coalesced),
// and each thread folds the part of its run that lies in the chunk, in
// order.  A hot key's run (under zipf skew one segment takes ~9% of a
// step's lanes) is still folded by one thread, one dependent add a lane,
// but from shared memory rather than from device memory one load at a
// time.  A tile no lane reaches only copies init.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;  // segments per block (the Pallas seg_tile)
constexpr int kThreads = 256;
constexpr int kPer = kTile / kThreads;  // segments per thread
constexpr int kChunk = 2048;  // stream values staged in shared memory at a time

enum Op { kSum = 0, kCount = 1, kMax = 2, kMin = 3 };

template <int OP>
__device__ __forceinline__ float neutral() {
  if (OP == kMax) return -INFINITY;
  if (OP == kMin) return INFINITY;
  return 0.0f;
}

template <int OP>
__device__ __forceinline__ float combine(float acc, float x) {
  if (OP == kMax) return x > acc ? x : acc;
  if (OP == kMin) return x < acc ? x : acc;
  return acc + x;
}

// first index in [lo, hi) whose segment is >= g
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ sseg,
                                           int lo, int hi, int32_t g) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (sseg[mid] < g) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int OP>
__global__ void __launch_bounds__(kThreads) segment_reduce_kernel(
    const int32_t* __restrict__ sseg, const float* __restrict__ sval,
    const int32_t* __restrict__ edges, const float* __restrict__ init,
    float* __restrict__ out, int n_seg) {
  __shared__ float s_val[kChunk];
  const int tile = blockIdx.x;
  const int lo = edges[tile];
  const int hi = edges[tile + 1];
  // this thread's segments g[k] and their runs [a[k], b[k]) in the stream
  int g[kPer], a[kPer], b[kPer];
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    g[k] = tile * kTile + k * kThreads + threadIdx.x;
    a[k] = b[k] = lo;
    acc[k] = neutral<OP>();
    if (g[k] < n_seg) {
      if (init && OP != kCount) acc[k] = init[g[k]];
      if (hi > lo) {
        a[k] = lower_bound(sseg, lo, hi, g[k]);
        b[k] = lower_bound(sseg, a[k], hi, g[k] + 1);
      }
    }
  }
  for (int base = lo; base < hi; base += kChunk) {
    const int n = min(kChunk, hi - base);
    if (OP != kCount) {
      for (int j = threadIdx.x; j < n; j += kThreads) s_val[j] = sval[base + j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int end = min(b[k], base + n);
      for (int i = max(a[k], base); i < end; ++i)
        acc[k] = combine<OP>(acc[k], OP == kCount ? 1.0f : s_val[i - base]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (g[k] < n_seg) out[g[k]] = (OP == kCount && init) ? acc[k] + init[g[k]] : acc[k];
  }
}

}  // namespace

extern "C" int segment_reduce_launch(const int32_t* sseg, const float* sval,
                                     const int32_t* edges, const float* init,
                                     float* out, int n_seg, int op,
                                     cudaStream_t stream) {
  if (n_seg <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (n_seg + kTile - 1) / kTile;
  switch (op) {
    case kSum:
      segment_reduce_kernel<kSum><<<grid, kThreads, 0, stream>>>(sseg, sval, edges, init, out, n_seg);
      break;
    case kCount:
      segment_reduce_kernel<kCount><<<grid, kThreads, 0, stream>>>(sseg, sval, edges, init, out, n_seg);
      break;
    case kMax:
      segment_reduce_kernel<kMax><<<grid, kThreads, 0, stream>>>(sseg, sval, edges, init, out, n_seg);
      break;
    case kMin:
      segment_reduce_kernel<kMin><<<grid, kThreads, 0, stream>>>(sseg, sval, edges, init, out, n_seg);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
