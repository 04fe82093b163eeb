// Windowed fold of event lanes into per-(slot, key) sum / count / max / min.
//
// Replaces the Pallas kernel src/repro/kernels/window_agg.py:
// window_agg_pallas (bodies _kernel_unkeyed and _kernel_keyed), the WCRDT
// fold of GCounter, PNCounter, MaxReg and MinReg.
//
// Computes, per replica s and cell c = slot * C + key of a [W, C] grid,
//   out[s, c] = fold_{lanes l of s in order} v[s, l], starting from init[s, c]
// (or the op's neutral element), over the lanes with mask[s, l] and
// slots[s, l] * C + keys[s, l] == c.  A float sum thus adds the same terms
// in the same order as a sequential scatter-add into the running state.
// A count counts the batch's lanes from zero and adds init once, as the
// JAX package's kernels do.
//
// Bound on this card: the function reads each lane once (13 bytes: value,
// slot, key, mask) and writes W*C floats per replica, so it is bound by
// device-memory bytes.  The design does the Pallas kernel's one-hot work,
// O(L * W * C) compares, which at the slice's shapes is the larger cost.
//
// Design: one block per (replica, tile of 256 output cells); one thread
// owns one cell.  The block streams its replica's lanes through shared
// memory in tiles of 1024: the loads are coalesced, and in the compare loop
// every thread reads the same lane, a shared-memory broadcast.  Each thread
// folds its cell in lane order, so a float sum is the same from run to run
// (no atomics).  A tile with no lane in the block's cell range is skipped
// after one block-wide vote (__syncthreads_or): a batch touches few ring
// slots, so most (replica, cell-tile) blocks skip most tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCells = 256;  // threads per block = cells per block
constexpr int kTile = 1024;  // lanes staged in shared memory at a time

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

template <int OP>
__global__ void __launch_bounds__(kCells) window_agg_kernel(
    const float* __restrict__ vals, const int32_t* __restrict__ slots,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ keys,
    const float* __restrict__ init, float* __restrict__ out,
    int L, int W, int C) {
  __shared__ float s_val[kTile];
  __shared__ int32_t s_cell[kTile];

  const int s = blockIdx.y;
  const int n_cells = W * C;
  const int cell0 = blockIdx.x * kCells;
  const int cell = cell0 + threadIdx.x;
  const size_t row = (size_t)s * L;

  float acc = neutral<OP>();
  if (OP != kCount && init && cell < n_cells) acc = init[(size_t)s * n_cells + cell];
  for (int base = 0; base < L; base += kTile) {
    int hit = 0;
    for (int j = threadIdx.x; j < kTile; j += kCells) {
      const int lane = base + j;
      int32_t c = -1;
      float x = 0.0f;
      if (lane < L && mask[row + lane]) {
        c = slots[row + lane] * C + (keys ? keys[row + lane] : 0);
        x = OP == kCount ? 1.0f : vals[row + lane];
      }
      hit |= (c >= cell0) & (c < cell0 + kCells);
      s_cell[j] = c;
      s_val[j] = x;
    }
    if (__syncthreads_or(hit)) {
      const int n = min(kTile, L - base);
      for (int j = 0; j < n; ++j) {
        if (s_cell[j] == cell) acc = combine<OP>(acc, s_val[j]);
      }
    }
    __syncthreads();
  }
  if (cell < n_cells) {
    const size_t o = (size_t)s * n_cells + cell;
    out[o] = (OP == kCount && init) ? acc + init[o] : acc;
  }
}

}  // namespace

extern "C" int window_agg_launch(const float* vals, const int32_t* slots,
                                 const uint8_t* mask, const int32_t* keys,
                                 const float* init, float* out, int S, int L,
                                 int W, int C, int op, cudaStream_t stream) {
  if (S <= 0 || W <= 0 || C <= 0 || L < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W * C + kCells - 1) / kCells, S);
  switch (op) {
    case kSum:
      window_agg_kernel<kSum><<<grid, kCells, 0, stream>>>(vals, slots, mask, keys, init, out, L, W, C);
      break;
    case kCount:
      window_agg_kernel<kCount><<<grid, kCells, 0, stream>>>(vals, slots, mask, keys, init, out, L, W, C);
      break;
    case kMax:
      window_agg_kernel<kMax><<<grid, kCells, 0, stream>>>(vals, slots, mask, keys, init, out, L, W, C);
      break;
    case kMin:
      window_agg_kernel<kMin><<<grid, kCells, 0, stream>>>(vals, slots, mask, keys, init, out, L, W, C);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
