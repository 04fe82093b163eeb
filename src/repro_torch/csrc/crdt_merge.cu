// Elementwise lattice join of a replica stack over its replica axis.
//
// Replaces the Pallas kernel src/repro/kernels/crdt_merge.py:
// crdt_merge_pallas (body _kernel).
//
// Input T[R, F], output T[F]: out[f] = join_{r = 0 .. R-1, in order} x[r, f]
// for max and min over float and int32, and max / min / bitwise-or over
// uint8 (bool enters as uint8).  Every join is exact, so the result is
// bitwise that of the plain version.
//
// Bound on this card: it reads R*F elements and writes F with one join per
// element read, so device-memory bytes bound it.  Design: one thread per
// output element, 256 to a block; threads run along F, so each replica's
// row is one coalesced read, and the kernel masks its own ragged edge (no
// padding of F, unlike the Pallas kernel's 1024-lane tiles).  At the
// dataplane's shapes (F of 16 to 64) it is one block and launch-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Op { kMax = 0, kMin = 1, kOr = 2 };
enum DType { kF32 = 0, kI32 = 1, kU8 = 2 };

template <typename T, int OP>
__device__ __forceinline__ T join(T a, T b) {
  if constexpr (OP == kMax) return b > a ? b : a;
  else if constexpr (OP == kMin) return b < a ? b : a;
  else return (T)(a | b);
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) crdt_merge_kernel(
    const T* __restrict__ stack, T* __restrict__ out, int R, int64_t F) {
  const int64_t f = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  T acc = stack[f];
  for (int r = 1; r < R; ++r) acc = join<T, OP>(acc, stack[(int64_t)r * F + f]);
  out[f] = acc;
}

template <typename T, int OP>
int launch(const void* stack, void* out, int R, int64_t F, cudaStream_t stream) {
  const int64_t grid = (F + kThreads - 1) / kThreads;
  crdt_merge_kernel<T, OP><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(stack), static_cast<T*>(out), R, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crdt_merge_launch(const void* stack, void* out, int R, int64_t F,
                                 int dtype, int op, cudaStream_t stream) {
  if (R <= 0 || F <= 0 || (F + kThreads - 1) / kThreads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32 && op == kMax) return launch<float, kMax>(stack, out, R, F, stream);
  if (dtype == kF32 && op == kMin) return launch<float, kMin>(stack, out, R, F, stream);
  if (dtype == kI32 && op == kMax) return launch<int32_t, kMax>(stack, out, R, F, stream);
  if (dtype == kI32 && op == kMin) return launch<int32_t, kMin>(stack, out, R, F, stream);
  if (dtype == kU8 && op == kMax) return launch<uint8_t, kMax>(stack, out, R, F, stream);
  if (dtype == kU8 && op == kMin) return launch<uint8_t, kMin>(stack, out, R, F, stream);
  if (dtype == kU8 && op == kOr) return launch<uint8_t, kOr>(stack, out, R, F, stream);
  return (int)cudaErrorInvalidValue;
}
