// Elementwise lattice join of a replica stack over its replica axis.
//
// Replaces the Pallas kernel src/repro/kernels/crdt_merge.py:
// crdt_merge_pallas (body _kernel).
//
// Input T[R, F].  Two output modes of one launch function:
//   - rows = 0, the Pallas function's counterpart: T[F],
//     out[f] = join_{r = 0 .. R-1, in order} x[r, f];
//   - rows = 1, the keyed watermark exchange (StackMesh.pmax): T[R, F],
//     out[s, f] = on ? join_r x[r, f] : x[s, f] for every row s, where
//     `on` is a device byte read by the kernel (null: on), so the host
//     never waits for the gate.
// Joins: max and min over float and int32, and max / min / bitwise-or over
// uint8 (bool enters as uint8).  Every join is exact, so the result is
// bitwise that of the plain version.
//
// Bound on this card: it reads R*F elements and writes F with one join per
// element read, so device-memory bytes bound it.  Design: one thread per
// output element, 256 to a block; threads run along F, so each replica's
// row is one coalesced read, and the kernel masks its own ragged edge (no
// padding of F, unlike the Pallas kernel's 1024-lane tiles).  At the
// dataplane's shapes (F of 16 to 64) it is one block and launch-bound, so
// the rows mode does the exchange's join, broadcast and gate in that one
// launch, where the caller used to add a copy and a select.

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

template <typename T, int OP, bool ROWS>
__global__ void __launch_bounds__(kThreads) crdt_merge_kernel(
    const T* __restrict__ stack, T* __restrict__ out, const uint8_t* __restrict__ on,
    int R, int64_t F) {
  const int64_t f = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  T acc = stack[f];
  for (int r = 1; r < R; ++r) acc = join<T, OP>(acc, stack[(int64_t)r * F + f]);
  if constexpr (!ROWS) {
    out[f] = acc;
  } else {
    const bool gate = on == nullptr || *on != 0;
    for (int s = 0; s < R; ++s) out[(int64_t)s * F + f] = gate ? acc : stack[(int64_t)s * F + f];
  }
}

template <typename T, int OP>
int launch(const void* stack, void* out, const uint8_t* on, int R, int64_t F, int rows,
           cudaStream_t stream) {
  const int64_t grid = (F + kThreads - 1) / kThreads;
  const T* x = static_cast<const T*>(stack);
  if (rows)
    crdt_merge_kernel<T, OP, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        x, static_cast<T*>(out), on, R, F);
  else
    crdt_merge_kernel<T, OP, false><<<(unsigned)grid, kThreads, 0, stream>>>(
        x, static_cast<T*>(out), on, R, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crdt_merge_launch(const void* stack, void* out, const uint8_t* on, int R,
                                 int64_t F, int dtype, int op, int rows, cudaStream_t stream) {
  if (R <= 0 || F <= 0 || (F + kThreads - 1) / kThreads > 0x7fffffff || (on && !rows))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32 && op == kMax) return launch<float, kMax>(stack, out, on, R, F, rows, stream);
  if (dtype == kF32 && op == kMin) return launch<float, kMin>(stack, out, on, R, F, rows, stream);
  if (dtype == kI32 && op == kMax) return launch<int32_t, kMax>(stack, out, on, R, F, rows, stream);
  if (dtype == kI32 && op == kMin) return launch<int32_t, kMin>(stack, out, on, R, F, rows, stream);
  if (dtype == kU8 && op == kMax) return launch<uint8_t, kMax>(stack, out, on, R, F, rows, stream);
  if (dtype == kU8 && op == kMin) return launch<uint8_t, kMin>(stack, out, on, R, F, rows, stream);
  if (dtype == kU8 && op == kOr) return launch<uint8_t, kOr>(stack, out, on, R, F, rows, stream);
  return (int)cudaErrorInvalidValue;
}
