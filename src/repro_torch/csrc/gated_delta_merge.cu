// Slot-gated join of R delta replicas: the merge side of delta sync.
//
// Replaces the Pallas kernel src/repro/kernels/crdt_merge.py:
// gated_delta_merge_pallas (body _gated_kernel).
//
// Input wid int32[R, W] (each replica's ring tenant per slot, -1 = clean)
// and leaf T[R, W, F]; output T[W, F].  Per slot w, only replicas whose wid
// equals the slot's max wid contribute; the rest are gated to the join
// identity.  A slot clean on every replica copies replica 0.  Joins: max and
// min over float and int32, max / min / bitwise-or over uint8.  Every join
// is exact, so the result is bitwise that of the plain version.
//
// Bound on this card: it reads R*W*F elements and R*W wids and writes W*F
// elements with one compare per element read, so device-memory bytes bound
// it.  Design: one block per (slot, tile of 128 features); threads run along
// F, so each replica's row is one coalesced read.  The block stages the
// slot's R wids in shared memory with R parallel loads and computes the
// slot's max wid once; each thread then walks the replicas in a fixed order
// and reads only the rows that pass the gate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

enum Op { kMax = 0, kMin = 1, kOr = 2 };
enum DType { kF32 = 0, kI32 = 1, kU8 = 2 };

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float lowest() { return -INFINITY; }
  __device__ static float highest() { return INFINITY; }
};
template <> struct Limits<int32_t> {
  __device__ static int32_t lowest() { return INT32_MIN; }
  __device__ static int32_t highest() { return INT32_MAX; }
};
template <> struct Limits<uint8_t> {
  __device__ static uint8_t lowest() { return 0; }
  __device__ static uint8_t highest() { return 255; }
};

template <typename T, int OP>
__device__ __forceinline__ T identity() {
  if constexpr (OP == kMax) return Limits<T>::lowest();
  else if constexpr (OP == kMin) return Limits<T>::highest();
  else return T(0);
}

template <typename T, int OP>
__device__ __forceinline__ T join(T a, T b) {
  if constexpr (OP == kMax) return b > a ? b : a;
  else if constexpr (OP == kMin) return b < a ? b : a;
  else return (T)(a | b);
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) gated_merge_kernel(
    const int32_t* __restrict__ wid, const T* __restrict__ leaf,
    T* __restrict__ out, int R, int W, int F) {
  extern __shared__ int32_t s_wid[];  // [R]: the slot's tenant on each replica
  __shared__ int32_t s_top;
  const int w = blockIdx.y;
  const int f = blockIdx.x * kThreads + threadIdx.x;
  for (int r = threadIdx.x; r < R; r += kThreads) s_wid[r] = wid[(size_t)r * W + w];
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t top = INT32_MIN;
    for (int r = 0; r < R; ++r) top = max(top, s_wid[r]);
    s_top = top;
  }
  __syncthreads();
  const int32_t top = s_top;
  if (f >= F) return;
  const size_t o = (size_t)w * F + f;
  if (top < 0) {  // clean on every replica: the deterministic zero state
    out[o] = leaf[o];
    return;
  }
  T acc = identity<T, OP>();
  for (int r = 0; r < R; ++r) {
    if (s_wid[r] == top) acc = join<T, OP>(acc, leaf[(size_t)r * W * F + o]);
  }
  out[o] = acc;
}

template <typename T, int OP>
int launch(const int32_t* wid, const void* leaf, void* out, int R, int W, int F,
           cudaStream_t stream) {
  const dim3 grid((F + kThreads - 1) / kThreads, W);
  gated_merge_kernel<T, OP><<<grid, kThreads, R * sizeof(int32_t), stream>>>(
      wid, static_cast<const T*>(leaf), static_cast<T*>(out), R, W, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gated_delta_merge_launch(const int32_t* wid, const void* leaf,
                                        void* out, int R, int W, int F,
                                        int dtype, int op, cudaStream_t stream) {
  if (R <= 0 || W <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32 && op == kMax) return launch<float, kMax>(wid, leaf, out, R, W, F, stream);
  if (dtype == kF32 && op == kMin) return launch<float, kMin>(wid, leaf, out, R, W, F, stream);
  if (dtype == kI32 && op == kMax) return launch<int32_t, kMax>(wid, leaf, out, R, W, F, stream);
  if (dtype == kI32 && op == kMin) return launch<int32_t, kMin>(wid, leaf, out, R, W, F, stream);
  if (dtype == kU8 && op == kMax) return launch<uint8_t, kMax>(wid, leaf, out, R, W, F, stream);
  if (dtype == kU8 && op == kMin) return launch<uint8_t, kMin>(wid, leaf, out, R, W, F, stream);
  if (dtype == kU8 && op == kOr) return launch<uint8_t, kOr>(wid, leaf, out, R, W, F, stream);
  return (int)cudaErrorInvalidValue;
}
