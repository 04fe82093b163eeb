// Left fold of a counter's actor rows: the read of a windowed GCounter or
// PNCounter, and of the training-metrics lattice.
//
// No Pallas kernel: the JAX package reads these counters with
// jnp.sum(axis=0) over the actor rows (src/repro/core/crdt.py:63,82,108,
// 129), which XLA's CPU lowers to a sequential f32 left fold.  This kernel
// gives those bits on the card.
//
// Input f32 rows[S, P, K], with any strides over S and P and the key axis
// K contiguous: out[s, k] = (((r0 + r1) + r2) + ... + r_{P-1}), each add
// rounded on its own (__fadd_rn: nvcc may not contract it into an FMA, and
// there is no multiply to contract it with).  That is the plain version's
// P - 1 elementwise adds in the same order, so the card and the host give
// the same bits.  It equals jnp.sum except on a lane whose every row is
// -0.0, where XLA's fold from +0.0 reads +0.0; a counter's rows start at
// +0.0 and only add, so they never are.
//
// Bound on this card: it reads S*P*K floats and writes S*K, one add per
// float read, so device-memory bytes bound it.  Design: one thread per
// output lane, 256 to a block, threads along k, so each of the P row reads
// of a block is one coalesced load; the P adds of a lane are a dependent
// chain of P - 1 adds (about 4 cycles each), far below the load time at
// any P the system uses (at most 64 actors).  At the read shapes of the
// system (S*K of 16 to a few thousand lanes) it is one or a few blocks and
// bound by its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) actor_sum_kernel(
    const float* __restrict__ rows, float* __restrict__ out, int P, int64_t K, int64_t n,
    int64_t stride_s, int64_t stride_p) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const int64_t s = lane / K;
  const int64_t k = lane - s * K;
  const float* r = rows + s * stride_s + k;
  float acc = r[0];
  for (int p = 1; p < P; ++p) acc = __fadd_rn(acc, r[(int64_t)p * stride_p]);
  out[lane] = acc;
}

}  // namespace

extern "C" int actor_sum_launch(const float* rows, float* out, int S, int P, int64_t K,
                                int64_t stride_s, int64_t stride_p, cudaStream_t stream) {
  const int64_t n = (int64_t)S * K;
  if (S <= 0 || P <= 0 || K <= 0 || (n + kThreads - 1) / kThreads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  actor_sum_kernel<<<grid, kThreads, 0, stream>>>(rows, out, P, K, n, stride_s, stride_p);
  return (int)cudaGetLastError();
}
