// Per-window bounded top-k merge of event lanes (Q7 "highest bids").
//
// Replaces the Pallas kernel src/repro/kernels/topk_window.py:
// topk_window_pallas (body _kernel).
//
// Input: per replica s and ring slot w the running top-k row
// (state_vals f32[S, W, k] descending, state_ids i64[S, W, k]) and the
// replica's lanes (vals f32[S, L], ids i64[S, L], slots i32[S, L],
// mask bool[S, L]).  Output: the k largest distinct (val, id) pairs among
// the state row and the lanes with mask and slots == w, descending by
// (val, id) with the larger id winning a tie on the value, padded with
// (-inf, 0).  Exact duplicate pairs collapse (the set semantics of the TopK
// lattice), as the Pallas kernel's k rounds of arg-max extraction do.
//
// Bound on this card: the function reads each lane once (17 bytes) and the
// state rows, so device-memory bytes bound it.  Design: one block per
// (slot, replica).  Each thread scans a strided share of the replica's
// lanes and keeps its own top-16 distinct pairs in registers (insertion into
// a sorted list that is fully unrolled, so it stays in registers).  Any pair
// of the block's top k is in the top 16 of the thread that saw it, so the
// block then needs only k rounds of a block-wide lexicographic arg-max over
// the 128 * 16 kept pairs in shared memory; each round removes every copy of
// the winner.  Blocks of slots that no lane reaches do the same k rounds on
// their state row alone, which returns the row unchanged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kKeep = 16;  // pairs kept per thread; k <= kKeep
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool above(float v1, int64_t i1, float v2, int64_t i2) {
  return v1 > v2 || (v1 == v2 && i1 > i2);
}

__device__ __forceinline__ void keep(float (&kv)[kKeep], int64_t (&ki)[kKeep],
                                     float v, int64_t id) {
  if (!above(v, id, kv[kKeep - 1], ki[kKeep - 1])) return;
  bool dup = false;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) dup |= (kv[j] == v) & (ki[j] == id);
  if (dup) return;
  bool placed = false;
#pragma unroll
  for (int j = kKeep - 1; j >= 0; --j) {
    if (!placed) {
      if (j > 0 && above(v, id, kv[j - 1], ki[j - 1])) {
        kv[j] = kv[j - 1];
        ki[j] = ki[j - 1];
      } else {
        kv[j] = v;
        ki[j] = id;
        placed = true;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) topk_window_kernel(
    const float* __restrict__ state_vals, const int64_t* __restrict__ state_ids,
    const float* __restrict__ vals, const int64_t* __restrict__ ids,
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ mask,
    float* __restrict__ out_vals, int64_t* __restrict__ out_ids,
    int L, int W, int k) {
  __shared__ float c_val[kKeep * kThreads];
  __shared__ int64_t c_id[kKeep * kThreads];
  __shared__ float w_val[kWarps];
  __shared__ int64_t w_id[kWarps];

  const int w = blockIdx.x;
  const int s = blockIdx.y;
  const int t = threadIdx.x;
  const size_t srow = ((size_t)s * W + w) * k;
  const size_t lrow = (size_t)s * L;

  float kv[kKeep];
  int64_t ki[kKeep];
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    kv[j] = -INFINITY;
    ki[j] = 0;
  }
  for (int j = t; j < k; j += kThreads) keep(kv, ki, state_vals[srow + j], state_ids[srow + j]);
  for (int j = t; j < L; j += kThreads) {
    if (mask[lrow + j] && slots[lrow + j] == w) keep(kv, ki, vals[lrow + j], ids[lrow + j]);
  }
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    c_val[j * kThreads + t] = kv[j];
    c_id[j * kThreads + t] = ki[j];
  }
  __syncthreads();

  for (int r = 0; r < k; ++r) {
    float bv = c_val[t];
    int64_t bi = c_id[t];
    for (int j = 1; j < kKeep; ++j) {
      const float v = c_val[j * kThreads + t];
      const int64_t i = c_id[j * kThreads + t];
      if (above(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, bv, off);
      const int64_t i = __shfl_down_sync(0xffffffffu, bi, off);
      if (above(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    if ((t & 31) == 0) {
      w_val[t >> 5] = bv;
      w_id[t >> 5] = bi;
    }
    __syncthreads();
    bv = w_val[0];
    bi = w_id[0];
    for (int j = 1; j < kWarps; ++j) {
      if (above(w_val[j], w_id[j], bv, bi)) {
        bv = w_val[j];
        bi = w_id[j];
      }
    }
    if (t == 0) {
      out_vals[srow + r] = bv;
      out_ids[srow + r] = bi;
    }
    for (int j = 0; j < kKeep; ++j) {  // take every copy of the winner
      const int c = j * kThreads + t;
      if (c_val[c] == bv && c_id[c] == bi) {
        c_val[c] = -INFINITY;
        c_id[c] = 0;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int topk_window_launch(const float* state_vals, const int64_t* state_ids,
                                  const float* vals, const int64_t* ids,
                                  const int32_t* slots, const uint8_t* mask,
                                  float* out_vals, int64_t* out_ids, int S, int L,
                                  int W, int k, cudaStream_t stream) {
  if (S <= 0 || W <= 0 || k <= 0 || k > kKeep || L < 0) return (int)cudaErrorInvalidValue;
  topk_window_kernel<<<dim3(W, S), kThreads, 0, stream>>>(
      state_vals, state_ids, vals, ids, slots, mask, out_vals, out_ids, L, W, k);
  return (int)cudaGetLastError();
}
