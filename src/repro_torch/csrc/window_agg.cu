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
// A count counts the batch's lanes from zero (as a sequential f32 count
// does: exact up to 2^24, then stuck) and adds init once, as the JAX
// package's kernels do.
//
// Bound on this card: the function reads each lane once (13 bytes: value,
// slot, key, mask) and writes W*C floats per replica, so it is bound by
// device-memory bytes; at the dataplane's shapes that is about 2 us.  The
// lane order of a sum is the other floor: a cell's lanes are one chain of
// dependent adds (4.11 cycles each, measured on an H100 at 1.98 GHz), so a
// cell that takes all 16,384 lanes of a replica needs about 34 us however
// the work is spread.
//
// Design: one block of 512 threads per (replica, range of up to 512 cells,
// one a thread).  The block streams its replica's lanes in tiles of 4,096
// (8 a thread, coalesced, the next tile's loads in flight while the current
// one folds).  A tile with no lane in the block's range is skipped after
// one block-wide vote.  A tile with hits is counting-sorted by cell,
// stably, in shared memory:
//   1. each warp takes 256 consecutive lanes, 32 at a time; lanes of one
//      cell find each other by one ballot per bit of the cell index (a
//      fixed cost, where __match_any_sync slows with every distinct cell in
//      the warp), rank themselves by the peers below them, and the lowest
//      adds the group to the warp's count of that cell (a [16 warps x
//      cells] table of u16, no atomics);
//   2. a column scan of the table gives each warp its offset within a cell,
//      a block scan of the cell totals each cell's start;
//   3. every lane goes to start[cell] + warp offset + rank: lane order kept.
// Each thread then folds the run of its own cell in order, its shared loads
// 16 bytes wide and a group ahead of the adds, carrying the running value in
// a register from tile to tile, so a cell's chain is init and its lanes in
// lane order across all tiles, and all chains of a tile run at once.
// Serial work per thread: the lanes of its cell plus L / 512, instead of L.
// No atomics on floats: the same bits every run.  A block that no lane
// reaches only copies init.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                      // lanes per thread per tile
constexpr int kTile = kThreads * kPer;       // lanes per tile
constexpr int kWarpLanes = 32 * kPer;        // consecutive lanes per warp
constexpr int kRange = kThreads;             // cells per block (1 a thread)

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

// Issue the loads of one tile's lanes (this thread's 8; past L: masked).
template <int OP>
__device__ __forceinline__ void load_tile(
    const float* __restrict__ vals, const int32_t* __restrict__ slots,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ keys,
    size_t row, int L, int lane0, uint8_t m[kPer], int32_t sl[kPer],
    int32_t ky[kPer], float v[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int l = lane0 + j * 32;
    const bool ok = l < L;
    m[j] = ok ? mask[row + l] : 0;
    sl[j] = ok ? slots[row + l] : 0;
    ky[j] = (ok && keys) ? keys[row + l] : 0;
    v[j] = (ok && OP != kCount) ? vals[row + l] : 0.0f;
  }
}

// Fold s[a, a + n) into acc in order.  After a head up to a 16-byte
// boundary the values come four to a load, and each register of a group of
// kGroup is reloaded with the values kGroup lanes ahead right after its adds
// read it, so the loads fly while the adds run: only the adds are serial.
constexpr int kGroup = 16;

template <int OP>
__device__ __forceinline__ float fold_run(float acc, const float* s, int a, int n) {
  int i = a;
  const int e = a + n;
  for (; i < e && (reinterpret_cast<uintptr_t>(s + i) & 15); ++i)
    acc = combine<OP>(acc, s[i]);
  if (e - i >= kGroup) {
    float4 x[kGroup / 4];
#pragma unroll
    for (int k = 0; k < kGroup / 4; ++k) x[k] = *reinterpret_cast<const float4*>(s + i + 4 * k);
    for (i += kGroup; e - i >= kGroup; i += kGroup) {
#pragma unroll
      for (int k = 0; k < kGroup / 4; ++k) {
        acc = combine<OP>(acc, x[k].x);
        acc = combine<OP>(acc, x[k].y);
        acc = combine<OP>(acc, x[k].z);
        acc = combine<OP>(acc, x[k].w);
        x[k] = *reinterpret_cast<const float4*>(s + i + 4 * k);
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup / 4; ++k) {
      acc = combine<OP>(acc, x[k].x);
      acc = combine<OP>(acc, x[k].y);
      acc = combine<OP>(acc, x[k].z);
      acc = combine<OP>(acc, x[k].w);
    }
  }
  for (; i < e; ++i) acc = combine<OP>(acc, s[i]);
  return acc;
}

template <int OP>
__global__ void __launch_bounds__(kThreads) window_agg_kernel(
    const float* __restrict__ vals, const int32_t* __restrict__ slots,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ keys,
    const float* __restrict__ init, float* __restrict__ out,
    int L, int W, int C) {
  __shared__ __align__(16) uint16_t s_cnt[kWarps][kRange];  // per-warp counts
  __shared__ __align__(16) float s_sorted[kTile];
  __shared__ int s_start[kRange], s_len[kRange], s_wsum[kWarps];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const unsigned lt = (1u << ln) - 1u;
  const int s = blockIdx.y;
  const int n_cells = W * C;
  const int cell0 = blockIdx.x * kRange;
  const int n_here = min(kRange, n_cells - cell0);  // the last range may be ragged
  const int bits = n_here > 1 ? 32 - __clz(n_here - 1) : 0;  // of a cell index
  const size_t row = (size_t)s * L;
  const size_t orow = (size_t)s * n_cells + cell0;

  // this thread's cell tid of the range, its running value in a register
  float acc = neutral<OP>();
  int cnt = 0;
  if (OP != kCount && init && tid < n_here) acc = init[orow + tid];

  uint8_t m[kPer];
  int32_t sl[kPer], ky[kPer];
  float v[kPer];
  const int lane_off = warp * kWarpLanes + ln;
  if (L > 0) load_tile<OP>(vals, slots, mask, keys, row, L, lane_off, m, sl, ky, v);
  for (int base = 0; base < L; base += kTile) {
    int cell[kPer];
    float x[kPer];
    int hit = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int c = m[j] ? sl[j] * C + ky[j] - cell0 : -1;
      c = (c >= 0 && c < n_here) ? c : -1;
      cell[j] = c;
      x[j] = v[j];
      hit |= c >= 0;
    }
    const bool more = base + kTile < L;
    if (!__syncthreads_or(hit)) {
      if (more) load_tile<OP>(vals, slots, mask, keys, row, L, base + kTile + lane_off, m, sl, ky, v);
      continue;
    }
    // 1. per-warp counts and each lane's rank within its warp
    {
      uint4* z = reinterpret_cast<uint4*>(&s_cnt[0][0]);
      for (int i = tid; i < (int)(sizeof(s_cnt) / 16); i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    int rank[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = cell[j];
      // the lanes of this step that hold the same cell: valid, and equal on
      // every bit of the index
      unsigned peers = __ballot_sync(0xffffffffu, c >= 0);
      for (int b = 0; b < bits; ++b) {
        const bool one = (c >> b) & 1;
        const unsigned on = __ballot_sync(0xffffffffu, one);
        peers &= one ? on : ~on;
      }
      int before = 0;
      if (c >= 0) before = s_cnt[warp][c];
      rank[j] = before + __popc(peers & lt);
      __syncwarp();
      if (c >= 0 && (peers & lt) == 0) s_cnt[warp][c] = (uint16_t)(before + __popc(peers));
      __syncwarp();
    }
    __syncthreads();
    // 2. column scan: warp offsets within each cell; block scan: cell starts
    int tot = 0;
    if (tid < n_here) {
      int t[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t[w] = s_cnt[w][tid];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s_cnt[w][tid] = (uint16_t)tot;
        tot += t[w];
      }
    }
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (ln >= off) incl += y;
    }
    if (ln == 31) s_wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = ln < kWarps ? s_wsum[ln] : 0;
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (ln >= off) w += y;
      }
      if (ln < kWarps) s_wsum[ln] = w;
    }
    __syncthreads();
    const int start = incl - tot + (warp > 0 ? s_wsum[warp - 1] : 0);
    if (tid < n_here) {
      s_start[tid] = start;
      s_len[tid] = tot;
    }
    __syncthreads();
    // 3. place every hit lane at its cell's start + warp offset + rank
    if (OP != kCount) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = cell[j];
        if (c >= 0) s_sorted[s_start[c] + s_cnt[warp][c] + rank[j]] = x[j];
      }
    }
    __syncthreads();
    // the next tile's loads fly while this one folds
    if (more) load_tile<OP>(vals, slots, mask, keys, row, L, base + kTile + lane_off, m, sl, ky, v);
    // 4. each thread folds its cell's run, in lane order
    if (tid < n_here) {
      if (OP == kCount) cnt += tot;
      else acc = fold_run<OP>(acc, s_sorted, start, tot);
    }
    __syncthreads();
  }
  if (tid < n_here) {
    if (OP == kCount) {
      // a sequential f32 count: exact to 2^24, then adding 1 rounds back
      acc = cnt < (1 << 24) ? (float)cnt : 16777216.0f;
      if (init) acc = acc + init[orow + tid];
    }
    out[orow + tid] = acc;
  }
}

}  // namespace

extern "C" int window_agg_launch(const float* vals, const int32_t* slots,
                                 const uint8_t* mask, const int32_t* keys,
                                 const float* init, float* out, int S, int L,
                                 int W, int C, int op, cudaStream_t stream) {
  if (S <= 0 || W <= 0 || C <= 0 || L < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W * C + kRange - 1) / kRange, S);
  switch (op) {
    case kSum:
      window_agg_kernel<kSum><<<grid, kThreads, 0, stream>>>(vals, slots, mask, keys, init, out, L, W, C);
      break;
    case kCount:
      window_agg_kernel<kCount><<<grid, kThreads, 0, stream>>>(vals, slots, mask, keys, init, out, L, W, C);
      break;
    case kMax:
      window_agg_kernel<kMax><<<grid, kThreads, 0, stream>>>(vals, slots, mask, keys, init, out, L, W, C);
      break;
    case kMin:
      window_agg_kernel<kMin><<<grid, kThreads, 0, stream>>>(vals, slots, mask, keys, init, out, L, W, C);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
