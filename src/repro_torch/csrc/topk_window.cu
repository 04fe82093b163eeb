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
// lattice), as the Pallas kernel's k rounds of arg-max extraction do.  A
// row that no lane reaches comes back exactly as it went in.
//
// Bound on this card: the function reads each lane once (the mask byte,
// and the slot, value and id of a live lane) and the state rows, so
// device-memory bytes bound it; what costs time is the serial chain of k
// block-wide arg-max rounds a tile's slot takes.  Design: two kernels on
// the caller's stream, nothing kept between calls.
//
// 1. Tile phase, grid (tiles, S): a block reads its tile of kTile lanes
//    once, coalesced, kPerThread a thread, every field's load in flight at
//    once, and drops masked lanes.  It then walks the distinct slots of the
//    tile, smallest first (a block-wide min over the threads' lanes): for
//    each it takes up to k rounds of block-wide arg-max over each thread's
//    best lane of that slot, each round retiring every copy of the winner,
//    and writes the tile's top-k distinct pairs of the slot to a scratch
//    list, with a presence byte per (tile, slot).  A partition-ordered batch
//    puts one or two slots in a tile; any mix, up to every slot, is right.
// 2. Row phase, one warp per (replica, slot), kRowWarps to a block, by
//    programmatic dependent launch: a row no tile holds is copied;
//    otherwise each lane keeps its top-N distinct pairs (N = 8 for k <= 8,
//    else 16) of the state row and the present tiles' lists in registers,
//    and k rounds of warp arg-max by xor shuffles, each popping every copy
//    of the winner, give the row.  Any pair of the row's top k is in the
//    top k of the tile (or state row) that holds it, and in the top N >= k
//    of the lane that keeps it.
//
// Scratch (from the caller): tiles * W * k candidate pairs and tiles * W
// presence bytes a replica, tiles = ceil(L / kTile).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;  // lanes a tile block reads (wrapper: TILE)
constexpr int kTileThreads = 128;
constexpr int kPerThread = kTile / kTileThreads;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kMaxK = 16;  // (wrapper: K_MAX)
constexpr int kRowWarps = 8;  // rows a row-phase block merges
constexpr int kRowLoads = 4;  // candidate pairs a row-phase lane loads at once
constexpr int kNone = INT_MAX;  // slot of a dropped or consumed lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool above(float v1, int64_t i1, float v2, int64_t i2) {
  return v1 > v2 || (v1 == v2 && i1 > i2);
}

// every lane ends with the warp's largest (v, i): a total order, so the
// butterfly gives all lanes the same pair
__device__ __forceinline__ void warp_best(float& v, int64_t& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int64_t oi = __shfl_xor_sync(kFull, i, off);
    if (above(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// insert (v, id) into a descending list of N distinct pairs, dropping the last
template <int N>
__device__ __forceinline__ void keep(float (&kv)[N], int64_t (&ki)[N], float v, int64_t id) {
  if (!above(v, id, kv[N - 1], ki[N - 1])) return;
  bool dup = false;
#pragma unroll
  for (int j = 0; j < N; ++j) dup |= (kv[j] == v) & (ki[j] == id);
  if (dup) return;
  bool placed = false;
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
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

template <int N>
__device__ __forceinline__ void pop(float (&kv)[N], int64_t (&ki)[N]) {
#pragma unroll
  for (int j = 0; j + 1 < N; ++j) {
    kv[j] = kv[j + 1];
    ki[j] = ki[j + 1];
  }
  kv[N - 1] = -INFINITY;
  ki[N - 1] = 0;
}

__global__ void __launch_bounds__(kTileThreads) topk_tile_kernel(
    const float* __restrict__ vals, const int64_t* __restrict__ ids,
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ mask,
    float* __restrict__ cand_vals, int64_t* __restrict__ cand_ids,
    uint8_t* __restrict__ present, int L, int W, int k, int T) {
  __shared__ float s_val[2][kTileWarps];
  __shared__ int64_t s_id[2][kTileWarps];
  __shared__ int s_min[2][kTileWarps];

  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t lrow = (size_t)s * L;
  const size_t trow = ((size_t)s * T + t) * W;  // this tile's (slot) rows
  // the row phase may launch now: it waits for this grid before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int w = tid; w < W; w += kTileThreads) present[trow + w] = 0;

  // this thread's lanes, each field read once and all loads in flight
  // together (none waits on the mask); masked lanes and slots outside
  // [0, W) are dropped
  int ks[kPerThread];
  float kv[kPerThread];
  int64_t ki[kPerThread];
  bool on[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = t * kTile + j * kTileThreads + tid;
    const bool in = l < L;
    on[j] = in && mask[lrow + l];
    ks[j] = in ? slots[lrow + l] : kNone;
    kv[j] = in ? vals[lrow + l] : -INFINITY;
    ki[j] = in ? ids[lrow + l] : 0;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (!(on[j] && (unsigned)ks[j] < (unsigned)W)) {
      ks[j] = kNone;
      kv[j] = -INFINITY;
      ki[j] = 0;
    }
  }
  // shared buffers alternate between consecutive barriers, so a write
  // never meets a slower thread's read of the same buffer
  int par = 0;
  for (;;) {
    int m = ks[0];  // the smallest slot left in the tile
#pragma unroll
    for (int j = 1; j < kPerThread; ++j) m = min(m, ks[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) s_min[par][warp] = m;
    __syncthreads();
    int cur = s_min[par][0];
#pragma unroll
    for (int j = 1; j < kTileWarps; ++j) cur = min(cur, s_min[par][j]);
    par ^= 1;
    if (cur == kNone) break;

    const size_t crow = (trow + cur) * k;
    int r = 0;
    for (; r < k; ++r) {
      float bv = -INFINITY;  // this thread's best lane of the slot
      int64_t bi = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (ks[j] == cur && above(kv[j], ki[j], bv, bi)) {
          bv = kv[j];
          bi = ki[j];
        }
      }
      warp_best(bv, bi);
      if (lane == 0) {
        s_val[par][warp] = bv;
        s_id[par][warp] = bi;
      }
      __syncthreads();
      bv = s_val[par][0];
      bi = s_id[par][0];
#pragma unroll
      for (int j = 1; j < kTileWarps; ++j) {
        if (above(s_val[par][j], s_id[par][j], bv, bi)) {
          bv = s_val[par][j];
          bi = s_id[par][j];
        }
      }
      par ^= 1;
      if (bv == -INFINITY && bi == 0) break;  // nothing above the padding left
      if (tid == 0) {
        cand_vals[crow + r] = bv;
        cand_ids[crow + r] = bi;
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {  // retire every copy of the winner
        if (ks[j] == cur && kv[j] == bv && ki[j] == bi) ks[j] = kNone;
      }
    }
    for (int j = r + tid; j < k; j += kTileThreads) {
      cand_vals[crow + j] = -INFINITY;
      cand_ids[crow + j] = 0;
    }
    if (tid == 0) present[trow + cur] = 1;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {  // the slot's lanes below its top k
      if (ks[j] == cur) ks[j] = kNone;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kRowWarps * 32) topk_row_kernel(
    const float* __restrict__ state_vals, const int64_t* __restrict__ state_ids,
    const float* __restrict__ cand_vals, const int64_t* __restrict__ cand_ids,
    const uint8_t* __restrict__ present, float* __restrict__ out_vals,
    int64_t* __restrict__ out_ids, int S, int W, int k, int T) {
  __shared__ int s_tiles[kRowWarps][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;  // s * W + w
  if (row >= S * W) return;  // the whole warp
  const int s = row / W, w = row % W;
  const size_t srow = (size_t)row * k;

  float kv[N];
  int64_t ki[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    kv[j] = -INFINITY;
    ki[j] = 0;
  }
  // every warp waits for the tile phase (so this grid completes after
  // it) before it reads the presence bytes and the candidate lists
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  bool reached = false;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int tt = t0 + lane;
    const bool p = tt < T && present[((size_t)s * T + tt) * W + w];
    const unsigned bits = __ballot_sync(kFull, p);
    if (bits == 0) continue;
    if (!reached) {
      reached = true;
      for (int j = lane; j < k; j += 32) keep(kv, ki, state_vals[srow + j], state_ids[srow + j]);
    }
    if (p) s_tiles[warp][__popc(bits & ((1u << lane) - 1))] = tt;
    __syncwarp();
    const int n = __popc(bits) * k;
    for (int q0 = 0; q0 < n; q0 += kRowLoads * 32) {  // loads in flight together
      float cv[kRowLoads];
      int64_t ci[kRowLoads];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int q = q0 + u * 32 + lane;
        cv[u] = -INFINITY;
        ci[u] = 0;
        if (q < n) {
          const size_t c = (((size_t)s * T + s_tiles[warp][q / k]) * W + w) * k + q % k;
          cv[u] = cand_vals[c];
          ci[u] = cand_ids[c];
        }
      }
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) keep(kv, ki, cv[u], ci[u]);
    }
    __syncwarp();
  }
  if (!reached) {  // no lane of this slot: the row comes back as it went in
    for (int j = lane; j < k; j += 32) {
      out_vals[srow + j] = state_vals[srow + j];
      out_ids[srow + j] = state_ids[srow + j];
    }
    return;
  }
  int r = 0;
  for (; r < k; ++r) {
    float bv = kv[0];
    int64_t bi = ki[0];
    warp_best(bv, bi);
    if (bv == -INFINITY && bi == 0) break;  // only padding left
    if (lane == 0) {
      out_vals[srow + r] = bv;
      out_ids[srow + r] = bi;
    }
    if (kv[0] == bv && ki[0] == bi) pop(kv, ki);  // a lane's pairs are distinct
  }
  for (int j = r + lane; j < k; j += 32) {
    out_vals[srow + j] = -INFINITY;
    out_ids[srow + j] = 0;
  }
}

}  // namespace

extern "C" int topk_window_launch(const float* state_vals, const int64_t* state_ids,
                                  const float* vals, const int64_t* ids,
                                  const int32_t* slots, const uint8_t* mask,
                                  float* cand_vals, int64_t* cand_ids, uint8_t* present,
                                  float* out_vals, int64_t* out_ids, int S, int L, int W,
                                  int k, cudaStream_t stream) {
  if (S <= 0 || W <= 0 || k <= 0 || k > kMaxK || L < 0 || S > 65535)
    return (int)cudaErrorInvalidValue;
  const int T = (L + kTile - 1) / kTile;
  if (T > 0) {
    topk_tile_kernel<<<dim3(T, S), kTileThreads, 0, stream>>>(
        vals, ids, slots, mask, cand_vals, cand_ids, present, L, W, k, T);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // the row phase by programmatic dependent launch: it starts once every
  // tile block has begun, and each of its warps waits for the tile grid
  const int rows = S * W;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kRowWarps - 1) / kRowWarps);
  cfg.blockDim = dim3(kRowWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = T > 0 ? 1 : 0;
  const cudaError_t err =
      k <= 8 ? cudaLaunchKernelEx(&cfg, topk_row_kernel<8>, state_vals, state_ids,
                                  (const float*)cand_vals, (const int64_t*)cand_ids,
                                  (const uint8_t*)present, out_vals, out_ids, S, W, k, T)
             : cudaLaunchKernelEx(&cfg, topk_row_kernel<kMaxK>, state_vals, state_ids,
                                  (const float*)cand_vals, (const int64_t*)cand_ids,
                                  (const uint8_t*)present, out_vals, out_ids, S, W, k, T);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
