// Ring bookkeeping of a dense fold step: wcrdt.insert(owned=True) in one launch.
//
// No Pallas kernel: in the JAX package this is the chain of XLA ops that
// wcrdt.insert runs around the fold (src/repro/core/wcrdt.py insert).  In
// the port that chain was some forty eager torch ops a step, and its slot
// reset rebuilt every window leaf with a torch.where against fresh zeros:
// 655 MB read and written a step at Nexmark q5's dense shape, to reset the
// one or two slots a step advances, if any.  This launch computes the same
// results and writes only what changes.
//
// For each replica s, with p = part[s], its batch index bi, and every
// event b of its batch ts[s, B], mask[s, B]:
//   live     = mask && (!gated || bi >= folded[s, p]) && !late,
//   late     = mask && (!gated || bi >= folded[s, p]) && ts < progress[s, p];
//   lane b*K + k (K = window_len / hop, k = 0 the newest window):
//     wid = floor(ts / hop) - k, on = live && (K == 1 || wid >= 0),
//     slot = wid mod W (in [0, W));
//   tenant[w] = max(slot_wid[s, w], wid of every lane that is on in slot w);
//   advancing[w] = tenant[w] > slot_wid[s, w]; each window leaf's row
//     [s, w, :] of an advancing slot is set to the leaf's fill (its zero);
//   evicted incomplete: advancing && old >= 0 && old >= first_dirty_wid(
//     min_p progress[s, p]), old = slot_wid[s, w];
//   stale = on && wid < tenant[slot]; valid = on && !stale;
//   errors[s] += (late, stale, evicted incomplete) counts;
//   folded[s, p] = max(folded[s, p], bi + 1) when gated.
// Outputs: slot i32[S, B*K] and valid bool[S, B*K] for the fold that
// follows, and new slot_wid[S, W], folded[S, P], errors[S, 3]; the inputs
// other than the leaves are left as they were (the dataplane's sync
// baselines are references to folded and progress).  i32 arithmetic wraps
// as torch's does.  Every output is an integer or a copied fill, so it is
// bitwise that of the plain version (kernels/ref.py ring_insert_ref) given
// slot_wid >= -1, which every state holds (-1 marks an empty slot).
//
// Bound on this card: neither bytes nor operations.  At q5's dense shape
// (S = 16, B = 16,384, K = 2, W = 64) it reads 1.3 MB and writes 2.6 MB,
// about 1.2 us at 3.35 TB/s, plus 640 KB a leaf for each slot that
// advances (one step in about 190).  What it saves is the host's dispatch
// of the op chain and the whole-state passes.
//
// Design: one cluster of Q blocks a replica (Q = B / 2,048, from 1 to 8),
// so that a replica's 32,768 lanes spread over eight SMs instead of one.
//   1. Rank 0 of the cluster stages the old tenants in shared memory, the
//      first dirty window of the global watermark (one warp's min over the
//      progress map) and writes the new folded row.  Cluster barrier.
//   2. Each block takes a contiguous share of the events, in tiles of
//      2,048 (eight a thread, loaded together: the loads' latency is paid
//      once a tile, not once an event), and takes the max wid per slot
//      into its own shared cells: a batch's lanes crowd into
//      a few slots, so each warp first groups its lanes by slot
//      (__match_any_sync) and reduces each group (__reduce_max_sync), and
//      one lane a group does the shared atomicMax.  The block then joins
//      its cells into rank 0's through distributed shared memory (at most
//      W remote atomics a block).  Cluster barrier.
//   3. Every block reads the W tenants back from rank 0, resets its share
//      of each advancing slot's rows (16-byte stores where the row allows),
//      then loads its events again (from L2: 80 KB a replica) and writes
//      each lane's slot and valid flag, counting the stale lanes.  Counts
//      go to rank 0 by remote atomicAdd.  Cluster barrier (no block leaves
//      while another may still touch its shared memory); rank 0 writes the
//      errors.
// Lanes keep their order, and nothing here adds a float.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 1024;
constexpr int kMaxLeaves = 4;
constexpr int kPer = 8;                // events a thread loads at once
constexpr int kTile = kThreads * kPer;  // events a block takes at once
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kDescHead = 24;

struct Args {
  int S, B, W, P, K, hop, window_len, gated;
  const long long* part;
  long long part_scalar;
  const long long* bidx;
  long long bidx_scalar;
  const int32_t* ts;
  const bool* mask;
  const int32_t* slot_wid;
  const int32_t* progress;
  const int32_t* folded;
  const int32_t* errors;
  int32_t* slot;
  bool* valid;
  int32_t* out_wid;
  int32_t* out_folded;
  int32_t* out_errors;
  int n_leaves;
  float* leaf[kMaxLeaves];
  long long row[kMaxLeaves];  // floats of one slot of one replica
  float fill[kMaxLeaves];
};

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__device__ __forceinline__ int floor_div(int a, int d) {  // d > 0
  const int q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int pos_mod(int a, int d) {
  const int r = a % d;
  return r < 0 ? r + d : r;
}

// A thread's kPer events of one tile of its block's share: event j is
// b = base + j * kThreads + tid, so each j is one coalesced load, and the
// kPer loads are in flight together.  Bit j of live / late is event j's.
struct Events {
  unsigned live, late;
  int hi[kPer];  // the newest window id
};

__device__ __forceinline__ Events load_events(const Args& a, int s, int base, int e1, int pf,
                                              int pp, int bi) {
  int t[kPer];
  bool m[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = base + j * kThreads + (int)threadIdx.x;
    const size_t i = (size_t)s * a.B + b;
    t[j] = b < e1 ? a.ts[i] : 0;
    m[j] = b < e1 && a.mask[i];
  }
  Events e = {0u, 0u, {}};
  const bool gate = !a.gated || bi >= pf;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool mm = m[j] && gate;
    const bool late = mm && t[j] < pp;
    e.late |= (unsigned)late << j;
    e.live |= (unsigned)(mm && !late) << j;
    e.hi[j] = floor_div(t[j], a.hop);
  }
  return e;
}

// The block's sum of v, in thread 0.  Every thread calls it.
__device__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  int t = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kThreads) ring_insert_kernel(const __grid_constant__ Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int Q = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int s = blockIdx.x / Q;
  const int W = a.W, K = a.K, tid = threadIdx.x, lane = tid % 32;
  __shared__ int top[kMaxSlots];   // rank 0: the tenants, raised to the batch's max
  __shared__ int mine[kMaxSlots];  // this block's max per slot, then the new tenants
  __shared__ unsigned char adv[kMaxSlots];
  __shared__ int counts[3];        // rank 0: late, stale, evicted incomplete
  __shared__ int gwid_s;           // rank 0: first dirty window of the global watermark
  __shared__ int red[kWarps];

  const int32_t* old = a.slot_wid + (size_t)s * W;
  const int32_t* prog = a.progress + (size_t)s * a.P;
  const int32_t* fold = a.folded + (size_t)s * a.P;
  const long long p = a.part ? a.part[s] : a.part_scalar;
  const int pf = fold[p], pp = prog[p];
  const int bi = (int)(a.bidx ? a.bidx[s] : a.bidx_scalar);

  // 1. rank 0 stages the tenants, the global watermark's window, the new frontier
  for (int w = tid; w < W; w += kThreads) {
    mine[w] = INT_MIN;
    if (q == 0) top[w] = old[w];
  }
  if (q == 0) {
    if (tid < 3) counts[tid] = 0;
    if (tid < 32) {
      int g = INT_MAX;
      for (int i = tid; i < a.P; i += 32) g = min(g, prog[i]);
      g = __reduce_min_sync(0xffffffffu, g);
      if (tid == 0) gwid_s = max(wrap_add(floor_div(wrap_add(g, -a.window_len), a.hop), 1), 0);
    }
    for (int i = tid; i < a.P; i += kThreads) {
      int v = fold[i];
      if (a.gated && i == p) v = max(v, wrap_add(bi, 1));
      a.out_folded[(size_t)s * a.P + i] = v;
    }
  }
  cluster.sync();

  // 2. this block's events: the max wid per slot, joined into rank 0's
  const int chunk = (a.B + Q - 1) / Q;
  const int e0 = min(a.B, q * chunk), e1 = min(a.B, e0 + chunk);
  int n_late = 0;
  for (int base = e0; base < e1; base += kTile) {  // uniform trip count: whole warps
    const Events e = load_events(a, s, base, e1, pf, pp, bi);
    n_late += __popc(e.late);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      for (int k = 0; k < K; ++k) {
        const int wid = wrap_add(e.hi[j], -k);
        const bool on = (e.live >> j & 1u) && (K == 1 || wid >= 0);
        const unsigned live = __ballot_sync(0xffffffffu, on);
        if (on) {
          const int sl = pos_mod(wid, W);
          const unsigned grp = __match_any_sync(live, sl);
          const int mx = __reduce_max_sync(grp, wid);
          if (lane == __ffs(grp) - 1) atomicMax(&mine[sl], mx);
        }
      }
    }
  }
  n_late = block_sum(n_late, red);  // its barriers also settle mine[]
  int* top0 = cluster.map_shared_rank(top, 0);
  int* counts0 = cluster.map_shared_rank(counts, 0);
  for (int w = tid; w < W; w += kThreads)
    if (mine[w] != INT_MIN) atomicMax(&top0[w], mine[w]);
  if (tid == 0 && n_late) atomicAdd(&counts0[0], n_late);
  cluster.sync();

  // 3. the new tenants, the reset of advancing slots, each lane's slot and flag
  const int gwid = *cluster.map_shared_rank(&gwid_s, 0);
  int n_evict = 0;
  for (int w = tid; w < W; w += kThreads) {
    const int o = old[w], n = top0[w];
    mine[w] = n;
    adv[w] = n > o;
    if (q == 0) {
      n_evict += n > o && o >= 0 && o >= gwid;
      a.out_wid[(size_t)s * W + w] = n;
    }
  }
  __syncthreads();
  const long long first = (long long)q * kThreads + tid, step = (long long)Q * kThreads;
  for (int w = 0; w < W; ++w) {
    if (!adv[w]) continue;
    for (int f = 0; f < a.n_leaves; ++f) {
      const long long F = a.row[f];
      float* row = a.leaf[f] + ((long long)s * W + w) * F;
      const float v = a.fill[f];
      if (F % 4 == 0 && ((uintptr_t)a.leaf[f] & 15) == 0) {
        float4* r4 = reinterpret_cast<float4*>(row);
        const float4 v4 = make_float4(v, v, v, v);
        for (long long i = first; i < F / 4; i += step) r4[i] = v4;
      } else {
        for (long long i = first; i < F; i += step) row[i] = v;
      }
    }
  }
  int n_stale = 0;
  for (int base = e0; base < e1; base += kTile) {
    const Events e = load_events(a, s, base, e1, pf, pp, bi);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = base + j * kThreads + tid;
      if (b >= e1) break;
      const size_t o = ((size_t)s * a.B + b) * K;
      for (int k = 0; k < K; ++k) {
        const int wid = wrap_add(e.hi[j], -k);
        const bool on = (e.live >> j & 1u) && (K == 1 || wid >= 0);
        const int sl = pos_mod(wid, W);
        const bool stale = on && wid < mine[sl];
        n_stale += stale;
        a.slot[o + k] = sl;
        a.valid[o + k] = on && !stale;
      }
    }
  }
  n_stale = block_sum(n_stale, red);
  n_evict = block_sum(n_evict, red);
  if (tid == 0) {
    if (n_stale) atomicAdd(&counts0[1], n_stale);
    if (q == 0) counts[2] = n_evict;
  }
  cluster.sync();
  if (q == 0 && tid < 3)
    a.out_errors[(size_t)s * 3 + tid] = wrap_add(a.errors[(size_t)s * 3 + tid], counts[tid]);
}

}  // namespace

// desc: S, B, W, P, K, hop, window_len, gated, part ptr, part, bidx ptr,
// bidx, ts, mask, slot_wid, progress, folded, errors, slot, valid, out_wid,
// out_folded, out_errors, n_leaves, then (leaf ptr, row floats, fill's f32
// bits) a leaf.  A null part or bidx pointer takes the scalar beside it.
extern "C" int ring_insert_launch(const long long* desc, int n_desc, cudaStream_t stream) {
  if (n_desc < kDescHead) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.S = (int)desc[0];
  a.B = (int)desc[1];
  a.W = (int)desc[2];
  a.P = (int)desc[3];
  a.K = (int)desc[4];
  a.hop = (int)desc[5];
  a.window_len = (int)desc[6];
  a.gated = (int)desc[7];
  a.part = reinterpret_cast<const long long*>(desc[8]);
  a.part_scalar = desc[9];
  a.bidx = reinterpret_cast<const long long*>(desc[10]);
  a.bidx_scalar = desc[11];
  a.ts = reinterpret_cast<const int32_t*>(desc[12]);
  a.mask = reinterpret_cast<const bool*>(desc[13]);
  a.slot_wid = reinterpret_cast<const int32_t*>(desc[14]);
  a.progress = reinterpret_cast<const int32_t*>(desc[15]);
  a.folded = reinterpret_cast<const int32_t*>(desc[16]);
  a.errors = reinterpret_cast<const int32_t*>(desc[17]);
  a.slot = reinterpret_cast<int32_t*>(desc[18]);
  a.valid = reinterpret_cast<bool*>(desc[19]);
  a.out_wid = reinterpret_cast<int32_t*>(desc[20]);
  a.out_folded = reinterpret_cast<int32_t*>(desc[21]);
  a.out_errors = reinterpret_cast<int32_t*>(desc[22]);
  a.n_leaves = (int)desc[23];
  if (a.S <= 0 || a.B < 0 || a.W <= 0 || a.W > kMaxSlots || a.P <= 0 || a.K <= 0 ||
      a.hop <= 0 || a.window_len <= 0 || a.n_leaves <= 0 || a.n_leaves > kMaxLeaves ||
      n_desc != kDescHead + 3 * a.n_leaves)
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < a.n_leaves; ++f) {
    const long long* d = desc + kDescHead + 3 * f;
    a.leaf[f] = reinterpret_cast<float*>(d[0]);
    a.row[f] = d[1];
    const int32_t bits = (int32_t)d[2];
    memcpy(&a.fill[f], &bits, sizeof bits);
    if (a.row[f] <= 0) return (int)cudaErrorInvalidValue;
  }
  const int Q = std::min(std::max((a.B + kTile - 1) / kTile, 1), kMaxCluster);
  if ((long long)a.S * Q > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.S * Q));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ring_insert_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
