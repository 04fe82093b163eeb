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
// min; a count counts the segment's lanes from zero (as a sequential f32
// count does: exact up to 2^24, then stuck) and adds init once, as the JAX
// package's kernels do.  The sort is stable, so the lanes of one segment
// come in lane order and a float sum adds the same terms in the same order
// as a sequential scatter-add into the running state: no atomics, the same
// result every run.
//
// Bound on this card: it reads each live lane once (segment and value, 8
// bytes) and init, and writes out (8 bytes per segment), so device-memory
// bytes bound it: at the keyed dataplane's shape the 1.6e7-segment state
// in and out (128 MB, about 40 us) outweighs the ~5e5 live lanes.  Lane
// order sets the other floor: a hot key's run (under zipf skew about 21,600
// lanes a step) is one chain of dependent adds, about 4 cycles each on an
// H100 (chip_smoke.py measures it): about 45 us.
//
// Design: three kernels, launched in this order on the caller's stream,
// each by programmatic dependent launch after the one before, so that the
// long runs start first and overlap the copy.  Each lets the next start as
// soon as all its blocks run; one block of each later kernel waits for the
// kernels before it to complete before it exits, so the launch completes,
// for whatever follows on the stream, only when all three have.  Nothing is
// kept between calls.
//   * Hot: eight one-warp blocks fold the hot runs, those covering an
//     aligned window of 4,096 stream positions (found from one load per
//     window), as the front warps fold theirs.  Each asks for 227 KB of
//     shared memory, so that no other block shares its SM: a chain that
//     shares its SM with span blocks runs slower.  That relies on the block
//     scheduler, which places these blocks first, on SMs that are empty.
//   * Front: one warp a block.  The warps split the live part of the sorted
//     stream ([0, edges[n_tiles])) between them, find the starts of the
//     runs longer than kLong lanes (a lane whose segment differs from the
//     one before and equals the one kLong after), and fold each such run:
//     cp.async streams the run's values into a 4-stage ring of 1,024-value
//     fills in shared memory (4 KB a fill, no registers held), and lane 0
//     adds each fill in order, its shared loads 16 bytes wide and a group
//     ahead of the adds, so only the dependent adds are serial while up to
//     three fills are in flight.  The segment of a fill's last lane, copied
//     with the fill, says whether the run covers it; only the fill where
//     the run ends loads its segments.  Two warp syncs per fill, no block
//     sync.
//   * Spans: one block per span of 4,096 segments (eight tiles), 256
//     threads of sixteen segments each (four 16-byte groups): init in and
//     out out with 16-byte loads and stores marked evict-first (read or
//     written once), 16 KB in flight a block.  A
//     span whose range of the stream fits in shared memory (2,048 lanes) is
//     staged there in one coalesced load beside init, then one pass marks
//     where each segment's run starts and ends (no binary searches) and
//     each thread folds its segments' short runs from shared memory: two
//     dependent round trips to device memory in all.  A longer range (a hot
//     key's span) makes the pass over device memory and folds from there.
//     A long run's segment is left to the warp that folds it.
// Every segment's out is written by exactly one thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;               // segments per tile of edges (the Pallas seg_tile)
constexpr int kSpanTiles = 8;            // tiles per span block
constexpr int kSpan = kTile * kSpanTiles;
constexpr int kThreads = 256;
constexpr int kPer = kSpan / kThreads;   // segments per thread: four groups of four
constexpr int kStage = 2048;             // range lanes a span stages in shared memory
constexpr int kPass = kStage / kThreads; // range positions per thread per pass step
constexpr int kLong = 32;                // runs longer than this go to the front warps
constexpr int kScan = 4;                 // stream positions per lane per front step
constexpr int kChunk = 128;              // run positions per warp chunk (4 a lane)
constexpr int kRing = 8;                 // chunks per ring fill
constexpr int kFill = kRing * kChunk;    // run positions per ring fill
constexpr int kStages = 4;               // fills in flight in a front warp's ring
constexpr int kMaxFront = 1056;          // front warps (blocks of one warp) at most
// A run is hot if it covers a whole aligned window of kHotWin stream
// positions (every run of 2 * kHotWin - 1 lanes or more does); kHotBlocks
// one-warp blocks fold the hot runs, each with so much shared memory that
// it has an SM to itself.
constexpr int kHotWin = 4096;
constexpr int kHotBlocks = 8;
constexpr int kHotSmem = 227 * 1024;
constexpr int kFrontSpan = 512;          // stream lanes per front warp, before the cap

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

// a sequential f32 count of n lanes: exact to 2^24, then adding 1 rounds back
__device__ __forceinline__ float count_f32(int n) {
  return n < (1 << 24) ? (float)n : 16777216.0f;
}

// Fold s[a, a + n) into acc in order.  After a head up to a 16-byte
// boundary the values come four to a load, and each register of a group of
// kGroup is reloaded with the values kGroup lanes ahead right after its adds
// read it, so the loads fly while the adds run: only the adds are serial.
// The front's lane 0 takes groups of 64, so that a shared load slowed by
// the copy's traffic through L1 still lands before its add.
constexpr int kGroup = 64;

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

// Asynchronous copies into shared memory, src_bytes of them read (the rest
// zero-filled), tracked per thread in commit groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Programmatic dependent launch: let the next kernel on the stream start
// its blocks; wait until the kernels before this one on the stream have
// completed and their writes are visible.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_earlier() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Copy a fill of a run (the values of positions [pos, pos + kFill), 0 past
// the stream) into its stage of the ring, and the segment of its last
// position into *last (when that is in the stream); one commit group.
template <int OP>
__device__ __forceinline__ void issue_fill(const int32_t* __restrict__ sseg,
                                           const float* __restrict__ sval, int pos, int n_live,
                                           bool vec, float* stage, int32_t* last) {
  const int ln = threadIdx.x & 31;
  if (ln == 0 && pos + kFill <= n_live) cp_async4(last, sseg + pos + kFill - 1, 4);
  if (OP != kCount) {
#pragma unroll
    for (int d = 0; d < kRing; ++d) {
      const int i = d * kChunk + 4 * ln;
      const int q = pos + i;
      if (vec) {
        const int bytes = q + 4 <= n_live ? 16 : (q < n_live ? 4 * (n_live - q) : 0);
        cp_async16(stage + i, sval + (q < n_live ? q : 0), bytes);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          cp_async4(stage + i + k, sval + (q + k < n_live ? q + k : 0), q + k < n_live ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// One warp folds the long run of segment g that starts at stream position
// p, in order, and lane 0 writes out[g].  kStages fills stream into the
// ring (and their last segments into ends) ahead of lane 0, which adds
// them in order.
template <int OP>
__device__ void fold_long_run(const int32_t* __restrict__ sseg, const float* __restrict__ sval,
                              const float* __restrict__ init, float* __restrict__ out,
                              int p, int32_t g, int n_live, bool vec, float* ring,
                              int32_t* ends) {
  const int ln = threadIdx.x & 31;
  float acc = neutral<OP>();
  if (OP != kCount && init) acc = init[g];
  // head up to a 16-byte boundary: inside the run, which is longer than 3
  const int head = vec ? ((4 - (p & 3)) & 3) : 0;
  if (OP != kCount && ln == 0) {
    for (int i = 0; i < head; ++i) acc = combine<OP>(acc, sval[p + i]);
  }
  int n = head;
  const int pos0 = p + head;
#pragma unroll 1
  for (int f = 0; f < kStages; ++f)
    issue_fill<OP>(sseg, sval, pos0 + f * kFill, n_live, vec, ring + f * kFill, ends + f);
  for (int f = 0;; ++f) {
    const int pos = pos0 + f * kFill;
    float* stage = ring + (f % kStages) * kFill;
    int32_t* end = ends + f % kStages;
    cp_async_wait_ahead();  // this lane's part of fill f has landed
    __syncwarp();
    // the segments are sorted: a fill in the stream whose last lane holds g
    // is all g
    int nv = kFill;
    if (pos + kFill > n_live || *end != g) {  // the run ends here: count its part
      int c = 0;
#pragma unroll
      for (int d = 0; d < kRing; ++d) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = pos + d * kChunk + 4 * ln + i;
          c += q < n_live && sseg[q] == g;
        }
      }
      nv = __reduce_add_sync(0xffffffffu, c);
    }
    if (OP != kCount && ln == 0) acc = fold_run<OP>(acc, stage, 0, nv);
    __syncwarp();
    n += nv;
    if (nv < kFill) break;
    issue_fill<OP>(sseg, sval, pos + kStages * kFill, n_live, vec, stage, end);
  }
  cp_async_wait_all();  // the ring's copies past the run, before it is reused
  __syncwarp();
  if (ln == 0) {
    if (OP == kCount) {
      acc = count_f32(n);
      if (init) acc = acc + init[g];
    }
    out[g] = acc;
  }
}

// Whether the run of segment g that starts at stream position p is hot: it
// covers the first aligned window at or after p.
__device__ __forceinline__ bool is_hot(const int32_t* __restrict__ sseg, int p, int32_t g,
                                       int n_live) {
  const long long last = ((long long)p + kHotWin - 1) / kHotWin * kHotWin + kHotWin - 1;
  return last < n_live && sseg[last] == g;
}

// Front: one warp a block; the warps split the live stream and fold every
// run longer than kLong but not hot that starts in their share.
template <int OP>
__global__ void __launch_bounds__(32) segment_front_kernel(
    const int32_t* __restrict__ sseg, const float* __restrict__ sval,
    const int32_t* __restrict__ edges, const float* __restrict__ init,
    float* __restrict__ out, int n_tiles, int vec_stream) {
  __shared__ __align__(16) float ring[kStages * kFill];
  __shared__ int32_t ends[kStages];
  let_next_start();
  const int ln = threadIdx.x;
  const int n_live = edges[n_tiles];
  const int per = (n_live + gridDim.x - 1) / gridDim.x;
  const int p0 = blockIdx.x * per;
  const int p1 = min(p0 + per, n_live);
  for (int q = p0; q < p1; q += 32 * kScan) {
    bool found[kScan];
    int32_t seg[kScan];
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int p = q + k * 32 + ln;
      found[k] = false;
      seg[k] = -1;
      if (p < p1 && p + kLong < n_live) {
        seg[k] = sseg[p];
        found[k] = (p == 0 || sseg[p - 1] != seg[k]) && sseg[p + kLong] == seg[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      unsigned b = __ballot_sync(0xffffffffu, found[k]);
      while (b) {
        const int src = __ffs(b) - 1;
        b &= b - 1;
        const int32_t g = __shfl_sync(0xffffffffu, seg[k], src);
        if (is_hot(sseg, q + k * 32 + src, g, n_live)) continue;  // the hot kernel's
        fold_long_run<OP>(sseg, sval, init, out, q + k * 32 + src, g, n_live, vec_stream != 0,
                          ring, ends);
      }
    }
  }
  // the kernel completes only after the hot kernel before it has
  if (blockIdx.x == 0) wait_for_earlier();
}

// The first stream position in [lo, hi] whose segment is g, where
// sseg[hi] == g: 32 probes a round, one warp.
__device__ __forceinline__ int run_start(const int32_t* __restrict__ sseg, int32_t g, int lo,
                                         int hi) {
  const int ln = threadIdx.x & 31;
  for (;;) {
    const int step = hi - lo > 31 ? (hi - lo + 30) / 31 : 1;
    const int q = min(lo + ln * step, hi);
    const unsigned in = __ballot_sync(0xffffffffu, sseg[q] == g);  // sorted: a suffix
    const int first = __ffs(in) - 1;
    if (step == 1 || first == 0) return min(lo + first * step, hi);
    hi = min(lo + first * step, hi);
    lo = lo + (first - 1) * step + 1;
  }
}

// Hot: one warp a block, alone on its SM.  The blocks find the hot runs by
// their first whole window, take every kHotBlocks-th in stream order, and
// fold each from its start.
template <int OP>
__global__ void __launch_bounds__(32) segment_hot_kernel(
    const int32_t* __restrict__ sseg, const float* __restrict__ sval,
    const int32_t* __restrict__ edges, const float* __restrict__ init,
    float* __restrict__ out, int n_tiles, int vec_stream) {
  extern __shared__ __align__(16) unsigned char hot_smem[];
  float* ring = reinterpret_cast<float*>(hot_smem);
  int32_t* ends = reinterpret_cast<int32_t*>(ring + kStages * kFill);
  let_next_start();
  const int ln = threadIdx.x;
  const int n_live = edges[n_tiles];
  const int n_win = n_live / kHotWin;
  int taken = 0;  // hot runs met so far, in stream order
  for (int k0 = 0; k0 < n_win; k0 += 32) {
    const int k = k0 + ln;
    int32_t g = -1;
    bool first = false;  // window k is the first whole window of a run
    if (k < n_win) {
      const long long w = (long long)k * kHotWin;
      g = sseg[w];
      first = sseg[w + kHotWin - 1] == g && !(k > 0 && sseg[w - kHotWin] == g);
    }
    unsigned b = __ballot_sync(0xffffffffu, first);
    while (b) {
      const int src = __ffs(b) - 1;
      b &= b - 1;
      if (taken++ % (int)gridDim.x != (int)blockIdx.x) continue;
      const int32_t gg = __shfl_sync(0xffffffffu, g, src);
      const int kk = k0 + src;
      // the run starts after the window before, which it does not cover
      const int p = run_start(sseg, gg, kk > 0 ? (kk - 1) * kHotWin : 0, kk * kHotWin);
      fold_long_run<OP>(sseg, sval, init, out, p, gg, n_live, vec_stream != 0, ring, ends);
    }
  }
}

// Spans: the state copy and every run of at most kLong lanes.
template <int OP>
__global__ void __launch_bounds__(kThreads, 4) segment_span_kernel(
    const int32_t* __restrict__ sseg, const float* __restrict__ sval,
    const int32_t* __restrict__ edges, const float* __restrict__ init,
    float* __restrict__ out, int n_seg, int n_tiles, int vec_state) {
  // a staged range and the runs' starts and ends in u16, or, for a range
  // that is not staged, the starts and ends in int over the same bytes
  __shared__ __align__(16) unsigned char smem[2 * kSpan * sizeof(int)];
  static_assert(2 * kStage * sizeof(int) + 2 * kSpan * sizeof(uint16_t) <= sizeof(smem), "");
  const int tid = threadIdx.x;
  int32_t* s_seg = reinterpret_cast<int32_t*>(smem);
  float* s_val = reinterpret_cast<float*>(s_seg + kStage);
  uint16_t* a16 = reinterpret_cast<uint16_t*>(s_val + kStage);  // run start per segment
  uint16_t* b16 = a16 + kSpan;                                   // run end
  int* a32 = reinterpret_cast<int*>(smem);
  int* b32 = a32 + kSpan;
  const int span = blockIdx.x;
  const int sbase = span * kSpan;
  // this thread's segments: four groups of four, 1,024 apart
  constexpr int kGroups = kPer / 4;
  float acc[kPer];
#pragma unroll
  for (int h = 0; h < kGroups; ++h) {
    const int g0 = sbase + h * (kSpan / kGroups) + 4 * tid;
    if (OP != kCount && init && vec_state && g0 + 4 <= n_seg) {
      const float4 i4 = __ldcs(reinterpret_cast<const float4*>(init + g0));  // read once
      acc[4 * h] = i4.x; acc[4 * h + 1] = i4.y; acc[4 * h + 2] = i4.z; acc[4 * h + 3] = i4.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[4 * h + i] = (OP != kCount && init && g0 + i < n_seg) ? init[g0 + i] : neutral<OP>();
    }
  }
  const int lo = edges[span * kSpanTiles];
  const int hi = edges[min((span + 1) * kSpanTiles, n_tiles)];
  const int n = hi - lo;
  const bool staged = n <= kStage;
  unsigned skip = 0;  // bit i: a front warp folds segment i
  if (n > 0) {
    // stage the range (if it fits) and clear the runs
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      const int i = k * kThreads + tid;
      if (staged && i < n) {
        s_seg[i] = sseg[lo + i];
        if (OP != kCount) s_val[i] = sval[lo + i];
      }
    }
    {
      uint4* z = reinterpret_cast<uint4*>(staged ? (void*)a16 : (void*)a32);
      const int nz = staged ? 2 * kSpan * 2 / 16 : 2 * kSpan * 4 / 16;
      for (int i = tid; i < nz; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    // one pass: where each segment's run starts and ends (positions
    // relative to lo)
    for (int q = 0; q < n; q += kStage) {
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
        const int i = q + k * kThreads + tid;
        if (i < n) {
          const int32_t g = staged ? s_seg[i] : sseg[lo + i];
          const int32_t prev = i > 0 ? (staged ? s_seg[i - 1] : sseg[lo + i - 1]) : -1;
          const int32_t next = i + 1 < n ? (staged ? s_seg[i + 1] : sseg[lo + i + 1]) : -1;
          const int l = g - sbase;
          if (g != prev) {
            if (staged) a16[l] = (uint16_t)i;
            else a32[l] = i;
          }
          if (g != next) {
            if (staged) b16[l] = (uint16_t)(i + 1);
            else b32[l] = i + 1;
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = (i / 4) * (kSpan / kGroups) + 4 * tid + (i % 4);
      const int a = staged ? a16[l] : a32[l];
      const int len = (staged ? b16[l] : b32[l]) - a;
      if (len > kLong) {
        skip |= 1u << i;
      } else if (OP == kCount) {
        acc[i] = (float)len;
      } else {
        const float* src = staged ? s_val + a : sval + lo + a;
        for (int j = 0; j < len; ++j) acc[i] = combine<OP>(acc[i], src[j]);
      }
    }
  } else if (OP == kCount) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  }
#pragma unroll
  for (int h = 0; h < kGroups; ++h) {
    const int g0 = sbase + h * (kSpan / kGroups) + 4 * tid;
    if (OP == kCount && init) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (g0 + i < n_seg) acc[4 * h + i] = acc[4 * h + i] + init[g0 + i];
    }
    const unsigned sk = (skip >> (4 * h)) & 15u;
    if (vec_state && g0 + 4 <= n_seg && !sk) {
      __stcs(reinterpret_cast<float4*>(out + g0),
             make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2], acc[4 * h + 3]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (g0 + i < n_seg && !((sk >> i) & 1u)) out[g0 + i] = acc[4 * h + i];
    }
  }
  // the kernel completes only after the front (and so the hot) kernel
  // before it has: what comes next on the stream sees every segment
  if (blockIdx.x == gridDim.x - 1) wait_for_earlier();
}

// Launch a kernel on the caller's stream; with `early`, by programmatic
// dependent launch: its blocks may start once every block of the kernel
// before it on the stream has executed griddepcontrol.launch_dependents.
template <typename T>
struct same { using type = T; };  // keeps the arguments from deducing Args

template <typename... Args>
cudaError_t launch_on(void (*kernel)(Args...), int blocks, int threads, size_t smem,
                      cudaStream_t stream, bool early, typename same<Args>::type... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = early ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int OP>
int launch(const int32_t* sseg, const float* sval, const int32_t* edges, const float* init,
           float* out, int n, int n_seg, cudaStream_t stream) {
  const int n_tiles = (n_seg + kTile - 1) / kTile;
  const int n_spans = (n_tiles + kSpanTiles - 1) / kSpanTiles;
  int n_front = (n + kFrontSpan - 1) / kFrontSpan;
  n_front = n_front < kMaxFront ? n_front : kMaxFront;
  const int vec_stream = (((uintptr_t)sseg | (uintptr_t)sval) & 15) == 0;
  const int vec_state = (((uintptr_t)init | (uintptr_t)out) & 15) == 0;
  // the whole of L1 as shared memory for the spans (at the default split
  // about two span blocks fit on an SM, and their lifetimes, not the
  // memory, then set the copy's rate) and for the front, whose blocks then
  // all fit at once beside them, and the hot blocks' shared memory past
  // 48 KB; set on every launch, so nothing is kept between calls
  cudaError_t e = cudaFuncSetAttribute(segment_span_kernel<OP>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(segment_front_kernel<OP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(segment_hot_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHotSmem);
  // in stream order: the hot runs' blocks first, while whole SMs are free,
  // then the front warps, then the spans, each kernel let in as soon as
  // every block of the one before has started
  const bool hot = n_front > 0 && n >= kHotWin;
  if (e == cudaSuccess && hot)
    e = launch_on(segment_hot_kernel<OP>, kHotBlocks, 32, kHotSmem, stream, false, sseg, sval,
                  edges, init, out, n_tiles, vec_stream);
  if (e == cudaSuccess && n_front > 0)
    e = launch_on(segment_front_kernel<OP>, n_front, 32, 0, stream, hot, sseg, sval, edges, init,
                  out, n_tiles, vec_stream);
  if (e == cudaSuccess)
    e = launch_on(segment_span_kernel<OP>, n_spans, kThreads, 0, stream, n_front > 0, sseg, sval,
                  edges, init, out, n_seg, n_tiles, vec_state);
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}

}  // namespace

extern "C" int segment_reduce_launch(const int32_t* sseg, const float* sval,
                                     const int32_t* edges, const float* init,
                                     float* out, int n, int n_seg, int op,
                                     cudaStream_t stream) {
  if (n_seg <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  switch (op) {
    case kSum: return launch<kSum>(sseg, sval, edges, init, out, n, n_seg, stream);
    case kCount: return launch<kCount>(sseg, sval, edges, init, out, n, n_seg, stream);
    case kMax: return launch<kMax>(sseg, sval, edges, init, out, n, n_seg, stream);
    case kMin: return launch<kMin>(sseg, sval, edges, init, out, n, n_seg, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
