// Slot-gated join of R delta replicas: the merge side of delta sync.
//
// Replaces the Pallas kernel src/repro/kernels/crdt_merge.py:
// gated_delta_merge_pallas (body _gated_kernel).
//
// Two launch functions share the gated join:
//
// gated_delta_merge_launch, the Pallas function's counterpart: input wid
// int32[R, W] (each replica's ring tenant per slot, -1 = clean) and leaf
// T[R, W, F]; output T[W, F].  Per slot w, only replicas whose wid equals
// the slot's max wid contribute; the rest are gated to the join identity.
// A slot clean on every replica copies replica 0.
//
// delta_merge_join_launch, the whole merge side of a delta-sync round in
// one launch: for every window field of a spec it takes the gated join of
// the delta stack as above and joins it slot-aware into each of the S
// replicas' state (wcrdt._merge_wstate: per slot the larger wid wins
// outright, equal wids join), writing new [S, W, F] leaves; it also writes
// the new slot_wid[S, W] = max(state wid, the stack's max wid) and, for
// each int32 metadata field (progress, folded, errors), out[s, p] =
// max(state[s, p], max_r stack[r, p]).
//
// Joins: max and min over float and int32, max / min / bitwise-or over
// uint8.  Every join is exact (there is no NaN in a CRDT state), so the
// result is bitwise that of the plain version.
//
// Bound on this card: device-memory bytes.  The gated merge reads R*W wids,
// the gated-in rows and writes W*F; the fused launch also reads the state
// and writes the new state once.  At the dataplane's shapes (a few hundred
// bytes to a few hundred KB a field) a launch costs more than its bytes,
// so the design puts a whole round's merge side into one launch:
//   - the per-field descriptors travel in one __grid_constant__ struct
//     passed by value (no host-to-device table, no host synchronisation);
//   - one block per (field, slot, tile of F), then one block per metadata
//     field; a block's (dtype, op) switch is uniform within the block;
//   - a block stages the slot's R stack wids and S state wids in shared
//     memory and takes the slot's top wid once;
//   - each thread joins its feature over the gated-in replicas into a
//     register, in replica order, then walks the S replicas: reads
//     state[s, w, f], picks against the top wid and writes out[s, w, f].
//     Threads run along F, so every row is one coalesced access; where F
//     is narrower than the block, thread groups split the S replicas.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxFields = 8;
constexpr int kMaxMeta = 4;

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

bool valid_kind(int dtype, int op) {
  return (dtype == kF32 || dtype == kI32 || dtype == kU8) &&
         (op == kMax || op == kMin || (op == kOr && dtype == kU8));
}

// Stage slot w's R tenant wids (row stride W) in s_wid and return the
// slot's top wid to every thread.  Ends with a barrier.
__device__ __forceinline__ int32_t stage_top(const int32_t* __restrict__ wid, int R, int W,
                                             int w, int32_t* s_wid, int32_t* s_top) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) s_wid[r] = wid[(size_t)r * W + w];
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t top = INT32_MIN;
    for (int r = 0; r < R; ++r) top = max(top, s_wid[r]);
    *s_top = top;
  }
  __syncthreads();
  return *s_top;
}

// The gated join of element o of the R replicas (row stride `row`): the
// join, in replica order, of the replicas holding the top wid; replica 0's
// value where the slot is clean on every replica.
template <typename T, int OP>
__device__ __forceinline__ T gated_join(const T* __restrict__ leaf, const int32_t* s_wid,
                                        int32_t top, int R, size_t row, size_t o) {
  if (top < 0) return leaf[o];  // clean on every replica: the deterministic zero state
  T acc = identity<T, OP>();
  for (int r = 0; r < R; ++r) {
    if (s_wid[r] == top) acc = join<T, OP>(acc, leaf[(size_t)r * row + o]);
  }
  return acc;
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) gated_merge_kernel(
    const int32_t* __restrict__ wid, const T* __restrict__ leaf,
    T* __restrict__ out, int R, int W, int F) {
  extern __shared__ int32_t s_wid[];  // [R]: the slot's tenant on each replica
  __shared__ int32_t s_top;
  const int w = blockIdx.y;
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int32_t top = stage_top(wid, R, W, w, s_wid, &s_top);
  if (f >= F) return;
  const size_t o = (size_t)w * F + f;
  out[o] = gated_join<T, OP>(leaf, s_wid, top, R, (size_t)W * F, o);
}

template <typename T, int OP>
int launch(const int32_t* wid, const void* leaf, void* out, int R, int W, int F,
           cudaStream_t stream) {
  const dim3 grid((F + kThreads - 1) / kThreads, W);
  gated_merge_kernel<T, OP><<<grid, kThreads, R * sizeof(int32_t), stream>>>(
      wid, static_cast<const T*>(leaf), static_cast<T*>(out), R, W, F);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the fused merge side of a delta-sync round
// ---------------------------------------------------------------------------

struct FieldDesc {
  const void* stack;  // T[R, W, F]
  const void* state;  // T[S, W, F]
  void* out;          // T[S, W, F]
  int F;
  int tile_w;       // features a thread group covers: 32, 64 or 128
  int n_tiles;      // ceil(F / tile_w)
  int first_block;  // this field's first block in the grid
  int dtype, op;
};

struct MetaDesc {
  const int32_t* stack;  // [R, n]
  const int32_t* state;  // [S, n]
  int32_t* out;          // [S, n]
  int n;
};

struct JoinArgs {
  const int32_t* stack_wid;  // [R, W]
  const int32_t* state_wid;  // [S, W]
  int32_t* out_wid;          // [S, W]
  int R, S, W, n_fields, n_meta, field_blocks;
  FieldDesc field[kMaxFields];
  MetaDesc meta[kMaxMeta];
};

template <typename T, int OP>
__device__ void join_field(const FieldDesc& fd, int R, int S, int W, int w, int tile,
                           int32_t top, const int32_t* s_wid, const int32_t* s_swid) {
  const int groups = kThreads / fd.tile_w;
  const int f = tile * fd.tile_w + threadIdx.x % fd.tile_w;
  if (f >= fd.F) return;
  const size_t row = (size_t)W * fd.F;  // one replica's leaf
  const size_t o = (size_t)w * fd.F + f;
  const T m = gated_join<T, OP>(static_cast<const T*>(fd.stack), s_wid, top, R, row, o);
  const T* __restrict__ state = static_cast<const T*>(fd.state);
  T* __restrict__ out = static_cast<T*>(fd.out);
#pragma unroll 4
  for (int s = threadIdx.x / fd.tile_w; s < S; s += groups) {
    const int32_t sw = s_swid[s];
    const T a = state[(size_t)s * row + o];
    out[(size_t)s * row + o] = sw == top ? join<T, OP>(a, m) : (sw > top ? a : m);
  }
}

__device__ void join_meta(const JoinArgs& a, const MetaDesc& md) {
  for (int e = threadIdx.x; e < a.S * md.n; e += kThreads) {
    const int p = e % md.n;
    int32_t acc = md.state[e];
#pragma unroll 8
    for (int r = 0; r < a.R; ++r) acc = max(acc, md.stack[(size_t)r * md.n + p]);
    md.out[e] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) delta_merge_join_kernel(
    const __grid_constant__ JoinArgs a) {
  extern __shared__ int32_t s_mem[];  // [R] stack wids, then [S] state wids of the slot
  __shared__ int32_t s_top;
  const int b = blockIdx.x;
  if (b >= a.field_blocks) {
    join_meta(a, a.meta[b - a.field_blocks]);
    return;
  }
  int i = 0;
  while (i + 1 < a.n_fields && b >= a.field[i + 1].first_block) ++i;
  const FieldDesc& fd = a.field[i];
  const int w = (b - fd.first_block) / fd.n_tiles;
  const int tile = (b - fd.first_block) % fd.n_tiles;
  int32_t* s_wid = s_mem;
  int32_t* s_swid = s_mem + a.R;
  for (int s = threadIdx.x; s < a.S; s += kThreads) s_swid[s] = a.state_wid[(size_t)s * a.W + w];
  const int32_t top = stage_top(a.stack_wid, a.R, a.W, w, s_wid, &s_top);
  if (i == 0 && tile == 0) {  // one block a slot writes the new tenants
    for (int s = threadIdx.x; s < a.S; s += kThreads)
      a.out_wid[(size_t)s * a.W + w] = max(s_swid[s], top);
  }
  const int R = a.R, S = a.S, W = a.W;
  switch (fd.dtype * 3 + fd.op) {
    case kF32 * 3 + kMax: join_field<float, kMax>(fd, R, S, W, w, tile, top, s_wid, s_swid); break;
    case kF32 * 3 + kMin: join_field<float, kMin>(fd, R, S, W, w, tile, top, s_wid, s_swid); break;
    case kI32 * 3 + kMax: join_field<int32_t, kMax>(fd, R, S, W, w, tile, top, s_wid, s_swid); break;
    case kI32 * 3 + kMin: join_field<int32_t, kMin>(fd, R, S, W, w, tile, top, s_wid, s_swid); break;
    case kU8 * 3 + kMax: join_field<uint8_t, kMax>(fd, R, S, W, w, tile, top, s_wid, s_swid); break;
    case kU8 * 3 + kMin: join_field<uint8_t, kMin>(fd, R, S, W, w, tile, top, s_wid, s_swid); break;
    case kU8 * 3 + kOr: join_field<uint8_t, kOr>(fd, R, S, W, w, tile, top, s_wid, s_swid); break;
    default: break;  // refused by the launch function
  }
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

// desc, as int64s: R, S, W, n_fields, n_meta, stack_wid, state_wid, out_wid;
// then per field stack, state, out, F, dtype, op; then per metadata field
// stack, state, out, n.  Pointers are device addresses.
extern "C" int delta_merge_join_launch(const long long* desc, int n_desc, cudaStream_t stream) {
  if (n_desc < 8) return (int)cudaErrorInvalidValue;
  JoinArgs a = {};
  a.R = (int)desc[0];
  a.S = (int)desc[1];
  a.W = (int)desc[2];
  a.n_fields = (int)desc[3];
  a.n_meta = (int)desc[4];
  if (a.R <= 0 || a.S <= 0 || a.W <= 0 || a.n_fields <= 0 || a.n_fields > kMaxFields ||
      a.n_meta < 0 || a.n_meta > kMaxMeta || n_desc != 8 + 6 * a.n_fields + 4 * a.n_meta ||
      (size_t)(a.R + a.S) * sizeof(int32_t) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  a.stack_wid = reinterpret_cast<const int32_t*>(desc[5]);
  a.state_wid = reinterpret_cast<const int32_t*>(desc[6]);
  a.out_wid = reinterpret_cast<int32_t*>(desc[7]);
  long long blocks = 0;
  const long long* d = desc + 8;
  for (int i = 0; i < a.n_fields; ++i, d += 6) {
    FieldDesc& fd = a.field[i];
    fd.stack = reinterpret_cast<const void*>(d[0]);
    fd.state = reinterpret_cast<const void*>(d[1]);
    fd.out = reinterpret_cast<void*>(d[2]);
    if (d[3] <= 0 || d[3] > 0x7fffffff || !valid_kind((int)d[4], (int)d[5]))
      return (int)cudaErrorInvalidValue;
    fd.F = (int)d[3];
    fd.dtype = (int)d[4];
    fd.op = (int)d[5];
    fd.tile_w = fd.F > 64 ? kThreads : (fd.F > 32 ? 64 : 32);
    fd.n_tiles = (fd.F + fd.tile_w - 1) / fd.tile_w;
    fd.first_block = (int)blocks;
    blocks += (long long)fd.n_tiles * a.W;
    if (blocks + a.n_meta > 0x7fffffff) return (int)cudaErrorInvalidValue;
  }
  a.field_blocks = (int)blocks;
  for (int k = 0; k < a.n_meta; ++k, d += 4) {
    MetaDesc& md = a.meta[k];
    md.stack = reinterpret_cast<const int32_t*>(d[0]);
    md.state = reinterpret_cast<const int32_t*>(d[1]);
    md.out = reinterpret_cast<int32_t*>(d[2]);
    if (d[3] <= 0 || d[3] * a.S > 0x7fffffff) return (int)cudaErrorInvalidValue;
    md.n = (int)d[3];
  }
  delta_merge_join_kernel<<<(unsigned)(blocks + a.n_meta), kThreads,
                            (a.R + a.S) * sizeof(int32_t), stream>>>(a);
  return (int)cudaGetLastError();
}
