// The fused allocate solve: every pending task of a scheduling cycle placed
// in order, by one thread-block cluster.
//
// Replaces the TPU kernel volcano_tpu/ops/pallas_place.py::_kernel (built by
// pl.pallas_call in _build), itself the on-chip form of the XLA scan
// volcano_tpu/ops/place.py::place_scan. This kernel follows place_scan where
// the two differ: a request fits when req < idle + 0.1 (the reference's
// epsilon), and least-allocated is (alloc - used - req) / alloc. The plain
// version beside it is ops/place.py::place_plain; both perform every
// floating-point operation in the same order (ops/scores.py), and this file
// is compiled with -fmad=false so no multiply-add is contracted: the two
// agree bit for bit.
//
// What bounds it on an H100: neither bytes nor arithmetic. One solve reads
// the node state once (3*R*N floats, 48 KB at R=2, N=2000), the requests and,
// where a plugin gives one, the [T,N] static score matrix, and scores each
// (task, node) pair in about 40 flops: ~1e-5 s of bytes and of FP32 at
// T=10,000, N=2,000. The cost is the serial chain: task t+1 depends on the
// node state task t left, so the T steps run one after another, and a step
// costs the latency of its dependent chain (a node's score, the argmax, the
// state update), not its throughput. The design shortens that chain:
//
// - Re-score only what changed. A node's (score, fit, fits-idle) depends on
//   the task's request q, its static entry srow[n] and its own state, so each
//   node keeps that result as a 64-bit key (below) and the static value it
//   was scored with. A node is stale when q differs from the last scored
//   task's, when its static entry differs from the cached one (bitwise), or
//   when its state changed (it was picked, or a rollback restored it). The
//   argmax over the same keys gives the same pick, so the cache is exact.
// - One warp on the chain. The leader warp (warp 0) walks the task stream;
//   the other warps wait on a named barrier and join only for bulk work: a
//   new request or static row (the slice's stale nodes re-scored, the best
//   key of each 32 nodes rebuilt) and a gang rollback. When only the last
//   pick is stale (a gang's tasks share a request and a static row), the
//   leader re-scores that node with its state in registers, its first-level
//   divisions spread over the lanes (warp_key), and takes the maximum with
//   the best key of the rest of the slice, which it read at the pick while
//   the node's state loaded: no block-wide barrier and no reduction on the
//   chain.
// - Node state in shared memory. Each CTA owns a contiguous node slice and
//   keeps its mutable planes (idle, future idle, used, pod count), the key
//   cache, the group keys and, where room allows, alloc and max_tasks in
//   dynamic shared memory. A slice too large for shared memory runs the same
//   code with these arrays in device memory, through the same generic
//   pointers. Gang saves are lazy: the leader copies a node to device memory
//   the first time its job picks it (a per-node job tag), and a rejected
//   gang restores only the nodes so tagged.
// - Nothing on the chain waits on device memory. The leader stages the task
//   stream (flags, requests, gang needs) into shared memory a chunk at a
//   time, the next chunk loaded into registers a chunk ahead, and reads the
//   next task's fields while the current one runs. The static matrix is read
//   only where a row differs from the one before: a grid-wide pre-pass
//   (rowdiff_kernel, its own launch through vt_rowdiff) marks those tasks,
//   and a run of tasks with one static row reads no row at all. With no
//   static matrix (a null pointer) neither runs.
// - A thread-block cluster over the node axis (1 to 16 CTAs). Each CTA's
//   leader stores its slice's best key into every CTA's slot of this
//   exchange (st.async into distributed shared memory, counted on that CTA's
//   mbarrier), waits on its own mbarrier for the C keys and takes their
//   maximum, so every CTA learns the pick and the owner applies it. Slots and
//   mbarriers are double-buffered by exchange parity: a leader writes parity
//   p again two exchanges later, after its own exchange in between has
//   completed, which needs every CTA's store of that exchange, made only
//   after that CTA read p. A final cluster barrier keeps every CTA's shared
//   memory alive until the last remote access.
//
// B6, the zone-anchor mode (replaces the XLA program
// volcano_tpu/ops/place.py::place_scan_topo, a mode of the same scan): a
// compile-time mode of the same kernel (place_kernel<R, true>) that adds
// topo_w to the score of every node whose zone code equals the job's anchor
// zone, in the reference's order, (static + dynamic) + topo_w * 1 (or * 0).
// The anchor is the zone code of the job's first placement, 0 (none) until
// then and again at the next job's first task; a first placement on an
// unzoned node leaves it 0. Each CTA keeps its nodes' zone codes beside
// their state, and every CTA takes the anchor from the exchanged pick's
// zone code in device memory, so all of them agree. The key cache carries
// the anchor its keys were scored with: when the anchor moves, the nodes of
// the old and the new anchor zone are stale and the bulk path re-scores
// them (at most twice a job); the leader's one-node re-score adds the term
// for its node. The plain version is ops/place.py::place_topo_plain. With
// the mode off (place_kernel<R, false>, B1) none of this is compiled in.
//
// The key orders candidates exactly as the reference's argmax with the
// lowest index winning a tie (the rule better() of node_key's note):
// the high word is the score's bits made monotone as an unsigned integer
// (with -0 read as +0, since -0 == +0), the low word (kMaxNode - n) << 1
// with fits-idle in bit 0. A larger key is a better node; 0 is no node; a
// NaN score, which better() never prefers, is no node.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "score.cuh"

namespace cg = cooperative_groups;

namespace {

using vt::clamp01;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 0.1f;          // resource_info.go minResource
constexpr float kNegTest = -1e29f;    // masked static below this: infeasible
constexpr unsigned kMaxNode = (1u << 26) - 1;   // the packed word's node range
constexpr int kMaxThreads = 512;    // 128 registers a thread
constexpr int kMinThreads = 64;
constexpr int kMaxCluster = 16;
constexpr int kChunk = 32;            // tasks staged per chunk: one per lane

constexpr int kValid = 1, kFirst = 2, kLast = 4;
constexpr int kPlace = 1, kPipe = 2, kReady = 4, kKeep = 8;

// bulk operations the leader hands to every warp of its CTA
constexpr int kOpScore = 1, kOpRestore = 2, kOpExit = 3;
// named barriers (0 is __syncthreads)
constexpr int kBarCommand = 1, kBarScored = 2, kBarGroups = 3;

typedef unsigned long long u64;

// The key of node n with score s: for any two candidates, the larger key is
// the one the reference's tie rule prefers, better(s, i, bs, bi) =
// s > bs || (s == bs && i < bi).
__device__ __forceinline__ u64 node_key(float s, int n, bool fit_idle) {
  if (s != s) return 0;                       // NaN: never better()
  unsigned b = __float_as_uint(s == 0.f ? 0.f : s);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const unsigned lo = ((kMaxNode - static_cast<unsigned>(n)) << 1) |
                      (fit_idle ? 1u : 0u);
  return (static_cast<u64>(b) << 32) | lo;
}

__device__ __forceinline__ int key_node(u64 k) {
  return static_cast<int>(kMaxNode - (static_cast<unsigned>(k) >> 1));
}

// The largest key of the warp, in every lane: the largest high word, then
// the largest low word among the lanes that hold it (two redux.sync).
__device__ __forceinline__ u64 warp_max(u64 k) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned top = __reduce_max_sync(kFull, hi);
  const unsigned lo =
      __reduce_max_sync(kFull, hi == top ? static_cast<unsigned>(k) : 0u);
  return (static_cast<u64>(top) << 32) | lo;
}

__device__ __forceinline__ u64 max64(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// distributed shared memory and the exchange's mbarriers
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
// an 8-byte store into another CTA's shared memory that completes 8 bytes
// of the transaction count of that CTA's mbarrier
__device__ __forceinline__ void st_async_u64(unsigned addr, u64 v,
                                             unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "l"(v), "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned addr, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned addr,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(addr),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// The same key as dynamic_score and node_key give, computed by a whole warp
// for one node: lane r < R divides binpack's term r, lanes R..R+3 the least
// and used fractions of cpu and memory, all in one division's latency; then
// every lane divides binpack's sum and takes the balanced square root. Every
// operation is dynamic_score's, on the same operands, so the bits are the
// same. Node state comes in registers, alike in every lane.
template <int R, bool kTopo>
__device__ __forceinline__ u64 warp_key(const float (&q)[R],
                                        const float (&idle)[R],
                                        const float (&fidle)[R],
                                        const float (&u)[R],
                                        const float (&al)[R],
                                        const float (&rw)[R], int nt, int mt,
                                        bool has_static, float st, int n,
                                        float bw, float lw, float mw,
                                        float balw, int lane, bool same,
                                        float tw) {
  bool fit = nt < mt;
  if (has_static) fit = fit && st > kNegTest;
  bool fit_idle = true;
  float uf[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    fit = fit && q[r] < fidle[r] + kEps;
    fit_idle = fit_idle && q[r] < idle[r] + kEps;
    uf[r] = u[r] + q[r];
  }

  // first level: one division a lane, chosen by selects (no branch); a
  // lane without a term divides by 1 and discards the quotient
  float num = 0.f, den = 1.f;
  bool on = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool me = lane == r;
    on = me ? q[r] > 0.f && rw[r] > 0.f && uf[r] <= al[r] && al[r] > 0.f
            : on;
    num = me ? uf[r] * rw[r] : num;
    den = me ? al[r] : den;
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const bool least_c = lane == R + c;      // least allocated, column c
    const bool frac_c = lane == R + 2 + c;   // used fraction, column c
    on = least_c || frac_c ? al[c] > 0.f : on;
    num = least_c ? (al[c] - u[c]) - q[c] : frac_c ? uf[c] : num;
    den = least_c || frac_c ? al[c] : den;
  }
  const float quot = num / (on ? den : 1.f);
  const float d = on ? quot : 0.f;

  float per_sum = 0.f, wsum = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float per = __shfl_sync(kFull, d, r);
    const float w = q[r] > 0.f ? rw[r] : 0.f;
    per_sum = r == 0 ? per : per_sum + per;
    wsum = r == 0 ? w : wsum + w;
  }
  const float l0 = clamp01(__shfl_sync(kFull, d, R));
  const float l1 = clamp01(__shfl_sync(kFull, d, R + 1));
  const float f0 = __shfl_sync(kFull, d, R + 2);
  const float f1 = __shfl_sync(kFull, d, R + 3);
  const float least = ((l0 + l1) / 2.f) * 100.f;
  const float m0 = f0 > 1.f ? 0.f : f0;
  const float m1 = f1 > 1.f ? 0.f : f1;
  const float most = ((m0 + m1) / 2.f) * 100.f;
  const float b0 = clamp01(f0);
  const float b1 = clamp01(f1);
  const float mean = (b0 + b1) / 2.f;
  const float d0 = b0 - mean, d1 = b1 - mean;
  const float var = (d0 * d0 + d1 * d1) / 2.f;

  // second level, alike in every lane: binpack's quotient, the square root
  const float bq = per_sum / (wsum > 0.f ? wsum : 1.f);
  float binp = wsum > 0.f ? bq : 0.f;
  const float sd = sqrtf(var);
  binp = binp * 100.f;
  binp = binp * bw;
  const float bal = (1.f - sd) * 100.f;

  float s = binp;
  s = s + lw * least;
  s = s + mw * most;
  s = s + balw * bal;
  if (!fit) return 0;
  if (has_static) s = st + s;
  if constexpr (kTopo) s = s + tw * (same ? 1.f : 0.f);
  return node_key(s, n, fit_idle);
}

struct PlaceArgs {
  const float* req;          // [T,R]
  const int* flags;          // [T]
  const int* ready_need;     // [T]
  const int* keep_need;      // [T]
  const float* mstatic;      // [T,N] or null
  const int* rowdiff;        // [T]: row t differs from row t-1; null if no
                             // static matrix
  const float* alloc;        // [R,N]
  const int* max_tasks;      // [N]
  const float* binpack_res;  // [R]
  float bw, lw, mw, balw;
  float* state;              // [3,R,N]: idle, future idle, used
  int* ntasks;               // [N]
  float* saved;              // [3,R,N]
  int* saved_nt;             // [N]
  unsigned char* scratch;    // the cache and tree, when not in shared memory
  int* out;                  // [T]
  int T, N;
  int slice;                 // nodes per CTA
  int in_smem;               // node arrays in shared memory
  int ro_smem;               // alloc and max_tasks in shared memory too
  // B6 (last, so B1's parameter offsets are what they were)
  const int* zone;           // [N] zone codes; null in B1
  float topo_w;              // the anchor zone's weight
};

// A bulk operation, written by the leader before kBarCommand. B6: the
// anchor to score with and the one the cached keys were scored with.
struct Command {
  int op, task, job, q_changed, row_changed, anchor, prev_anchor, pad;
  float q[8];
};

// Shared-memory layout, shared with ops/place.py::launch_plan: the fixed
// part (the cluster exchange's mbarriers and slots, the command, two staged
// task chunks), each node of a slice, and the max tree over a slice.
__host__ __device__ constexpr int fixed_bytes(int R) {
  return 2 * 8 + 2 * kMaxCluster * 8 + static_cast<int>(sizeof(Command)) +
         2 * kChunk * (4 + R) * 4;
}
__host__ __device__ constexpr int node_bytes(int R, bool has_static,
                                             bool ro, bool topo) {
  return 8 + (3 * R + 1) * 4 + 4 + 1 + (has_static ? 4 : 0) +
         (ro ? R * 4 + 4 : 0) + (topo ? 4 : 0);
}
__host__ __device__ constexpr int groups(int slice) {
  return (slice + 31) / 32;
}

// One CTA's view of its node slice; j is a node's index in the slice.
template <int R, bool kTopo>
struct Slice {
  u64 *key, *gbest;          // a key per node, the best key per 32 nodes
  float *idle, *fidle, *used, *stc;
  int *nt, *tag;
  const float* al;
  const int* mt;
  const int* zc;             // B6: zone codes
  unsigned char* dirty;
  int ps, as;                // plane strides of the state and of alloc
  int lo, nloc, G;

  // node j's key for request q, static value st and (B6) the anchor zone
  // (one thread)
  __device__ __forceinline__ u64 score(const PlaceArgs& a,
                                       const float (&q)[R],
                                       const float (&rw)[R], int j,
                                       bool has_static, float st,
                                       int anchor) const {
    bool fit = nt[j] < mt[j];
    if (has_static) fit = fit && st > kNegTest;
    float u[R], alr[R];
    bool fit_idle = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      fit = fit && q[r] < fidle[r * ps + j] + kEps;
      fit_idle = fit_idle && q[r] < idle[r * ps + j] + kEps;
      u[r] = used[r * ps + j];
      alr[r] = al[r * as + j];
    }
    if (!fit) return 0;
    float s = vt::dynamic_score<R>(q, u, alr, rw, a.bw, a.lw, a.mw, a.balw);
    if (has_static) s = st + s;
    if constexpr (kTopo)
      s = s + a.topo_w * (zc[j] == anchor && anchor != 0 ? 1.f : 0.f);
    return node_key(s, lo + j, fit_idle);
  }

  // the best key over the slice, read by one warp
  __device__ __forceinline__ u64 root(int lane) const {
    u64 m = 0;
    for (int g = lane; g < G; g += 32) m = max64(m, gbest[g]);
    return warp_max(m);
  }
};

// A bulk operation, run by every thread of the CTA (node j belongs to
// thread j % threads). kOpScore re-scores the stale nodes and rebuilds the
// best key of each 32 nodes; kOpRestore copies back the saved state of the
// nodes the rejected job tagged. B6: a node in the old or the new anchor
// zone is stale when the anchor moved.
template <int R, bool kTopo>
__device__ void bulk(const Slice<R, kTopo>& sl, const PlaceArgs& a,
                     const Command* cmd, const float (&rw)[R], int tid,
                     int nth) {
  const int op = cmd->op;
  const int N = a.N;
  const size_t RN = static_cast<size_t>(R) * N;
  if (op == kOpRestore) {
    const int job = cmd->job;
    for (int j = tid; j < sl.nloc; j += nth) {
      if (sl.tag[j] != job) continue;
      const size_t n = static_cast<size_t>(sl.lo) + j;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sl.idle[r * sl.ps + j] = a.saved[r * static_cast<size_t>(N) + n];
        sl.fidle[r * sl.ps + j] = a.saved[RN + r * static_cast<size_t>(N) + n];
        sl.used[r * sl.ps + j] =
            a.saved[2 * RN + r * static_cast<size_t>(N) + n];
      }
      sl.nt[j] = a.saved_nt[n];
      sl.dirty[j] = 1;
    }
    // every thread has read the command before the leader writes another
    named_barrier(kBarScored, nth);
    return;
  }
  float q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) q[r] = cmd->q[r];
  const bool q_changed = cmd->q_changed;
  const bool has_static = a.mstatic != nullptr;
  const float* srow =
      has_static && cmd->row_changed
          ? a.mstatic + static_cast<size_t>(cmd->task) * N + sl.lo
          : nullptr;
  int anchor = 0, prev = 0;
  if constexpr (kTopo) {
    anchor = cmd->anchor;
    prev = cmd->prev_anchor;
  }
  for (int j = tid; j < sl.nloc; j += nth) {
    bool stale = q_changed || sl.dirty[j];
    if constexpr (kTopo) {
      const int z = sl.zc[j];
      stale = stale ||
              (anchor != prev && z != 0 && (z == anchor || z == prev));
    }
    float st = has_static ? sl.stc[j] : 0.f;
    if (srow) {
      const float v = srow[j];
      if (__float_as_uint(v) != __float_as_uint(st)) {
        stale = true;
        st = v;
      }
    }
    if (stale) {
      sl.key[j] = sl.score(a, q, rw, j, has_static, st, anchor);
      sl.dirty[j] = 0;
      if (has_static) sl.stc[j] = st;
    }
  }
  named_barrier(kBarScored, nth);
  const int lane = tid & 31;
  for (int g = tid >> 5; g < sl.G; g += nth >> 5) {
    const int j = g * 32 + lane;
    const u64 m = warp_max(j < sl.nloc ? sl.key[j] : 0ull);
    if (lane == 0) sl.gbest[g] = m;
  }
  named_barrier(kBarGroups, nth);
}

// Marks each task whose static row differs (bitwise) from the row before;
// the first task's row always counts as new. One warp a row.
__global__ void rowdiff_kernel(const float* __restrict__ ms, int T, int N,
                               int* __restrict__ rowdiff) {
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const unsigned* bits = reinterpret_cast<const unsigned*>(ms);
  for (int t = blockIdx.x * wpb + (threadIdx.x >> 5); t < T;
       t += gridDim.x * wpb) {
    bool diff = t == 0;
    if (!diff) {
      const unsigned* row = bits + static_cast<size_t>(t) * N;
      const unsigned* prev = row - N;
      for (int n = lane; n < N; n += 32) diff = diff || row[n] != prev[n];
    }
    diff = __any_sync(kFull, diff);
    if (lane == 0) rowdiff[t] = diff ? 1 : 0;
  }
}

template <int R, bool kTopo>
__global__ void __launch_bounds__(kMaxThreads, 1)
place_kernel(const PlaceArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int T = a.T, N = a.N;
  const size_t RN = static_cast<size_t>(R) * N;
  const bool has_static = a.mstatic != nullptr;

  // ---- shared memory: the fixed part, then the slice's node arrays
  unsigned char* p = smem;
  u64* xbar = reinterpret_cast<u64*>(p);        p += 2 * 8;
  u64* xkey = reinterpret_cast<u64*>(p);        p += 2 * kMaxCluster * 8;
  Command* cmd = reinterpret_cast<Command*>(p); p += sizeof(Command);
  int* c_flags = reinterpret_cast<int*>(p);     p += 2 * kChunk * 4;
  int* c_ready = reinterpret_cast<int*>(p);     p += 2 * kChunk * 4;
  int* c_keep = reinterpret_cast<int*>(p);      p += 2 * kChunk * 4;
  int* c_rowdiff = reinterpret_cast<int*>(p);   p += 2 * kChunk * 4;
  float* c_req = reinterpret_cast<float*>(p);   p += 2 * kChunk * R * 4;

  Slice<R, kTopo> sl;
  sl.lo = min(rank * a.slice, N);
  sl.nloc = min(sl.lo + a.slice, N) - sl.lo;
  sl.G = groups(a.slice);
  if (a.in_smem) {
    // generic pointers into shared memory
    const size_t S = a.slice;
    sl.ps = a.slice;
    sl.key = reinterpret_cast<u64*>(p);     p += S * 8;
    sl.gbest = reinterpret_cast<u64*>(p);   p += static_cast<size_t>(sl.G) * 8;
    sl.idle = reinterpret_cast<float*>(p);  p += S * R * 4;
    sl.fidle = reinterpret_cast<float*>(p); p += S * R * 4;
    sl.used = reinterpret_cast<float*>(p);  p += S * R * 4;
    sl.nt = reinterpret_cast<int*>(p);      p += S * 4;
    sl.tag = reinterpret_cast<int*>(p);     p += S * 4;
    sl.stc = reinterpret_cast<float*>(p);
    if (has_static) p += S * 4;
    if (a.ro_smem) {
      float* al_s = reinterpret_cast<float*>(p);
      p += S * R * 4;
      int* mt_s = reinterpret_cast<int*>(p);
      p += S * 4;
      for (int j = tid; j < sl.nloc; j += nth) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          al_s[r * S + j] = a.alloc[r * static_cast<size_t>(N) + sl.lo + j];
        mt_s[j] = a.max_tasks[sl.lo + j];
      }
      sl.al = al_s;
      sl.mt = mt_s;
      sl.as = a.slice;
    } else {
      sl.al = a.alloc + sl.lo;
      sl.mt = a.max_tasks + sl.lo;
      sl.as = N;
    }
    if constexpr (kTopo) {
      int* zc_s = reinterpret_cast<int*>(p);
      p += S * 4;
      for (int j = tid; j < sl.nloc; j += nth) zc_s[j] = a.zone[sl.lo + j];
      sl.zc = zc_s;
    }
    sl.dirty = p;
    for (int j = tid; j < sl.nloc; j += nth) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t n = r * static_cast<size_t>(N) + sl.lo + j;
        sl.idle[r * S + j] = a.state[n];
        sl.fidle[r * S + j] = a.state[RN + n];
        sl.used[r * S + j] = a.state[2 * RN + n];
      }
      sl.nt[j] = a.ntasks[sl.lo + j];
    }
  } else {
    // generic pointers into device memory (ops/place.py::scratch_bytes):
    // keys [N], every CTA's group keys [C,G], tags [N], static values [N],
    // stale flags [N]
    const size_t G = sl.G, Cs = C;
    unsigned char* sc = a.scratch;
    sl.key = reinterpret_cast<u64*>(sc) + sl.lo;
    sl.gbest = reinterpret_cast<u64*>(sc) + N + rank * G;
    unsigned char* rest = sc + 8 * (N + Cs * G);
    sl.tag = reinterpret_cast<int*>(rest) + sl.lo;
    sl.stc =
        reinterpret_cast<float*>(rest + 4 * static_cast<size_t>(N)) + sl.lo;
    sl.dirty = rest + 8 * static_cast<size_t>(N) + sl.lo;
    sl.ps = sl.as = N;
    sl.idle = a.state + sl.lo;
    sl.fidle = a.state + RN + sl.lo;
    sl.used = a.state + 2 * RN + sl.lo;
    sl.nt = a.ntasks + sl.lo;
    sl.al = a.alloc + sl.lo;
    sl.mt = a.max_tasks + sl.lo;
    if constexpr (kTopo) sl.zc = a.zone + sl.lo;
  }
  // every node starts stale and untouched by any job
  for (int j = tid; j < sl.nloc; j += nth) {
    sl.dirty[j] = 1;
    sl.tag[j] = -2;
  }
  if (tid == 0) {
    mbar_init(smem_u32(&xbar[0]), 1);
    mbar_init(smem_u32(&xbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float rw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rw[r] = a.binpack_res[r];

  __syncthreads();
  // no CTA touches another's shared memory before all have started
  if (C > 1) cluster.sync();

  if (tid >= 32) {
    // worker warps: bulk operations on command
    for (;;) {
      named_barrier(kBarCommand, nth);
      if (cmd->op == kOpExit) break;
      bulk<R, kTopo>(sl, a, cmd, rw, tid, nth);
    }
  } else {
    // the leader warp walks the task stream; every lane holds the same
    // control state, and lane 0 writes node state and the output
    int pf_flags = 0, pf_ready = 0, pf_keep = 0, pf_rowdiff = 0;
    float pf_req[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pf_req[r] = 0.f;
    auto fetch = [&](int t) {
      if (t < T) {
        pf_flags = a.flags[t];
        pf_ready = a.ready_need[t];
        pf_keep = a.keep_need[t];
        pf_rowdiff = a.rowdiff ? a.rowdiff[t] : 0;
#pragma unroll
        for (int r = 0; r < R; ++r)
          pf_req[r] = a.req[static_cast<size_t>(t) * R + r];
      }
    };
    auto publish = [&](int base) {
      c_flags[base + lane] = pf_flags;
      c_ready[base + lane] = pf_ready;
      c_keep[base + lane] = pf_keep;
      c_rowdiff[base + lane] = pf_rowdiff;
#pragma unroll
      for (int r = 0; r < R; ++r) c_req[(base + lane) * R + r] = pf_req[r];
    };
    // the next task's fields, read from the staged chunk while the current
    // task runs
    int n_flags = 0, n_ready = 0, n_keep = 0, n_rowdiff = 0;
    float n_req[R];
    auto read_task = [&](int t) {
      const int at = ((t / kChunk) & 1) * kChunk + (t & (kChunk - 1));
      n_flags = c_flags[at];
      n_ready = c_ready[at];
      n_keep = c_keep[at];
      n_rowdiff = c_rowdiff[at];
#pragma unroll
      for (int r = 0; r < R; ++r) n_req[r] = c_req[at * R + r];
    };
    fetch(lane);
    publish(0);
    __syncwarp();
    fetch(kChunk + lane);
    read_task(0);

    int cnt_alloc = 0, cnt_pipe = 0, job = -1;
    bool broken = false, have_q = false, pending = true, row_dirty = false;
    // B6: the job's anchor zone, and the one the cached keys were scored
    // with
    int anchor = 0, scored_anchor = 0;
    u64 cta_best = 0;         // the slice's best key
    unsigned xs = 0;          // cluster exchanges so far
    float last_q[R];
#pragma unroll
    for (int r = 0; r < R; ++r) last_q[r] = 0.f;
    // this CTA's node picked by the last scored task, and its state after
    // the pick (in registers, alike in every lane)
    int dj = -1, d_nt = 0, d_mt = 0, d_zc = 0;
    u64 group_rest = 0, other_groups = 0;   // the tree without node dj
    // the last re-score's writes, in registers until the warp syncs
    int w_node = -1, w_group = -1;
    u64 w_key = 0, w_gbest = 0;
    float d_idle[R], d_fidle[R], d_used[R], d_al[R], d_st = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      d_idle[r] = d_fidle[r] = d_used[r] = d_al[r] = 0.f;

    for (int i = 0; i < T; ++i) {
      const int f = n_flags, need_ready = n_ready, need_keep = n_keep;
      float q[R];
#pragma unroll
      for (int r = 0; r < R; ++r) q[r] = n_req[r];
      row_dirty = row_dirty || n_rowdiff;
      if (i + 1 < T) {
        if (((i + 1) & (kChunk - 1)) == 0) {
          // publish the chunk prefetched into registers and fetch the one
          // after it; the buffer written here was last read a chunk ago
          publish(((i + 1) / kChunk & 1) * kChunk);
          __syncwarp();
          fetch(i + 1 + kChunk + lane);
        }
        read_task(i + 1);
      }
      const bool valid = f & kValid;

      // Job boundary open: a new job tag; nodes are saved when first picked.
      if (f & kFirst) {
        ++job;
        cnt_alloc = cnt_pipe = 0;
        broken = false;
        anchor = 0;
      }

      int word = 0;
      if (valid && !broken) {
        bool q_changed = !have_q;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          q_changed = q_changed ||
                      __float_as_uint(q[r]) != __float_as_uint(last_q[r]);
          last_q[r] = q[r];
        }
        have_q = true;

        if (q_changed || row_dirty || pending ||
            (kTopo && anchor != scored_anchor)) {
          // bulk: every warp re-scores its stale nodes and the group keys
          if (lane == 0) {
            cmd->op = kOpScore;
            cmd->task = i;
            cmd->q_changed = q_changed;
            cmd->row_changed = row_dirty;
            if constexpr (kTopo) {
              cmd->anchor = anchor;
              cmd->prev_anchor = scored_anchor;
            }
#pragma unroll
            for (int r = 0; r < R; ++r) cmd->q[r] = q[r];
          }
          __syncwarp();
          named_barrier(kBarCommand, nth);
          bulk<R, kTopo>(sl, a, cmd, rw, tid, nth);
          scored_anchor = anchor;
          cta_best = sl.root(lane);
          pending = row_dirty = false;
          w_node = w_group = -1;
        } else if (dj >= 0) {
          // only the last pick is stale: re-score it and take the maximum
          // with the rest of its group and the other groups (both read at
          // the pick)
          const u64 kv = warp_key<R, kTopo>(
              q, d_idle, d_fidle, d_used, d_al, rw, d_nt, d_mt, has_static,
              d_st, sl.lo + dj, a.bw, a.lw, a.mw, a.balw, lane,
              d_zc == anchor && anchor != 0, a.topo_w);
          w_node = dj;
          w_key = kv;
          w_group = dj >> 5;
          w_gbest = max64(group_rest, kv);
          cta_best = max64(other_groups, w_gbest);
          if (lane == 0) {
            sl.key[dj] = kv;
            sl.dirty[dj] = 0;
            sl.gbest[w_group] = w_gbest;
          }
        }
        dj = -1;

        u64 best = cta_best;
        if (C > 1) {
          // every leader expects C keys on its mbarrier of this exchange's
          // parity, stores its slice's best into each CTA's slot (st.async,
          // counted on that CTA's mbarrier), waits for its own, and takes
          // the maximum of the C keys
          ++xs;
          const int par = xs & 1;
          if (lane == 0) mbar_expect_tx(smem_u32(&xbar[par]), C * 8);
          if (lane < C)
            st_async_u64(
                map_rank(smem_u32(&xkey[par * kMaxCluster + rank]), lane),
                cta_best, map_rank(smem_u32(&xbar[par]), lane));
          mbar_wait(smem_u32(&xbar[par]), ((xs - 1) >> 1) & 1);
          best = warp_max(lane < C ? xkey[par * kMaxCluster + lane] : 0ull);
        }

        if (best == 0) {
          // no node passes: the reference breaks out of the job's task
          // loop (allocate.go:206-210)
          broken = true;
        } else {
          const int n = key_node(best);
          const bool fit_idle = best & 1ull;
          const int j = n - sl.lo;
          if (j >= 0 && j < sl.nloc) {
            // every lane reads the node's state (one round trip) and keeps
            // the state after the pick for the next task's re-score; the
            // warp also takes the best key of the rest of the node's group
            // and of the other groups, which that re-score will not change
            // (this task's own tree update is still in registers: w_*)
            const int g = j >> 5;
            const int jl = g * 32 + lane;
            const u64 kr = jl < sl.nloc && jl != j && jl != w_node
                               ? sl.key[jl] : 0ull;
            const int k1 = lane + 32;
            const u64 e0 = lane < sl.G && lane != g && lane != w_group
                               ? sl.gbest[lane] : 0ull;
            const u64 e1 = k1 < sl.G && k1 != g && k1 != w_group
                               ? sl.gbest[k1] : 0ull;
            float o_idle[R], o_fidle[R], o_used[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              o_idle[r] = sl.idle[r * sl.ps + j];
              o_fidle[r] = sl.fidle[r * sl.ps + j];
              o_used[r] = sl.used[r * sl.ps + j];
              d_al[r] = sl.al[r * sl.as + j];
            }
            const int o_nt = sl.nt[j];
            const int o_tag = sl.tag[j];
            d_mt = sl.mt[j];
            if constexpr (kTopo) d_zc = sl.zc[j];
            d_st = has_static ? sl.stc[j] : 0.f;
            u64 ot = max64(e0, e1);
            for (int k = lane + 64; k < sl.G; k += 32)
              if (k != g && k != w_group) ot = max64(ot, sl.gbest[k]);
            ot = (w_group >= 0 && w_group != g) ? max64(ot, w_gbest) : ot;
            group_rest = warp_max(
                (w_node >= 0 && w_node != j && (w_node >> 5) == g)
                    ? max64(kr, w_key) : kr);
            other_groups = warp_max(ot);
            // allocate consumes idle (and so future idle); pipeline only
            // reserves future resources (node_info.go AddTask)
#pragma unroll
            for (int r = 0; r < R; ++r) {
              d_fidle[r] = o_fidle[r] - q[r];
              d_idle[r] = fit_idle ? o_idle[r] - q[r] : o_idle[r];
              d_used[r] = fit_idle ? o_used[r] + q[r] : o_used[r];
            }
            d_nt = o_nt + 1;
            if (lane == 0 && o_tag != job) {
              // the job's first pick of this node: keep its state for a
              // rollback (the Statement's undo log is "copy it back")
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const size_t o = r * static_cast<size_t>(N) + n;
                a.saved[o] = o_idle[r];
                a.saved[RN + o] = o_fidle[r];
                a.saved[2 * RN + o] = o_used[r];
              }
              a.saved_nt[n] = o_nt;
              sl.tag[j] = job;
            }
            if (lane == 0) {
#pragma unroll
              for (int r = 0; r < R; ++r) {
                sl.idle[r * sl.ps + j] = d_idle[r];
                sl.fidle[r * sl.ps + j] = d_fidle[r];
                sl.used[r * sl.ps + j] = d_used[r];
              }
              sl.nt[j] = d_nt;
              sl.dirty[j] = 1;
            }
            dj = j;
          }
          // B6: the job's first placement on a zoned node anchors it, in
          // every CTA alike
          if constexpr (kTopo)
            if (anchor == 0) anchor = a.zone[n];
          if (fit_idle)
            ++cnt_alloc;
          else
            ++cnt_pipe;
          word = ((n + 1) << 4) | kPlace | (fit_idle ? 0 : kPipe);
        }
        __syncwarp();
      }

      // Job boundary close: gang vote (gang.go jobReadyFn) -> commit, or
      // roll back the nodes this job picked to their saved state.
      if (valid && (f & kLast)) {
        const bool ready = cnt_alloc >= need_ready;
        const bool keep = ready || cnt_alloc + cnt_pipe >= need_keep;
        word |= (ready ? kReady : 0) | (keep ? kKeep : 0);
        if (!keep) {
          if (lane == 0) {
            cmd->op = kOpRestore;
            cmd->job = job;
          }
          __syncwarp();
          named_barrier(kBarCommand, nth);
          bulk<R, kTopo>(sl, a, cmd, rw, tid, nth);
          pending = true;
          dj = -1;
        }
      }
      if (rank == 0 && lane == 0) a.out[i] = word;
    }
    if (lane == 0) cmd->op = kOpExit;
    __syncwarp();
    named_barrier(kBarCommand, nth);
  }

  __syncthreads();
  if (a.in_smem) {
    for (int j = tid; j < sl.nloc; j += nth) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t n = r * static_cast<size_t>(N) + sl.lo + j;
        a.state[n] = sl.idle[r * sl.ps + j];
        a.state[RN + n] = sl.fidle[r * sl.ps + j];
        a.state[2 * RN + n] = sl.used[r * sl.ps + j];
      }
      a.ntasks[sl.lo + j] = sl.nt[j];
    }
  }
  // keep this CTA's shared memory alive until every remote access is done
  if (C > 1) cluster.sync();
}

template <int R, bool kTopo>
cudaError_t configure(int C, int threads, int smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      place_kernel<R, kTopo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(place_kernel<R, kTopo>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(C, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int R, bool kTopo>
cudaError_t launch(const PlaceArgs& a, int C, int threads, int smem,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = configure<R, kTopo>(C, threads, smem, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, place_kernel<R, kTopo>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R, bool kTopo>
cudaError_t active_clusters(int C, int threads, int smem, int* count) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = configure<R, kTopo>(C, threads, smem, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      count, (const void*)place_kernel<R, kTopo>, &cfg);
}

template <int R>
cudaError_t launch_mode(const PlaceArgs& a, int C, int threads, int smem,
                        cudaStream_t stream) {
  return a.zone != nullptr ? launch<R, true>(a, C, threads, smem, stream)
                           : launch<R, false>(a, C, threads, smem, stream);
}

template <int R>
cudaError_t active_clusters_mode(bool topo, int C, int threads, int smem,
                                 int* count) {
  return topo ? active_clusters<R, true>(C, threads, smem, count)
              : active_clusters<R, false>(C, threads, smem, count);
}

bool plan_ok(int R, int T, int N, int C, int threads, int slice, int in_smem,
             int ro_smem, bool has_static, bool topo, int smem) {
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) != 0) return false;
  if (threads < kMinThreads || threads > kMaxThreads || threads % 32 != 0)
    return false;
  if (N < 0 || static_cast<unsigned>(N) > kMaxNode || T < 0) return false;
  if (slice < 1 || static_cast<long long>(slice) * C < N) return false;
  if (ro_smem && !in_smem) return false;
  const long long want =
      fixed_bytes(R) +
      (in_smem ? static_cast<long long>(slice) *
                         node_bytes(R, has_static, ro_smem != 0, topo) +
                     8LL * groups(slice)
               : 0);
  return want == smem;
}

// B7, the speculative solve's device decode (replaces the XLA program
// volcano_tpu/ops/pallas_place.py::_packed_decoder): B1's words into the
// wire [task_node | pipelined | ready | kept], ops/place.py::
// decode_packed_plain. Bound by bytes (2T words read, 2T+2J written: about
// 0.05 us at T=10,000 over 3.35 TB/s); a launch costs more than that, so
// the design is only two small launches after a memset. A job's ready and
// kept are the OR over its boundary rows, as the reference's segment sum
// > 0, on any wire (B1 gives each job one boundary row).
__global__ void decode_flags_kernel(const int* __restrict__ packed,
                                    const int* __restrict__ job_ix, int T,
                                    int J, int* __restrict__ ready,
                                    int* __restrict__ kept) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T;
       t += gridDim.x * blockDim.x) {
    const int f = packed[t] & 0xF;
    const int j = job_ix[t];
    if ((f & (kReady | kKeep)) == 0 || j < 0 || j >= J) continue;
    if (f & kReady) atomicOr(ready + j, 1);
    if (f & kKeep) atomicOr(kept + j, 1);
  }
}

__global__ void decode_tasks_kernel(const int* __restrict__ packed,
                                    const int* __restrict__ job_ix, int T,
                                    int J, const int* __restrict__ kept,
                                    int* __restrict__ task_node,
                                    int* __restrict__ pipe) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < T;
       t += gridDim.x * blockDim.x) {
    const int w = packed[t];
    const int j = job_ix[t];
    const bool keep = j >= 0 && j < J && kept[j] != 0;
    task_node[t] = keep && (w & kPlace) ? (w >> 4) - 1 : -1;
    pipe[t] = (w & kPipe) ? 1 : 0;
  }
}

}  // namespace

// Plain C entry, bound with ctypes (ops/place.py::decode_packed_cuda):
// decodes packed [T] with job_ix [T] (values in [0, J)) into out
// [2T + 2J]. Launches on `stream` and returns the first failed call's
// cudaError_t (0 on success).
extern "C" int vt_decode_packed(const int* packed, const int* job_ix, int T,
                                int J, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ready = out + 2 * static_cast<size_t>(T);
  int* kept = ready + J;
  if (J > 0) {
    cudaError_t err = cudaMemsetAsync(ready, 0, 2 * sizeof(int) * J, s);
    if (err != cudaSuccess) return err;
  }
  if (T < 1) return cudaGetLastError();
  const int threads = 256;
  const int blocks = min((T + threads - 1) / threads, 1024);
  decode_flags_kernel<<<blocks, threads, 0, s>>>(packed, job_ix, T, J, ready,
                                                 kept);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_tasks_kernel<<<blocks, threads, 0, s>>>(packed, job_ix, T, J, kept,
                                                 out, out + T);
  return cudaGetLastError();
}

// Plain C entry, bound with ctypes (ops/place.py::rowdiff_cuda): marks in
// out [T] each task whose row of ms [T,N] differs bitwise from the row
// before (the first row always). Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int vt_rowdiff(const float* ms, int T, int N, int* out,
                          void* stream) {
  if (T < 1) return 0;
  const int blocks = min((T + 7) / 8, 4096);
  rowdiff_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      ms, T, N, out);
  return cudaGetLastError();
}

// Plain C entry, bound with ctypes (ops/place.py::place_cuda). Layouts:
// req [T,R]; flags/ready_need/keep_need/out [T]; mstatic [T,N] or null;
// rowdiff [T], vt_rowdiff's marks of mstatic (null without mstatic),
// launched before on the same stream; alloc, and each of the three
// planes of state (idle, future idle, used) and saved, [R,N];
// max_tasks/ntasks/saved_nt [N]; zone [N] zone codes for B6 with its
// weight topo_w (null for B1); scratch ops/place.py::scratch_bytes bytes
// when the node arrays stay in device memory, else null. state and ntasks
// hold the initial node state on entry and the final state on return. The
// launch plan (cluster size, threads, nodes per CTA, where the node arrays
// live, bytes of shared memory) comes from ops/place.py::launch_plan.
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// -1 for an R this file was not built for, -2 for a plan whose shared memory
// does not match this file's layout.
extern "C" int vt_place(const float* req, const int* flags,
                        const int* ready_need, const int* keep_need,
                        const float* mstatic, const int* rowdiff,
                        const float* alloc, const int* max_tasks,
                        const float* binpack_res, float bw, float lw,
                        float mw, float balw, const int* zone, float topo_w,
                        float* state, int* ntasks,
                        float* saved, int* saved_nt, void* scratch, int* out,
                        int T, int N, int R, int cluster, int threads,
                        int slice, int in_smem, int ro_smem, int smem_bytes,
                        void* stream) {
  if (R < 2 || R > 8) return -1;
  if (!plan_ok(R, T, N, cluster, threads, slice, in_smem, ro_smem,
               mstatic != nullptr, zone != nullptr, smem_bytes) ||
      (mstatic != nullptr && rowdiff == nullptr) ||
      (!in_smem && scratch == nullptr))
    return -2;
  PlaceArgs a;
  a.req = req;
  a.flags = flags;
  a.ready_need = ready_need;
  a.keep_need = keep_need;
  a.mstatic = mstatic;
  a.rowdiff = mstatic != nullptr ? rowdiff : nullptr;
  a.alloc = alloc;
  a.max_tasks = max_tasks;
  a.binpack_res = binpack_res;
  a.bw = bw;
  a.lw = lw;
  a.mw = mw;
  a.balw = balw;
  a.zone = zone;
  a.topo_w = topo_w;
  a.state = state;
  a.ntasks = ntasks;
  a.saved = saved;
  a.saved_nt = saved_nt;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.out = out;
  a.T = T;
  a.N = N;
  a.slice = slice;
  a.in_smem = in_smem;
  a.ro_smem = ro_smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 2: return launch_mode<2>(a, cluster, threads, smem_bytes, s);
    case 3: return launch_mode<3>(a, cluster, threads, smem_bytes, s);
    case 4: return launch_mode<4>(a, cluster, threads, smem_bytes, s);
    case 5: return launch_mode<5>(a, cluster, threads, smem_bytes, s);
    case 6: return launch_mode<6>(a, cluster, threads, smem_bytes, s);
    case 7: return launch_mode<7>(a, cluster, threads, smem_bytes, s);
    default: return launch_mode<8>(a, cluster, threads, smem_bytes, s);
  }
}

// How many clusters of `cluster` CTAs, each of `threads` threads and
// `smem_bytes` of dynamic shared memory, the card can hold at once (into
// *count) for B1 (topo 0) or B6 (topo 1); 0 means such a launch would be
// refused. Returns the query's cudaError_t, or -1 for an R this file was
// not built for.
extern "C" int vt_place_active_clusters(int R, int topo, int cluster,
                                        int threads, int smem_bytes,
                                        int* count) {
  *count = 0;
  const bool t = topo != 0;
  switch (R) {
    case 2: return active_clusters_mode<2>(t, cluster, threads, smem_bytes,
                                           count);
    case 3: return active_clusters_mode<3>(t, cluster, threads, smem_bytes,
                                           count);
    case 4: return active_clusters_mode<4>(t, cluster, threads, smem_bytes,
                                           count);
    case 5: return active_clusters_mode<5>(t, cluster, threads, smem_bytes,
                                           count);
    case 6: return active_clusters_mode<6>(t, cluster, threads, smem_bytes,
                                           count);
    case 7: return active_clusters_mode<7>(t, cluster, threads, smem_bytes,
                                           count);
    case 8: return active_clusters_mode<8>(t, cluster, threads, smem_bytes,
                                           count);
    default: return -1;
  }
}
