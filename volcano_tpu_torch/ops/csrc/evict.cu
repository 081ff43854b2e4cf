// The preempt victim walk (kernel B3) for Hopper.
//
// Replaces volcano_tpu/ops/evict.py:249 build_preempt_walk, a JAX
// lax.while_loop that the TPU ran as one device program. Its plain version
// is volcano_tpu_torch/ops/evict.py::walk_plain; the two compute the same
// outputs to the bit: task_node i32[P], owner i32[N,W], job_done i32[AJ1].
//
// What it computes (the serial algorithm of preempt.go:190-269 over one
// fixed task order; ops/evict.py's docstring has the semantics): for each
// preemptor task, at a job boundary close the previous job's gang
// statement (roll it back if it missed its quota) and open one; skip the
// job once its quota is met; replay the tiered dispatch over every node's
// victim slots (static plugin masks, drf's dynamic keep rule with the
// same-job prefix); take the best-scoring node where the task fits after
// evicting the eligible victims, lowest index on ties; evict the minimal
// row-order prefix of them; update future idle, job allocations and the
// quota count.
//
// Bound. The work is serial in the tasks: each task depends on the state the
// previous one left, and at the preempt world's shapes (N = 1,000, W <= 8,
// R = 2) the operations a task needs are a few thousand against the card's
// 67 TFLOP/s. The kernel is bounded by the latency of its per-task chain,
// not by bytes or operations. The design shortens that chain:
//
// - An exact per-node verdict cache. Each node keeps the result of its
//   tiered dispatch (eligible slots, and the 64-bit key of its score, 0 when
//   the task does not fit) and, under a drf tier, the smallest share among
//   the slots drf keeps (min_kept). Within a job, a same-request run and a
//   non-decreasing preemptor share ls, a node's dispatch changes only when
//   (a) it was the last pick (its alive slots and future idle changed),
//   (c) a group with a slot on it changed its allocation (a victim group of
//   the last eviction, or the preemptor's own group), which moves drf's
//   share of that slot, or (d) keep(ls, min_kept) turned false: keep(ls, rs)
//   = ls < rs || |ls - rs| <= 1e-6 falls as ls rises and rises with rs, so a
//   slot drf dropped stays dropped and the kept ones all stay kept exactly
//   when the smallest does. Anything else (a new job, a new run or request,
//   ls falling, a rollback) re-dispatches every node. The argmax over the
//   same keys gives the same pick, so the cache is exact.
// - (c) through a group -> nodes index (CSR) that the prologue builds from
//   the slot groups, so the leader finds the changed groups' nodes without
//   scanning every node's slots. (d) through a lower bound on every node's
//   min_kept (exact after each all-warp pass, from each 32 nodes' minimum):
//   while keep(ls, bound) holds no node is stale by ls.
// - One warp on the chain. Warp 0 walks the task stream, picks the node of
//   the largest key (the best key of each 32 nodes is kept, so the pick reads
//   N/32 words) and evicts on it. The other warps sleep on a named barrier
//   and join for bulk work: a job's opening (rollback, its candidate and
//   mask words), or a re-dispatch of every node or of the stale ones. The
//   leader marks the last pick and the changed groups' nodes stale
//   (min_kept -inf), so one all-warp pass takes those and the ones (d)
//   finds: at most one pass a task.
// - State in shared memory. Node state (future idle, alive slots, the
//   cache), the victim tables (requests, groups, drf's same-job precedence),
//   the job's mask words, the group allocations and quota counts, and the
//   CSR live in dynamic shared memory as far as they fit, in that order of
//   priority; a block that does not fit runs the same code through the same
//   generic pointers in device memory (ops/evict.py::launch_plan).
// - Nothing on the chain waits on device memory. The leader's lanes hold the
//   task stream 32 tasks at a time in registers, the next 32 loading behind
//   them. The next run's score row is copied into shared memory with cp.async
//   during the bulk re-dispatch of the current run.
// - Lazy gang saves. A job tags a node the first time it evicts there and
//   saves the node's future idle and alive word (device memory), and tags a
//   group the first time its allocation changes and saves that row. A
//   rollback restores only what the job tagged; a slot's owner is -1 exactly
//   while the slot is alive, so the owners to reset are the saved alive bits
//   that are gone.
//
// walk_sharded_kernel (below) runs the walk over a node mesh as one
// cluster of a CTA a shard (the JAX package's build_preempt_walk_sharded).
//
// Every sum runs in the plain version's order (slot order), with
// -fmad=false, and no product or sum goes through a tensor core (the TPU
// reference hit verdict flips through its matrix unit, evict.py:161-167).
//
// Keys order candidates exactly as the plain argmax with the lowest index
// winning a tie: the high word is the score's bits made monotone (-0 read as
// +0), the low word kMaxNode - n; 0 is no node, and a NaN or -inf score, or
// a task that does not fit, gives 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

typedef unsigned long long u64;

constexpr int kMaxR = 8;
constexpr int kMaxW = 64;
constexpr int kMaxM = 64;
constexpr int kMaxTiers = 16;
constexpr int kMinThreads = 64;
constexpr int kMaxThreads = 512;
constexpr int kNPtrs = 25;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMaxNode = 0x7fffffffu;
constexpr float kEps = 0.1f;            // resource_info.go minResource
constexpr float kShareDelta = 1e-6f;    // drf.go shareDelta
constexpr float kBig = 1073741824.0f;   // 1 << 30: a rolled-back job's count

// blocks of the layout; a plan's bit set keeps the block in shared memory
constexpr int kGroups = 1, kNodes = 2, kTables = 4, kMasks = 8, kCsr = 16;
// bulk operations the leader hands to every warp
constexpr int kOpOpen = 1, kOpDispatch = 2, kOpExit = 3;
// named barriers (0 is __syncthreads)
constexpr int kBarCommand = 1, kBarDone = 2;

struct Args {
  int N, W, R, P, PJ, V1, AJ1, G, n_tiers, M, gang, threads, plan, smem;
  int has_drf;
  int tier_kind[kMaxTiers];   // 0 static, 1 drf
  int tier_size[kMaxTiers];
  int tier_lead[kMaxTiers];   // static masks before drf in conf order
  const float* fidle0; const int* vslot; const uint8_t* valid;
  const float* vreq; const int* vgroup; const int* rank;
  const uint8_t* cand_mask; const uint8_t* tier_masks;
  const uint8_t* tier_part; const float* preq; const int* pjob;
  const int* pjg; const uint8_t* first; const int* run_id;
  const int* run_end; const int* job_end; const float* score_g;
  const float* needed; const float* jalloc0; const float* total;
  unsigned char* scratch;   // ops/evict.py::WalkPlan.scratch bytes
  int* owner; int* task_node; int* job_done;
  int* stats;               // [evaluated tasks, re-dispatched nodes, bulks]
};

// A bulk operation, written by the leader before kBarCommand.
struct Command {
  int op, all, pj, restore, run, prefetch, cur, load_row;
  u64 part;
  float ls;
  int last_g;
  float req[kMaxR];
};
static_assert(sizeof(Command) <= 128, "the fixed layout holds 128 bytes");

// Shared-memory layout, mirrored by ops/evict.py: a fixed part (command,
// the groups the last eviction changed), then
// each block the plan keeps in shared memory. Device memory (scratch) holds
// every block at its own offset, then the gang saves.
__host__ __device__ constexpr long long al16(long long b) {
  return (b + 15) / 16 * 16;
}
constexpr long long kFixedBytes = 128 + al16(4LL * (kMaxW + 1));
__host__ __device__ constexpr long long groups_bytes(long long AJ1,
                                                     long long R) {
  return al16(4 * AJ1 * R) + 3 * al16(4 * AJ1) + al16(4 * (AJ1 + 1));
}
__host__ __device__ constexpr long long nodes_bytes(long long N,
                                                    long long R) {
  return 4 * al16(8 * N) + al16(8 * ((N + 31) / 32)) +
         al16(4 * ((N + 31) / 32)) + al16(4 * N * R) + 4 * al16(4 * N);
}
__host__ __device__ constexpr long long tables_bytes(long long N, long long W,
                                                     long long R) {
  return al16(8 * N * W) + al16(4 * N * W * R) + al16(4 * N * W);
}
__host__ __device__ constexpr long long masks_bytes(long long N,
                                                    long long M) {
  return al16(8 * M * N);
}
__host__ __device__ constexpr long long csr_bytes(long long N, long long W) {
  return al16(4 * N * W);
}

// Where every array lives: shared memory or device memory, by the plan.
struct View {
  float *jalloc, *count, *needed;
  int *gtag, *csr_off;
  u64 *key, *alive, *ccand, *elig, *gbest;
  float *gmin, *fidle, *minrs, *srow0, *srow1;
  int* ntag;
  u64* before;
  float* vreq;
  int* vgroup;
  u64* masks;
  int* csr;
  u64* s_alive;
  float *s_fidle, *s_jalloc;
  bool row_smem;   // the score-row buffers are in shared memory
};

__device__ __forceinline__ u64 node_key(float s, int n) {
  if (!(s > -INFINITY)) return 0;            // -inf or NaN: no node
  unsigned b = __float_as_uint(s == 0.f ? 0.f : s);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<u64>(b) << 32) | (kMaxNode - static_cast<unsigned>(n));
}

__device__ __forceinline__ int key_node(u64 k) {
  return static_cast<int>(kMaxNode - static_cast<unsigned>(k));
}

__device__ __forceinline__ u64 max64(u64 a, u64 b) { return a > b ? a : b; }

// The largest key of the warp, in every lane (two redux.sync).
__device__ __forceinline__ u64 warp_max(u64 k) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned top = __reduce_max_sync(kFull, hi);
  const unsigned lo =
      __reduce_max_sync(kFull, hi == top ? static_cast<unsigned>(k) : 0u);
  return (static_cast<u64>(top) << 32) | lo;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool keep(float ls, float rs) {
  return ls < rs || fabsf(ls - rs) <= kShareDelta;
}

// drf.go calculate_share: max over dims of alloc/total (1 when total == 0
// but alloc > 0)
template <int R>
__device__ __forceinline__ float share_of(const float (&al)[R],
                                          const float (&tot)[R]) {
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float t = tot[r];
    const float ratio = t > 0.f ? al[r] / t : (al[r] > 0.f ? 1.f : 0.f);
    s = (r == 0 || ratio > s) ? ratio : s;
  }
  return s;
}

// drf's share of victim slot w on node n (drf.go:308-330): the victim
// job's share after it loses the victim and every earlier candidate of the
// same job on this node.
template <int R>
__device__ __forceinline__ float slot_rs(const View& v, int W, int n, int w,
                                         u64 cand, const float (&tot)[R]) {
  const size_t nw = static_cast<size_t>(n) * W;
  float prior[R];
#pragma unroll
  for (int r = 0; r < R; ++r) prior[r] = 0.f;
  for (u64 ub = v.before[nw + w] & cand; ub; ub &= ub - 1) {
    const int u = __ffsll(static_cast<long long>(ub)) - 1;
    const float* vu = v.vreq + (nw + u) * R;
#pragma unroll
    for (int r = 0; r < R; ++r) prior[r] = prior[r] + vu[r];
  }
  const float* vw = v.vreq + (nw + w) * R;
  const float* ja = v.jalloc + static_cast<size_t>(v.vgroup[nw + w]) * R;
  float ral[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ral[r] = (ja[r] - prior[r]) - vw[r];
  return share_of<R>(ral, tot);
}

// drf's dynamic keep rule over node n's candidate slots: a victim stays iff
// the preemptor's share with the task stays <= its slot_rs. *min_kept gets
// the smallest share it kept. One thread.
template <int R>
__device__ u64 drf_keep(const View& v, int W, int n, u64 cand, float ls,
                        const float (&tot)[R], float* min_kept) {
  u64 kept = 0;
  float mk = INFINITY;
  for (u64 bits = cand; bits; bits &= bits - 1) {
    const int w = __ffsll(static_cast<long long>(bits)) - 1;
    const float rs = slot_rs<R>(v, W, n, w, cand, tot);
    if (keep(ls, rs)) {
      kept |= 1ull << w;
      mk = rs < mk ? rs : mk;
    }
  }
  *min_kept = mk;
  return kept;
}

// The tiered dispatch on node n (session_plugins.go:187-236) given drf's
// kept slots: the eligible victim slots. A tier decides the node once its
// first participant (the first participating static mask among the
// tier_lead before drf, else drf) returned victims: upstream's init spans
// the tiers, so a later veto leaves none.
__device__ __forceinline__ u64 tier_elig(const View& v, const Args& a, int n,
                                         u64 cand, u64 part, u64 dset) {
  u64 elig = 0;
  bool decided = false;
  int off = 0;
  for (int t = 0; t < a.n_tiers; ++t) {
    const int size = a.tier_size[t];
    u64 tset = cand;
    bool ok = true, has_lead = false, lead = false;
    for (int k = 0; k < size; ++k) {
      if (!((part >> (off + k)) & 1ull)) continue;
      const u64 m = v.masks[static_cast<size_t>(off + k) * a.N + n];
      const bool some = (cand & m) != 0;
      tset &= m;
      ok = ok && some;
      if (!has_lead && k < a.tier_lead[t]) {
        has_lead = true;
        lead = some;
      }
    }
    if (a.tier_kind[t] == 1) {
      tset &= dset;
      ok = ok && dset != 0;
      if (!has_lead) {
        has_lead = true;
        lead = dset != 0;
      }
    }
    if (has_lead) {
      if (ok && !decided) elig |= tset;
      decided = decided || lead;
    }
    off += size;
  }
  return elig;
}

// The key of node n for eligible slots elig: 0 unless the task fits after
// evicting them all.
template <int R>
__device__ __forceinline__ u64 fit_key(const View& v, int W, int n, u64 elig,
                                       const float (&req)[R], float s) {
  if (!elig) return 0;
  float ev[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ev[r] = 0.f;
  for (u64 bits = elig; bits; bits &= bits - 1) {
    const int w = __ffsll(static_cast<long long>(bits)) - 1;
    const float* vw = v.vreq + (static_cast<size_t>(n) * W + w) * R;
#pragma unroll
    for (int r = 0; r < R; ++r) ev[r] = ev[r] + vw[r];
  }
  bool fits = true;
#pragma unroll
  for (int r = 0; r < R; ++r)
    fits = fits &&
           req[r] < (v.fidle[static_cast<size_t>(n) * R + r] + ev[r]) + kEps;
  return fits ? node_key(s, n) : 0;
}

// Node n's dispatch, fit and key: writes the node's cache (eligible slots,
// key, min_kept) and returns the key. One thread.
template <int R>
__device__ u64 dispatch(const View& v, const Args& a, int n, u64 part,
                        float ls, const float (&req)[R], float s,
                        const float (&tot)[R], float* min_kept) {
  const u64 cand = v.alive[n] & v.ccand[n];
  float mk = INFINITY;
  u64 dset = 0;
  if (cand && a.has_drf) dset = drf_keep<R>(v, a.W, n, cand, ls, tot, &mk);
  const u64 elig = cand ? tier_elig(v, a, n, cand, part, dset) : 0;
  const u64 key = fit_key<R>(v, a.W, n, elig, req, s);
  v.elig[n] = elig;
  v.key[n] = key;
  v.minrs[n] = mk;
  *min_kept = mk;
  return key;
}

// Job opening, by every thread: roll back the nodes and groups the previous
// job tagged (cmd.restore >= 0), then build this job's candidate and mask
// words.
template <int R>
__device__ void bulk_open(const View& v, const Args& a, const Command& c,
                          int tid, int nth) {
  const int N = a.N, W = a.W;
  if (c.restore >= 0) {
    for (int n = tid; n < N; n += nth) {
      if (v.ntag[n] != c.restore) continue;
#pragma unroll
      for (int r = 0; r < R; ++r)
        v.fidle[static_cast<size_t>(n) * R + r] =
            v.s_fidle[static_cast<size_t>(n) * R + r];
      const u64 saved = v.s_alive[n];
      for (u64 lost = saved & ~v.alive[n]; lost; lost &= lost - 1)
        a.owner[static_cast<size_t>(n) * W +
                __ffsll(static_cast<long long>(lost)) - 1] = -1;
      v.alive[n] = saved;
    }
    for (int k = tid; k < a.AJ1; k += nth) {
      if (v.gtag[k] != c.restore) continue;
#pragma unroll
      for (int r = 0; r < R; ++r)
        v.jalloc[static_cast<size_t>(k) * R + r] =
            v.s_jalloc[static_cast<size_t>(k) * R + r];
    }
  }
  const int pj = c.pj;
  for (int n = tid; n < N; n += nth) {
    const size_t nw = static_cast<size_t>(n) * W;
    u64 cb = 0;
    for (int w = 0; w < W; ++w) {
      const int vs = a.vslot[nw + w];
      if (a.valid[nw + w] && a.cand_mask[static_cast<size_t>(pj) * a.V1 + vs])
        cb |= 1ull << w;
    }
    v.ccand[n] = cb;
    for (int k = 0; k < a.M; ++k) {
      const uint8_t* row =
          a.tier_masks + (static_cast<size_t>(k) * a.PJ + pj) * a.V1;
      u64 mb = 0;
      for (int w = 0; w < W; ++w)
        if (row[a.vslot[nw + w]]) mb |= 1ull << w;
      v.masks[static_cast<size_t>(k) * N + n] = mb;
    }
  }
  named_barrier(kBarDone, nth);
}

// Re-dispatch, by every thread: every node (cmd.all) or those whose smallest
// kept share fails keep(ls, .); rebuild each 32 nodes' best key and smallest
// min_kept (a warp owns whole groups of 32). Copies the score
// row of cmd.run into the buffer cmd.cur first where cmd.load_row asks, and
// starts copying the row of cmd.prefetch into the other buffer.
template <int R>
__device__ void bulk_dispatch(const View& v, const Args& a, const Command& c,
                              const float (&tot)[R], int tid, int nth,
                              int* redisp) {
  const int N = a.N, lane = tid & 31;
  cp_async_wait_all();
  float req[R];
#pragma unroll
  for (int r = 0; r < R; ++r) req[r] = c.req[r];
  const bool all = c.all != 0, load = c.load_row != 0;
  const float ls = c.ls;
  const u64 part = c.part;
  const float* grow = a.score_g + static_cast<size_t>(c.run) * N;
  float* row = v.row_smem ? (c.cur ? v.srow1 : v.srow0) : nullptr;
  const int pf = c.prefetch;
  for (int base = tid - lane; base < N; base += nth) {
    const int n = base + lane;
    u64 key = 0;
    float mk = INFINITY;
    if (n < N) {
      mk = v.minrs[n];
      if (all || !keep(ls, mk)) {
        float s;
        if (row == nullptr) {
          s = grow[n];
        } else if (load) {
          s = grow[n];
          row[n] = s;
        } else {
          s = row[n];
        }
        key = dispatch<R>(v, a, n, part, ls, req, s, tot, &mk);
        ++*redisp;
      } else {
        key = v.key[n];
      }
    }
    const u64 m = warp_max(key);
    const float mm = warp_min(mk);
    if (lane == 0) {
      v.gbest[base >> 5] = m;
      v.gmin[base >> 5] = mm;
    }
  }
  if (row != nullptr && pf >= 0) {
    float* dst = c.cur ? v.srow0 : v.srow1;
    const float* src = a.score_g + static_cast<size_t>(pf) * N;
    for (int n = tid; n < N; n += nth) cp_async4(dst + n, src + n);
    cp_async_commit();
  }
  named_barrier(kBarDone, nth);
}

// One task's fields, held by the leader's lanes (lane l: task base + l).
template <int R>
struct TaskRegs {
  int pjob, pjg, run, run_end, job_end, first;
  float req[R];

  __device__ __forceinline__ void load(const Args& a, int t) {
    if (t < a.P) {
      pjob = a.pjob[t];
      pjg = a.pjg[t];
      run = a.run_id[t];
      run_end = a.run_end[t];
      job_end = a.job_end[t];
      first = a.first[t];
#pragma unroll
      for (int r = 0; r < R; ++r) req[r] = a.preq[static_cast<size_t>(t) * R + r];
    } else {
      pjob = pjg = run = run_end = job_end = first = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) req[r] = 0.f;
    }
  }

  __device__ __forceinline__ TaskRegs from_lane(int l) const {
    TaskRegs o;
    o.pjob = __shfl_sync(kFull, pjob, l);
    o.pjg = __shfl_sync(kFull, pjg, l);
    o.run = __shfl_sync(kFull, run, l);
    o.run_end = __shfl_sync(kFull, run_end, l);
    o.job_end = __shfl_sync(kFull, job_end, l);
    o.first = __shfl_sync(kFull, first, l);
#pragma unroll
    for (int r = 0; r < R; ++r) o.req[r] = __shfl_sync(kFull, req[r], l);
    return o;
  }
};

template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1) walk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int N = a.N, W = a.W, P = a.P, AJ1 = a.AJ1;
  const int G32 = (N + 31) / 32;

  // ---- the fixed part, then each block in shared or device memory
  Command* cmd = reinterpret_cast<Command*>(smem);
  int* pgroups = reinterpret_cast<int*>(smem + 128);
  unsigned char* sp = smem + kFixedBytes;
  unsigned char* dp = a.scratch;
  auto take = [&](int block, long long bytes) -> unsigned char* {
    unsigned char* p = (a.plan & block) ? sp : dp;
    if (a.plan & block) sp += bytes;
    dp += bytes;
    return p;
  };
  View v;
  v.jalloc = reinterpret_cast<float*>(take(kGroups, al16(4LL * AJ1 * R)));
  v.count = reinterpret_cast<float*>(take(kGroups, al16(4LL * AJ1)));
  v.needed = reinterpret_cast<float*>(take(kGroups, al16(4LL * AJ1)));
  v.gtag = reinterpret_cast<int*>(take(kGroups, al16(4LL * AJ1)));
  v.csr_off = reinterpret_cast<int*>(take(kGroups, al16(4LL * (AJ1 + 1))));
  v.key = reinterpret_cast<u64*>(take(kNodes, al16(8LL * N)));
  v.alive = reinterpret_cast<u64*>(take(kNodes, al16(8LL * N)));
  v.ccand = reinterpret_cast<u64*>(take(kNodes, al16(8LL * N)));
  v.elig = reinterpret_cast<u64*>(take(kNodes, al16(8LL * N)));
  v.gbest = reinterpret_cast<u64*>(take(kNodes, al16(8LL * G32)));
  v.gmin = reinterpret_cast<float*>(take(kNodes, al16(4LL * G32)));
  v.fidle = reinterpret_cast<float*>(take(kNodes, al16(4LL * N * R)));
  v.minrs = reinterpret_cast<float*>(take(kNodes, al16(4LL * N)));
  v.ntag = reinterpret_cast<int*>(take(kNodes, al16(4LL * N)));
  v.srow0 = reinterpret_cast<float*>(take(kNodes, al16(4LL * N)));
  v.srow1 = reinterpret_cast<float*>(take(kNodes, al16(4LL * N)));
  v.before = reinterpret_cast<u64*>(take(kTables, al16(8LL * N * W)));
  v.vreq = reinterpret_cast<float*>(take(kTables, al16(4LL * N * W * R)));
  v.vgroup = reinterpret_cast<int*>(take(kTables, al16(4LL * N * W)));
  v.masks = reinterpret_cast<u64*>(take(kMasks, al16(8LL * a.M * N)));
  v.csr = reinterpret_cast<int*>(take(kCsr, al16(4LL * N * W)));
  v.s_alive = reinterpret_cast<u64*>(dp);
  dp += al16(8LL * N);
  v.s_fidle = reinterpret_cast<float*>(dp);
  dp += al16(4LL * N * R);
  v.s_jalloc = reinterpret_cast<float*>(dp);
  v.row_smem = (a.plan & kNodes) != 0;

  float tot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) tot[r] = a.total[r];

  // ---- prologue: state, tables, drf's slot precedence words
  const u64 full = W == 64 ? ~0ull : ((1ull << W) - 1);
  for (int n = tid; n < N; n += nth) {
    const size_t nw = static_cast<size_t>(n) * W;
#pragma unroll
    for (int r = 0; r < R; ++r)
      v.fidle[static_cast<size_t>(n) * R + r] =
          a.fidle0[static_cast<size_t>(n) * R + r];
    v.alive[n] = full;
    v.ccand[n] = 0;
    v.elig[n] = 0;
    v.key[n] = 0;
    v.minrs[n] = INFINITY;
    v.ntag[n] = -1;
    for (int w = 0; w < W; ++w) {
      a.owner[nw + w] = -1;
      v.vgroup[nw + w] = a.vgroup[nw + w];
#pragma unroll
      for (int r = 0; r < R; ++r)
        v.vreq[(nw + w) * R + r] = a.vreq[(nw + w) * R + r];
      const int gw = a.vgroup[nw + w];
      const int rw = a.rank[nw + w];
      u64 bm = 0;
      for (int u = 0; u < W; ++u)
        if (a.valid[nw + u] && a.vgroup[nw + u] == gw && a.rank[nw + u] < rw)
          bm |= 1ull << u;
      v.before[nw + w] = bm;
    }
  }
  for (int k = tid; k < AJ1; k += nth) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      v.jalloc[static_cast<size_t>(k) * R + r] =
          a.jalloc0[static_cast<size_t>(k) * R + r];
    v.count[k] = 0.f;
    v.needed[k] = a.needed[k];
    v.gtag[k] = -1;
    v.csr_off[k + 1] = 0;
  }
  if (tid == 0) {
    v.csr_off[0] = 0;
    a.stats[0] = a.stats[1] = a.stats[2] = 0;
  }
  for (int k = tid; k < P; k += nth) a.task_node[k] = -1;
  __syncthreads();

  // group -> nodes index (drf only): a node once per group it has a slot of
  if (a.has_drf) {
    for (int n = tid; n < N; n += nth) {
      const size_t nw = static_cast<size_t>(n) * W;
      for (int w = 0; w < W; ++w) {
        if (!a.valid[nw + w]) continue;
        const int gw = v.vgroup[nw + w];
        bool seen = false;
        for (int u = 0; u < w && !seen; ++u)
          seen = a.valid[nw + u] && v.vgroup[nw + u] == gw;
        if (!seen) atomicAdd(&v.csr_off[gw + 1], 1);
      }
    }
    __syncthreads();
    if (tid < 32) {
      // exclusive scan: csr_off[k + 1] = the start of group k's list
      int carry = 0;
      for (int base = 0; base < AJ1; base += 32) {
        const int k = base + lane;
        const int x = k < AJ1 ? v.csr_off[k + 1] : 0;
        int incl = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        if (k < AJ1) v.csr_off[k + 1] = carry + incl - x;
        carry += __shfl_sync(kFull, incl, 31);
      }
    }
    __syncthreads();
    // fill: afterwards csr_off[k + 1] is the end of group k's list
    for (int n = tid; n < N; n += nth) {
      const size_t nw = static_cast<size_t>(n) * W;
      for (int w = 0; w < W; ++w) {
        if (!a.valid[nw + w]) continue;
        const int gw = v.vgroup[nw + w];
        bool seen = false;
        for (int u = 0; u < w && !seen; ++u)
          seen = a.valid[nw + u] && v.vgroup[nw + u] == gw;
        if (!seen) v.csr[atomicAdd(&v.csr_off[gw + 1], 1)] = n;
      }
    }
    __syncthreads();
  }

  int redisp = 0;
  if (tid >= 32) {
    // worker warps: bulk operations on command
    for (;;) {
      named_barrier(kBarCommand, nth);
      const Command c = *cmd;
      if (c.op == kOpExit) break;
      if (c.op == kOpOpen)
        bulk_open<R>(v, a, c, tid, nth);
      else
        bulk_dispatch<R>(v, a, c, tot, tid, nth, &redisp);
    }
  } else {
    // the leader warp walks the task stream; every lane holds the same
    // control state, and lane 0 writes shared state and the outputs
    TaskRegs<R> cur, nxt;
    int cb = 0;                          // the task in lane 0 of `cur`
    cur.load(a, lane);
    nxt.load(a, 32 + lane);
    auto fetch = [&](int t) -> TaskRegs<R> {
      if (t < cb || t >= cb + 64) {
        cb = t;
        cur.load(a, t + lane);
        nxt.load(a, t + 32 + lane);
      } else if (t >= cb + 32) {
        cb += 32;
        cur = nxt;
        nxt.load(a, cb + 32 + lane);
      }
      return cur.from_lane(t - cb);
    };
    auto issue = [&](const Command& c) {
      if (lane == 0) *cmd = c;
      __syncwarp();
      named_barrier(kBarCommand, nth);
      if (c.op == kOpOpen)
        bulk_open<R>(v, a, c, tid, nth);
      else
        bulk_dispatch<R>(v, a, c, tot, tid, nth, &redisp);
    };

    // the smallest min_kept of every node
    auto floor_all = [&]() -> float {
      float m = INFINITY;
      for (int k = lane; k < G32; k += 32) m = v.gmin[k] < m ? v.gmin[k] : m;
      return warp_min(m);
    };

    int jtag = -1, last_g = -1, steps = 0, bulks = 0;
    u64 part = 0;
    bool need_all = true;
    int cur_run = -1, cur_buf = 0;
    int buf_run[2] = {-1, -1};
    float cur_req[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cur_req[r] = 0.f;
    float ls_prev = 0.f, lo_bound = INFINITY;
    int pend_best = -1, npg = 0;

    for (int i = 0; i < P;) {
      const TaskRegs<R> t = fetch(i);
      if (t.first) {
        // close the previous job's statement (roll back on a missed
        // quota), open this one
        int restore = -1;
        if (a.gang && last_g >= 0 && v.count[last_g] < v.needed[last_g])
          restore = jtag;
        jtag = i;
        const int k1 = lane + 32;
        const bool b0 = lane < a.M &&
                        a.tier_part[static_cast<size_t>(lane) * a.PJ + t.pjob];
        const bool b1 = k1 < a.M &&
                        a.tier_part[static_cast<size_t>(k1) * a.PJ + t.pjob];
        part = static_cast<u64>(__ballot_sync(kFull, b0)) |
               (static_cast<u64>(__ballot_sync(kFull, b1)) << 32);
        Command c = {};
        c.op = kOpOpen;
        c.pj = t.pjob;
        c.restore = restore;
        issue(c);
        ++bulks;
        if (restore >= 0 && lane == 0) v.count[last_g] = -kBig;
        __syncwarp();
        need_all = true;
        pend_best = -1;
        npg = 0;
      }
      const int g = t.pjg;
      last_g = g;
      if (v.count[g] >= v.needed[g]) {     // quota met: skip the job
        i = t.job_end + 1;
        continue;
      }
      ++steps;
      float ls = 0.f;
      if (a.has_drf) {
        float lal[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          lal[r] = v.jalloc[static_cast<size_t>(g) * R + r] + t.req[r];
        ls = share_of<R>(lal, tot);
      }
      bool same_req = true;
#pragma unroll
      for (int r = 0; r < R; ++r)
        same_req = same_req &&
                   __float_as_uint(t.req[r]) == __float_as_uint(cur_req[r]);
      bool all = need_all || t.run != cur_run || !same_req ||
                 (a.has_drf && ls < ls_prev);

      if (!all && pend_best >= 0) {
        // the last pick and the nodes of the groups it changed are marked
        // stale (min_kept -inf) for the all-warp pass below
        __syncwarp();
        if (lane == 0) v.minrs[pend_best] = -INFINITY;
        for (int k = 0; k < npg; ++k) {
          const int grp = pgroups[k];
          const int lo = v.csr_off[grp], hi = v.csr_off[grp + 1];
          for (int j = lo + lane; j < hi; j += 32)
            v.minrs[v.csr[j]] = -INFINITY;
        }
        __syncwarp();
        lo_bound = -INFINITY;
      }
      pend_best = -1;
      npg = 0;

      // (d): while keep(ls, lo_bound) holds (a lower bound on every node's
      // min_kept; -inf when nodes were marked stale above) no node is
      // stale; else every warp re-dispatches its nodes whose min_kept fails
      // (without a drf tier, ls is 0 and min_kept +inf but where marked)
      const bool thresh = !all && !keep(ls, lo_bound);
      if (all || thresh) {
        // bulk: every node, or those (d) made stale
        Command c = {};
        c.op = kOpDispatch;
        c.all = all;
        c.part = part;
        c.ls = ls;
#pragma unroll
        for (int r = 0; r < R; ++r) c.req[r] = t.req[r];
        c.run = t.run;
        c.prefetch = -1;
        if (all) {
          if (buf_run[cur_buf] == t.run) {
            c.load_row = 0;
          } else if (buf_run[cur_buf ^ 1] == t.run) {
            cur_buf ^= 1;
            c.load_row = 0;
          } else {
            cur_buf ^= 1;
            c.load_row = 1;
          }
          buf_run[cur_buf] = t.run;
          if (v.row_smem && t.run + 1 < a.G &&
              buf_run[cur_buf ^ 1] != t.run + 1) {
            c.prefetch = t.run + 1;
            buf_run[cur_buf ^ 1] = t.run + 1;
          }
          cur_run = t.run;
#pragma unroll
          for (int r = 0; r < R; ++r) cur_req[r] = t.req[r];
          need_all = false;
        }
        c.cur = cur_buf;
        issue(c);
        ++bulks;
        lo_bound = floor_all();
      }
      ls_prev = ls;

      // the pick: the largest key
      u64 m = 0;
      for (int k = lane; k < G32; k += 32) m = max64(m, v.gbest[k]);
      const u64 best = warp_max(m);
      if (best == 0) {
        // phase 1: the rest of the run fails alike; phase 2 stops the job
        i = (a.gang ? t.run_end : t.job_end) + 1;
        continue;
      }

      // evict the minimal row-order prefix of the eligible victims that
      // fits (every lane computes it; lane 0 writes)
      const int b = key_node(best);
      const size_t bw = static_cast<size_t>(b) * W;
      const u64 el = v.elig[b], al = v.alive[b];
      float fb[R], cum[R], freed[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fb[r] = v.fidle[static_cast<size_t>(b) * R + r];
        cum[r] = freed[r] = 0.f;
      }
      u64 evicted = 0;
      for (u64 bits = el; bits; bits &= bits - 1) {
        const int w = __ffsll(static_cast<long long>(bits)) - 1;
        const float* vw = v.vreq + (bw + w) * R;
        bool fit = true;
#pragma unroll
        for (int r = 0; r < R; ++r)
          fit = fit && t.req[r] < (fb[r] + cum[r]) + kEps;
        if (!fit) evicted |= 1ull << w;
#pragma unroll
        for (int r = 0; r < R; ++r) cum[r] = cum[r] + vw[r];
      }
      for (u64 bits = evicted; bits; bits &= bits - 1) {
        const int w = __ffsll(static_cast<long long>(bits)) - 1;
        const float* vw = v.vreq + (bw + w) * R;
#pragma unroll
        for (int r = 0; r < R; ++r) freed[r] = freed[r] + vw[r];
      }
      const bool save_node = a.gang && v.ntag[b] != jtag;
      __syncwarp();
      if (lane == 0) {
        if (save_node) {
          // the job's first eviction here: keep the node for a rollback
#pragma unroll
          for (int r = 0; r < R; ++r)
            v.s_fidle[static_cast<size_t>(b) * R + r] = fb[r];
          v.s_alive[b] = al;
          v.ntag[b] = jtag;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          v.fidle[static_cast<size_t>(b) * R + r] =
              fb[r] + (freed[r] - t.req[r]);
        v.alive[b] = al & ~evicted;
        a.task_node[i] = b;
      }
      for (int w = lane; w < W; w += 32)
        if ((evicted >> w) & 1ull) a.owner[bw + w] = i;
      // each victim job loses its evicted requests (summed per job in slot
      // order, then subtracted once); then the preemptor's job gains the
      // task
      int np = 0;
      auto apply = [&](int grp, const float (&nj)[R]) {
        // the job's first change of this group: keep its row for a
        // rollback
        const bool save_group = a.gang && v.gtag[grp] != jtag;
        __syncwarp();
        if (lane == 0) {
          if (save_group) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              v.s_jalloc[static_cast<size_t>(grp) * R + r] =
                  v.jalloc[static_cast<size_t>(grp) * R + r];
            v.gtag[grp] = jtag;
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
            v.jalloc[static_cast<size_t>(grp) * R + r] = nj[r];
          pgroups[np] = grp;
        }
        __syncwarp();
        ++np;
      };
      for (u64 left = evicted; left;) {
        const int w0 = __ffsll(static_cast<long long>(left)) - 1;
        const int grp = v.vgroup[bw + w0];
        float d[R], nj[R];
#pragma unroll
        for (int r = 0; r < R; ++r) d[r] = 0.f;
        for (u64 bits = left; bits; bits &= bits - 1) {
          const int w = __ffsll(static_cast<long long>(bits)) - 1;
          if (v.vgroup[bw + w] != grp) continue;
          const float* vw = v.vreq + (bw + w) * R;
#pragma unroll
          for (int r = 0; r < R; ++r) d[r] = d[r] + vw[r];
          left &= ~(1ull << w);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          nj[r] = v.jalloc[static_cast<size_t>(grp) * R + r] - d[r];
        apply(grp, nj);
      }
      {
        float nj[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          nj[r] = v.jalloc[static_cast<size_t>(g) * R + r] + t.req[r];
        apply(g, nj);
        const float cnt = v.count[g] + 1.f;
        __syncwarp();
        if (lane == 0) v.count[g] = cnt;
        __syncwarp();
      }
      pend_best = b;
      npg = a.has_drf ? np : 0;
      ++i;
    }
    if (lane == 0) {
      Command c = {};
      c.op = kOpExit;
      c.restore = jtag;
      c.last_g = last_g;
      *cmd = c;
      a.stats[0] = steps;
      a.stats[2] = bulks;
    }
    __syncwarp();
    named_barrier(kBarCommand, nth);
  }
  atomicAdd(&a.stats[1], redisp);
  __syncthreads();

  // close the last job's statement, then the per-group verdicts
  const int last_g = cmd->last_g, last_tag = cmd->restore;
  if (a.gang && last_g >= 0 && v.count[last_g] < v.needed[last_g]) {
    for (int n = tid; n < N; n += nth) {
      if (v.ntag[n] != last_tag) continue;
      const u64 saved = v.s_alive[n];
      for (u64 lost = saved & ~v.alive[n]; lost; lost &= lost - 1)
        a.owner[static_cast<size_t>(n) * W +
                __ffsll(static_cast<long long>(lost)) - 1] = -1;
    }
    __syncthreads();
    if (tid == 0) v.count[last_g] = -kBig;
  }
  __syncthreads();
  for (int k = tid; k < AJ1; k += nth)
    a.job_done[k] = v.count[k] >= v.needed[k] ? 1 : 0;
  __syncthreads();
  if (a.gang)
    for (int k = tid; k < P; k += nth)
      if (!a.job_done[a.pjg[k]]) a.task_node[k] = -1;
}

template <int R>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  walk_kernel<R><<<1, a.threads, a.smem, s>>>(a);
  return cudaGetLastError();
}

bool plan_ok(const Args& a) {
  if (a.threads < kMinThreads || a.threads > kMaxThreads || a.threads % 32)
    return false;
  if (a.N < 1 || static_cast<unsigned>(a.N) > kMaxNode || a.P < 0 ||
      a.AJ1 < 1 || a.plan < 0 || a.plan > 31)
    return false;
  long long want = kFixedBytes;
  if (a.plan & kGroups) want += groups_bytes(a.AJ1, a.R);
  if (a.plan & kNodes) want += nodes_bytes(a.N, a.R);
  if (a.plan & kTables) want += tables_bytes(a.N, a.W, a.R);
  if (a.plan & kMasks) want += masks_bytes(a.N, a.M);
  if (a.plan & kCsr) want += csr_bytes(a.N, a.W);
  return want == a.smem;
}

// ---------------------------------------------------------------------------
// the walk over a node mesh: a cluster of D CTAs, one a shard
// ---------------------------------------------------------------------------
//
// The JAX package's build_preempt_walk_sharded (volcano_tpu/ops/evict.py:
// 743-785, the walk with ``axis``, :253-303) runs the walk node-sharded:
// the node state is split over the shards, the per-task tables and the job
// state replicated, and each probe adds two collectives, a gather of the
// shards' best (score, global node) and a broadcast of the owner shard's
// node-row bundle, so that every shard applies the same job-state update.
// Here the shards are the CTAs of one thread-block cluster, and the two
// collectives go through distributed shared memory:
//
// - every CTA dispatches each of its own nodes (no verdict cache: a node's
//   dispatch is the plain version's, dispatch() above) and takes its best
//   key; the CTAs' keys are gathered over the cluster and the largest wins
//   (the key's low word makes the lowest global node win a tie);
// - the owner CTA evicts on the chosen node and writes the bundle (each
//   victim group's freed requests in first-slot order); after a cluster
//   barrier every CTA reads it from the owner's shared memory and updates
//   its own copy of the job allocations and quota counts.
//
// Each CTA reads and writes only its own nodes' rows. Gang statements:
// each CTA snapshots its own rows and its job-state copy at a job's first
// task and restores them on a missed quota. Outputs are walk_plain's.

constexpr int kShardThreads = 256;

struct ShardArgs {
  float *jalloc, *count, *s_jalloc, *s_count;  // [D, ...]: a copy a CTA
  float *fidle, *s_fidle, *minrs;              // [N, R], [N, R], [N]
  u64 *alive, *s_alive, *ccand, *elig, *key;   // [N]
  u64 *before, *masks;                         // [N, W], [M, N]
  int shards;
};

// The owner's eviction, for every CTA.
struct Bundle {
  int np;                       // victim groups
  int grp[kMaxW];
  float d[kMaxW][kMaxR];        // each group's freed requests
};

template <int R>
__global__ void __launch_bounds__(kShardThreads)
    walk_sharded_kernel(const Args a, const ShardArgs sa) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ u64 s_wbest[kShardThreads / 32];
  __shared__ u64 s_best[2];     // this CTA's best key, by exchange parity
  __shared__ Bundle s_bundle[2];
  __shared__ u64 s_pick, s_part;
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cl.block_rank()), D = sa.shards;
  const int N = a.N, W = a.W, P = a.P, AJ1 = a.AJ1;
  const int Nl = N / D, n0 = rank * Nl, n1 = n0 + Nl;
  View v = {};
  v.jalloc = sa.jalloc + static_cast<size_t>(rank) * AJ1 * R;
  v.count = sa.count + static_cast<size_t>(rank) * AJ1;
  v.fidle = sa.fidle;
  v.minrs = sa.minrs;
  v.alive = sa.alive;
  v.ccand = sa.ccand;
  v.elig = sa.elig;
  v.key = sa.key;
  v.before = sa.before;
  v.masks = sa.masks;
  v.vreq = const_cast<float*>(a.vreq);
  v.vgroup = const_cast<int*>(a.vgroup);
  float* sj = sa.s_jalloc + static_cast<size_t>(rank) * AJ1 * R;
  float* sc = sa.s_count + static_cast<size_t>(rank) * AJ1;
  float tot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) tot[r] = a.total[r];

  // prologue: this CTA's nodes, its job-state copy
  const u64 full = W == 64 ? ~0ull : ((1ull << W) - 1);
  for (int n = n0 + tid; n < n1; n += nth) {
    const size_t nw = static_cast<size_t>(n) * W;
#pragma unroll
    for (int r = 0; r < R; ++r)
      v.fidle[static_cast<size_t>(n) * R + r] =
          a.fidle0[static_cast<size_t>(n) * R + r];
    v.alive[n] = full;
    v.ccand[n] = v.elig[n] = v.key[n] = 0;
    v.minrs[n] = INFINITY;
    for (int w = 0; w < W; ++w) {
      a.owner[nw + w] = -1;
      const int gw = a.vgroup[nw + w];
      const int rw = a.rank[nw + w];
      u64 bm = 0;
      for (int u = 0; u < W; ++u)
        if (a.valid[nw + u] && a.vgroup[nw + u] == gw && a.rank[nw + u] < rw)
          bm |= 1ull << u;
      v.before[nw + w] = bm;
    }
  }
  for (int k = tid; k < AJ1; k += nth) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      v.jalloc[static_cast<size_t>(k) * R + r] =
          a.jalloc0[static_cast<size_t>(k) * R + r];
    v.count[k] = 0.f;
  }
  if (rank == 0) {
    for (int k = tid; k < P; k += nth) a.task_node[k] = -1;
    if (tid == 0) a.stats[0] = a.stats[1] = a.stats[2] = 0;
  }
  cl.sync();

  int kb = 0, bb = 0, last_g = -1, steps = 0, opens = 0, disp = 0;
  u64 part = 0;
  for (int i = 0; i < P;) {
    const int pj = a.pjob[i], g = a.pjg[i];
    if (a.first[i]) {
      if (a.gang) {
        if (last_g >= 0 && v.count[last_g] < a.needed[last_g]) {
          // the previous job missed its quota: its statement rolls back
          for (int n = n0 + tid; n < n1; n += nth) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              v.fidle[static_cast<size_t>(n) * R + r] =
                  sa.s_fidle[static_cast<size_t>(n) * R + r];
            const u64 saved = sa.s_alive[n];
            for (u64 lost = saved & ~v.alive[n]; lost; lost &= lost - 1)
              a.owner[static_cast<size_t>(n) * W +
                      __ffsll(static_cast<long long>(lost)) - 1] = -1;
            v.alive[n] = saved;
          }
          for (int k = tid; k < AJ1; k += nth) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              v.jalloc[static_cast<size_t>(k) * R + r] =
                  sj[static_cast<size_t>(k) * R + r];
            v.count[k] = sc[k];
          }
          __syncthreads();
          if (tid == 0) v.count[last_g] = -kBig;
          __syncthreads();
        }
        // this job's statement opens: snapshot
        for (int n = n0 + tid; n < n1; n += nth) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            sa.s_fidle[static_cast<size_t>(n) * R + r] =
                v.fidle[static_cast<size_t>(n) * R + r];
          sa.s_alive[n] = v.alive[n];
        }
        for (int k = tid; k < AJ1; k += nth) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            sj[static_cast<size_t>(k) * R + r] =
                v.jalloc[static_cast<size_t>(k) * R + r];
          sc[k] = v.count[k];
        }
      }
      // the job's candidate and mask words of this CTA's nodes
      for (int n = n0 + tid; n < n1; n += nth) {
        const size_t nw = static_cast<size_t>(n) * W;
        u64 cb = 0;
        for (int w = 0; w < W; ++w) {
          const int vs = a.vslot[nw + w];
          if (a.valid[nw + w] &&
              a.cand_mask[static_cast<size_t>(pj) * a.V1 + vs])
            cb |= 1ull << w;
        }
        v.ccand[n] = cb;
        for (int k = 0; k < a.M; ++k) {
          const uint8_t* row =
              a.tier_masks + (static_cast<size_t>(k) * a.PJ + pj) * a.V1;
          u64 mb = 0;
          for (int w = 0; w < W; ++w)
            if (row[a.vslot[nw + w]]) mb |= 1ull << w;
          v.masks[static_cast<size_t>(k) * N + n] = mb;
        }
      }
      if (tid == 0) {
        u64 pb = 0;
        for (int k = 0; k < a.M; ++k)
          if (a.tier_part[static_cast<size_t>(k) * a.PJ + pj]) pb |= 1ull << k;
        s_part = pb;
      }
      ++opens;
      __syncthreads();
      part = s_part;
    }
    last_g = g;
    if (v.count[g] >= a.needed[g]) {       // quota met: skip the job
      i = a.job_end[i] + 1;
      continue;
    }
    ++steps;
    float req[R];
#pragma unroll
    for (int r = 0; r < R; ++r) req[r] = a.preq[static_cast<size_t>(i) * R + r];
    float ls = 0.f;
    if (a.has_drf) {
      float lal[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        lal[r] = v.jalloc[static_cast<size_t>(g) * R + r] + req[r];
      ls = share_of<R>(lal, tot);
    }

    // every node of this CTA, then the cluster's largest key
    const float* srow = a.score_g + static_cast<size_t>(a.run_id[i]) * N;
    u64 m = 0;
    for (int n = n0 + tid; n < n1; n += nth) {
      float mk;
      m = max64(m, dispatch<R>(v, a, n, part, ls, req, srow[n], tot, &mk));
      ++disp;
    }
    m = warp_max(m);
    if (lane == 0) s_wbest[warp] = m;
    __syncthreads();
    if (tid == 0) {
      u64 b = 0;
      for (int k = 0; k < nth / 32; ++k) b = max64(b, s_wbest[k]);
      s_best[kb] = b;
    }
    cl.sync();
    if (tid == 0) {
      u64 b = 0;
      for (int r = 0; r < D; ++r)
        b = max64(b, *cl.map_shared_rank(&s_best[kb], r));
      s_pick = b;
    }
    kb ^= 1;
    __syncthreads();
    const u64 best = s_pick;
    if (best == 0) {
      // phase 1: the rest of the run fails alike; phase 2 stops the job
      i = (a.gang ? a.run_end[i] : a.job_end[i]) + 1;
      continue;
    }

    // the owner evicts the minimal row-order prefix and writes the bundle
    const int b = key_node(best);
    const int owner = b / Nl;
    if (rank == owner && tid == 0) {
      const size_t bw = static_cast<size_t>(b) * W;
      const u64 el = v.elig[b], al = v.alive[b];
      float fb[R], cum[R], freed[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fb[r] = v.fidle[static_cast<size_t>(b) * R + r];
        cum[r] = freed[r] = 0.f;
      }
      u64 evicted = 0;
      for (u64 bits = el; bits; bits &= bits - 1) {
        const int w = __ffsll(static_cast<long long>(bits)) - 1;
        const float* vw = v.vreq + (bw + w) * R;
        bool fit = true;
#pragma unroll
        for (int r = 0; r < R; ++r) fit = fit && req[r] < (fb[r] + cum[r]) + kEps;
        if (!fit) evicted |= 1ull << w;
#pragma unroll
        for (int r = 0; r < R; ++r) cum[r] = cum[r] + vw[r];
      }
      for (u64 bits = evicted; bits; bits &= bits - 1) {
        const int w = __ffsll(static_cast<long long>(bits)) - 1;
        const float* vw = v.vreq + (bw + w) * R;
#pragma unroll
        for (int r = 0; r < R; ++r) freed[r] = freed[r] + vw[r];
        a.owner[bw + w] = i;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        v.fidle[static_cast<size_t>(b) * R + r] = fb[r] + (freed[r] - req[r]);
      v.alive[b] = al & ~evicted;
      a.task_node[i] = b;
      Bundle& bu = s_bundle[bb];
      int np = 0;
      for (u64 left = evicted; left;) {
        const int w0 = __ffsll(static_cast<long long>(left)) - 1;
        const int grp = v.vgroup[bw + w0];
        float d[R];
#pragma unroll
        for (int r = 0; r < R; ++r) d[r] = 0.f;
        for (u64 bits = left; bits; bits &= bits - 1) {
          const int w = __ffsll(static_cast<long long>(bits)) - 1;
          if (v.vgroup[bw + w] != grp) continue;
          const float* vw = v.vreq + (bw + w) * R;
#pragma unroll
          for (int r = 0; r < R; ++r) d[r] = d[r] + vw[r];
          left &= ~(1ull << w);
        }
        bu.grp[np] = grp;
#pragma unroll
        for (int r = 0; r < R; ++r) bu.d[np][r] = d[r];
        ++np;
      }
      bu.np = np;
    }
    cl.sync();
    if (tid == 0) {
      // every CTA: the victim groups lose their evicted requests, then the
      // preemptor's group gains the task
      const Bundle* bu = cl.map_shared_rank(&s_bundle[bb], owner);
      const int np = bu->np;
      for (int k = 0; k < np; ++k) {
        const int grp = bu->grp[k];
#pragma unroll
        for (int r = 0; r < R; ++r)
          v.jalloc[static_cast<size_t>(grp) * R + r] =
              v.jalloc[static_cast<size_t>(grp) * R + r] - bu->d[k][r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        v.jalloc[static_cast<size_t>(g) * R + r] =
            v.jalloc[static_cast<size_t>(g) * R + r] + req[r];
      v.count[g] = v.count[g] + 1.f;
    }
    bb ^= 1;
    __syncthreads();
    ++i;
  }

  // close the last job's statement, then the per-group verdicts
  if (a.gang && last_g >= 0 && v.count[last_g] < a.needed[last_g]) {
    for (int n = n0 + tid; n < n1; n += nth) {
      const u64 saved = sa.s_alive[n];
      for (u64 lost = saved & ~v.alive[n]; lost; lost &= lost - 1)
        a.owner[static_cast<size_t>(n) * W +
                __ffsll(static_cast<long long>(lost)) - 1] = -1;
    }
    __syncthreads();
    if (tid == 0) v.count[last_g] = -kBig;
  }
  atomicAdd(&a.stats[1], disp);
  if (rank == 0 && tid == 0) {
    a.stats[0] = steps;
    a.stats[2] = opens;
  }
  cl.sync();
  if (rank == 0) {
    for (int k = tid; k < AJ1; k += nth)
      a.job_done[k] = v.count[k] >= a.needed[k] ? 1 : 0;
    __syncthreads();
    if (a.gang)
      for (int k = tid; k < P; k += nth)
        if (!a.job_done[a.pjg[k]]) a.task_node[k] = -1;
  }
}

template <int R>
cudaError_t launch_sharded(const Args& a, const ShardArgs& sa,
                           cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sa.shards);
  cfg.blockDim = dim3(kShardThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sa.shards;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, walk_sharded_kernel<R>, a, sa);
}

// the sizes, tier words and the 25 pointers of vt_evict_walk's contract
int read_args(const int64_t* ptrs, const int* ints, Args& a) {
  a.N = ints[0]; a.W = ints[1]; a.R = ints[2]; a.P = ints[3];
  a.PJ = ints[4]; a.V1 = ints[5]; a.AJ1 = ints[6]; a.G = ints[7];
  a.n_tiers = ints[8]; a.M = ints[9]; a.gang = ints[10];
  a.threads = ints[11]; a.plan = ints[12]; a.smem = ints[13];
  if (a.W < 1 || a.W > kMaxW || a.R < 1 || a.R > kMaxR || a.M < 0 ||
      a.M > kMaxM || a.n_tiers < 0 || a.n_tiers > kMaxTiers)
    return static_cast<int>(cudaErrorInvalidValue);
  a.has_drf = 0;
  int masks = 0;
  for (int t = 0; t < kMaxTiers; ++t) {
    a.tier_kind[t] = ints[14 + t];
    a.tier_size[t] = ints[14 + kMaxTiers + t];
    a.tier_lead[t] = ints[14 + 2 * kMaxTiers + t];
    if (t < a.n_tiers) {
      a.has_drf = a.has_drf || a.tier_kind[t] == 1;
      masks += a.tier_size[t];
    }
  }
  if (masks != a.M) return static_cast<int>(cudaErrorInvalidValue);
  int k = 0;
  a.fidle0 = (const float*)ptrs[k++]; a.vslot = (const int*)ptrs[k++];
  a.valid = (const uint8_t*)ptrs[k++]; a.vreq = (const float*)ptrs[k++];
  a.vgroup = (const int*)ptrs[k++]; a.rank = (const int*)ptrs[k++];
  a.cand_mask = (const uint8_t*)ptrs[k++];
  a.tier_masks = (const uint8_t*)ptrs[k++];
  a.tier_part = (const uint8_t*)ptrs[k++]; a.preq = (const float*)ptrs[k++];
  a.pjob = (const int*)ptrs[k++]; a.pjg = (const int*)ptrs[k++];
  a.first = (const uint8_t*)ptrs[k++]; a.run_id = (const int*)ptrs[k++];
  a.run_end = (const int*)ptrs[k++]; a.job_end = (const int*)ptrs[k++];
  a.score_g = (const float*)ptrs[k++]; a.needed = (const float*)ptrs[k++];
  a.jalloc0 = (const float*)ptrs[k++]; a.total = (const float*)ptrs[k++];
  a.scratch = (unsigned char*)ptrs[k++];
  a.owner = (int*)ptrs[k++]; a.task_node = (int*)ptrs[k++];
  a.job_done = (int*)ptrs[k++]; a.stats = (int*)ptrs[k++];
  return k == kNPtrs ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The walk over ``shards`` (2..8) equal shards of the node axis, one
// cluster of a CTA a shard (ops/evict.py::walk_sharded_cuda): ``ptrs`` and
// ``ints`` as vt_evict_walk's (its scratch, threads and plan unused), then
// ``sptrs`` the 14 arrays of ShardArgs in its order. Returns the launch's
// cudaError_t.
extern "C" int vt_evict_walk_sharded(const int64_t* ptrs, const int* ints,
                                     const int64_t* sptrs, int shards,
                                     void* stream) {
  Args a;
  const int err = read_args(ptrs, ints, a);
  if (err != 0) return err;
  if (shards < 2 || shards > 8 || a.N % shards || a.N < shards ||
      static_cast<unsigned>(a.N) > kMaxNode || a.P < 0 || a.AJ1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ShardArgs sa;
  int k = 0;
  sa.jalloc = (float*)sptrs[k++]; sa.count = (float*)sptrs[k++];
  sa.s_jalloc = (float*)sptrs[k++]; sa.s_count = (float*)sptrs[k++];
  sa.fidle = (float*)sptrs[k++]; sa.s_fidle = (float*)sptrs[k++];
  sa.minrs = (float*)sptrs[k++];
  sa.alive = (u64*)sptrs[k++]; sa.s_alive = (u64*)sptrs[k++];
  sa.ccand = (u64*)sptrs[k++]; sa.elig = (u64*)sptrs[k++];
  sa.key = (u64*)sptrs[k++]; sa.before = (u64*)sptrs[k++];
  sa.masks = (u64*)sptrs[k++];
  sa.shards = shards;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.R) {
    case 1: return launch_sharded<1>(a, sa, s);
    case 2: return launch_sharded<2>(a, sa, s);
    case 3: return launch_sharded<3>(a, sa, s);
    case 4: return launch_sharded<4>(a, sa, s);
    case 5: return launch_sharded<5>(a, sa, s);
    case 6: return launch_sharded<6>(a, sa, s);
    case 7: return launch_sharded<7>(a, sa, s);
    default: return launch_sharded<8>(a, sa, s);
  }
}

// Plain C entry, bound with ctypes (ops/evict.py::walk_cuda): `ptrs` holds
// the 25 tensor addresses and `ints` the 46 sizes, plan and tier words, in
// walk_cuda's order. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); cudaErrorInvalidValue for shapes the kernel
// does not take, -2 for a plan whose shared memory does not match this
// file's layout.
extern "C" int vt_evict_walk(const int64_t* ptrs, const int* ints,
                             void* stream) {
  Args a;
  const int err = read_args(ptrs, ints, a);
  if (err != 0) return err;
  if (!plan_ok(a)) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.R) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    default: return launch<8>(a, s);
  }
}
