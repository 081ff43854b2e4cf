// The block auction: the tpu-blocks allocate engine's solve, as three
// kernels launched by ops/blocks.py::blocks_cuda.
//
// Replaces the XLA program volcano_tpu/ops/unified.py::_chunk_step
// (:152-310) and the sweep/pass loops of _make_blocks_solve (:313-448),
// reached through place_blocks_unified (:497) and ops/auction.py. The plain
// version beside it is ops/blocks.py::blocks_plain; this file is compiled
// with -fmad=false and performs every floating-point operation of that
// version in its order, so the two agree bit for bit.
//
// The host runs the pass and sweep loops. A pass launches, for each chunk
// of C <= 256 tasks in order:
//
// - blocks_topk_kernel: one block of 256 threads for each task row of the
//   chunk. A row whose task has no work (assigned, invalid, or its job dead)
//   exits at once, so a chunk without work costs two empty launches, not a
//   host read. The threads stride the N nodes and score each one
//   (FutureIdle fit, pod count, static mask; vt::dynamic_score plus the
//   masked static entry; -inf where the node does not fit). Each warp keeps
//   its best 32 nodes as 64-bit keys, one a lane, sorted across the lanes:
//   a batch of 32 new keys is sorted by a bitonic network of shuffles and
//   merged in (max of the two lists lane against reversed lane, then a
//   bitonic merge) only when one of them beats the warp's 32nd. Warp 0
//   merges the other warps' lists the same way and writes the first K. The
//   key is the score's bits made monotone (-0 read as +0) over ~node, so
//   the list is lax.top_k's: highest score first, equal scores in node
//   order, -inf entries in node order when fewer than K nodes fit.
// - blocks_round_kernel: one block, a thread a task of the chunk, the
//   chunk's requests, bids, claims and flags in shared memory and the node
//   state in device memory. Up to K bidding rounds, to their fixpoint
//   (nothing accepted, no choice or slot changed, found by
//   __syncthreads_or); in each, a task's claimed capacity on its bid node
//   is the earlier-round accepts there, summed in task order, and three
//   waves decide acceptance in the reference's sequence: acc = wave(all),
//   acc |= wave(acc), acc = wave(acc). A wave sums the earlier live bids on
//   the same node in four lanes by task index mod 4, joined as
//   (l0 + l1) + (l2 + l3) — the order XLA:CPU gives that [C,C] product —
//   with no float atomics anywhere: each thread adds its own sums. Then
//   exactly nine steps of the alloc/pipe split (the same lane sums against
//   Idle), and the first accepted task of each node applies the node's
//   deltas, summed in task order.
//
// A sweep then takes the gang vote as integer tensor ops on the host's
// stream and launches blocks_free_kernel, a thread a node: the node's
// dropped tasks (grouped by node in task order by a stable sort) are summed
// in blocks of 256 tasks, each block in order and the blocks' sums in
// order, as XLA:CPU adds the sweep's [T,N] product, and added back. The host
// reads one flag a pass and one a sweep, at most 20 a solve.
//
// What bounds it on an H100: the candidate kernel is the bulk of the
// arithmetic, about 11R + 43 FP32 operations for each (task, node) pair it
// scores, against the node state read once a chunk; the round kernel's
// dense [C,C] sums are O(rounds * C^2 * R) operations on one SM. At 20,000
// tasks / 5,000 nodes neither fills the card: a chunk's 256 rows are two
// waves of 132 SMs, and the round kernel runs one block while the others
// idle, so launch latency and the round kernel's serial rounds set the
// time, not bytes or FP32 rate (PERF.md has the measured times).
//
// Node state entries are never -0.0 (they come from the host as +0 or
// more, and x - y, x + y of such values stay so), so updating only the
// nodes a chunk chose gives the same bits as the plain version's
// whole-array update.

#include <cuda_runtime.h>
#include <cstdint>

#include "score.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 0.1f;          // resource_info.go minResource
constexpr float kNegTest = -1e29f;    // masked static below this: infeasible
constexpr int kMaxK = 32;             // ops/blocks.py K_CAND
constexpr int kMaxChunk = 256;        // ops/blocks.py MAX_CHUNK
constexpr int kMaxR = 8;
constexpr int kAllocSteps = 9;
constexpr int kFreeBlock = 256;
constexpr int kTopkThreads = 256;
constexpr int kTopkWarps = kTopkThreads / 32;
constexpr int kFreeThreads = 256;
// device counters (ops/blocks.py ROWS, CHUNKS, ROUNDS, ACCEPTED)
constexpr int kRows = 0, kChunks = 1, kRounds = 2, kAccepted = 3;

typedef unsigned long long u64;

__device__ __forceinline__ u64 score_key(float s, int n) {
  unsigned b = __float_as_uint(s == 0.f ? 0.f : s);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<u64>(b) << 32) | (0xffffffffu - static_cast<unsigned>(n));
}

__device__ __forceinline__ float key_score(u64 k) {
  const unsigned b = static_cast<unsigned>(k >> 32);
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ int key_node(u64 k) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(k));
}

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// 32 keys, one a lane, sorted descending across the lanes.
__device__ __forceinline__ u64 warp_sort_desc(u64 v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, v, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
      v = keep_max ? umax(v, o) : umin(v, o);
    }
  }
  return v;
}

// The best 32 of two descending lists (``best`` and ``other``, one key a
// lane), descending.
__device__ __forceinline__ u64 warp_merge_desc(u64 best, u64 other,
                                               int lane) {
  u64 v = umax(best, __shfl_sync(kFull, other, 31 - lane));
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, v, j);
    v = ((lane & j) == 0) ? umax(v, o) : umin(v, o);
  }
  return v;
}

__device__ __forceinline__ bool has_work(int t, const int* assign,
                                         const unsigned char* valid,
                                         const int* job_ix,
                                         const unsigned char* job_dead) {
  return assign[t] == -1 && valid[t] && !job_dead[job_ix[t]];
}

struct TopkArgs {
  const float* fidle;            // [N,R]
  const float* used;             // [N,R]
  const int* nt;                 // [N]
  const float* alloc;            // [N,R]
  const int* maxt;               // [N]
  const float* rw;               // [R] binpack resource weights
  const float* req;              // [Tp,R]
  const unsigned char* valid;    // [Tp]
  const int* job_ix;             // [Tp]
  const unsigned char* job_dead;  // [J]
  const int* assign;             // [Tp]
  const float* ms;               // [Tp,N] masked static, or null
  float bw, lw, mw, balw;
  int* cand;                     // [C,K]
  float* cand_score;             // [C,K]
  int* counters;
  int lo, N, K;
};

template <int R>
__global__ void __launch_bounds__(kTopkThreads)
    blocks_topk_kernel(const TopkArgs a) {
  const int row = blockIdx.x;
  const int t = a.lo + row;
  if (!has_work(t, a.assign, a.valid, a.job_ix, a.job_dead)) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) atomicAdd(a.counters + kRows, 1);

  float q[R], rw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    q[r] = a.req[static_cast<size_t>(t) * R + r];
    rw[r] = a.rw[r];
  }
  const float* srow = a.ms ? a.ms + static_cast<size_t>(t) * a.N : nullptr;

  u64 best = 0;                 // 0: no node (every real key is larger)
  for (int base = warp * 32; base < a.N; base += kTopkThreads) {
    const int n = base + lane;
    u64 key = 0;
    if (n < a.N) {
      float f[R], u[R], al[R];
      bool fit = a.nt[n] < a.maxt[n];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        f[r] = a.fidle[static_cast<size_t>(n) * R + r];
        u[r] = a.used[static_cast<size_t>(n) * R + r];
        al[r] = a.alloc[static_cast<size_t>(n) * R + r];
        fit = fit && q[r] < f[r] + kEps;
      }
      float s = vt::dynamic_score<R>(q, u, al, rw, a.bw, a.lw, a.mw, a.balw);
      if (srow) {
        const float st = srow[n];
        fit = fit && st > kNegTest;
        s = s + st;
      }
      key = score_key(fit ? s : -INFINITY, n);
    }
    const u64 kth = __shfl_sync(kFull, best, 31);
    if (__any_sync(kFull, key > kth))
      best = warp_merge_desc(best, warp_sort_desc(key, lane), lane);
  }

  __shared__ u64 lists[kTopkWarps][32];
  lists[warp][lane] = best;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kTopkWarps; ++w)
    best = warp_merge_desc(best, lists[w][lane], lane);
  if (lane < a.K) {
    a.cand[row * a.K + lane] = key_node(best);
    a.cand_score[row * a.K + lane] = key_score(best);
  }
}

struct RoundArgs {
  float* idle;                   // [N,R]
  float* fidle;                  // [N,R]
  float* used;                   // [N,R]
  int* nt;                       // [N]
  const int* maxt;               // [N]
  const float* req;              // [Tp,R]
  const unsigned char* valid;
  const int* job_ix;
  const unsigned char* job_dead;
  int* assign;                   // [Tp]
  int* pipe;                     // [Tp]
  const int* cand;               // [C,K]
  const float* cand_score;       // [C,K]
  int* counters;
  int lo, chunk, K;
};

// The lane sums of one wave or split step, for thread i: over tasks j < i
// with flag[j] set and node[j] == node, req[j] added into lane j mod 4;
// the lanes joined as (l0 + l1) + (l2 + l3). Returns the count.
template <int R>
__device__ __forceinline__ int lane_sum(int i, int node,
                                        const unsigned char* flag,
                                        const int* nodes,
                                        const float (*req)[kMaxR],
                                        float (&cum)[R]) {
  float l[4][R];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r) l[k][r] = 0.f;
  int cnt = 0;
  for (int j = 0; j < i; ++j) {
    if (flag[j] && nodes[j] == node) {
      const int k = j & 3;
#pragma unroll
      for (int r = 0; r < R; ++r) l[k][r] = l[k][r] + req[j][r];
      ++cnt;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) cum[r] = (l[0][r] + l[1][r]) + (l[2][r] + l[3][r]);
  return cnt;
}

template <int R>
__global__ void __launch_bounds__(kMaxChunk) blocks_round_kernel(
    const RoundArgs a) {
  __shared__ float s_req[kMaxChunk][kMaxR];
  __shared__ int s_bid[kMaxChunk];
  __shared__ int s_choice[kMaxChunk];
  __shared__ unsigned char s_accept[kMaxChunk];
  __shared__ unsigned char s_flag[kMaxChunk];

  const int i = threadIdx.x;
  const bool active = i < a.chunk;
  const int t = a.lo + i;
  const bool fresh = active && a.assign[t] == -1;
  const bool todo =
      active && has_work(t, a.assign, a.valid, a.job_ix, a.job_dead);
  if (!__syncthreads_or(todo)) {
    // the skipped chunk's rows come back NO_NODE, not pipelined
    if (fresh) a.pipe[t] = 0;
    return;
  }
  if (i == 0) atomicAdd(a.counters + kChunks, 1);

  float q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    q[r] = active ? a.req[static_cast<size_t>(t) * R + r] : 0.f;
    s_req[i][r] = q[r];
  }
  bool accept = false;
  int choice = -1, slot = 0;
  s_accept[i] = 0;
  s_choice[i] = -1;
  __syncthreads();

  int rounds = 0;
  bool changed = true;
  while (rounds < a.K && changed) {
    // a row without work has no candidates (the candidate kernel skipped
    // it): it bids nothing, on node 0
    const int bid = todo ? a.cand[i * a.K + slot] : 0;
    const float bscore = todo ? a.cand_score[i * a.K + slot] : -INFINITY;
    const bool bidding = !accept && todo && bscore > -INFINITY;
    s_bid[i] = bid;

    // capacity earlier rounds claimed on the bid node, in task order
    float claimed[R];
#pragma unroll
    for (int r = 0; r < R; ++r) claimed[r] = 0.f;
    int claimed_cnt = 0;
    for (int c = 0; c < a.chunk; ++c) {
      if (s_accept[c] && s_choice[c] == bid) {
#pragma unroll
        for (int r = 0; r < R; ++r) claimed[r] = claimed[r] + s_req[c][r];
        ++claimed_cnt;
      }
    }
    float avail[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      avail[r] = a.fidle[static_cast<size_t>(bid) * R + r] - claimed[r];
    const int base_cnt = a.nt[bid] + claimed_cnt;
    const int maxt = a.maxt[bid];

    bool acc = true;    // wave(all): every bidder is live
#pragma unroll 1
    for (int w = 0; w < 3; ++w) {
      s_flag[i] = acc && bidding;
      __syncthreads();
      float cum[R];
      const int cnt = lane_sum<R>(i, bid, s_flag, s_bid, s_req, cum);
      bool room = true;
#pragma unroll
      for (int r = 0; r < R; ++r) room = room && q[r] + cum[r] < avail[r] + kEps;
      const bool wv = bidding && room && base_cnt + cnt < maxt;
      __syncthreads();
      acc = w == 1 ? (acc || wv) : wv;
    }

    const int new_choice = acc ? bid : choice;
    const bool new_accept = accept || acc;
    const int new_slot =
        bidding && !acc ? (slot + 1 < a.K - 1 ? slot + 1 : a.K - 1) : slot;
    const bool mine_changed = new_accept != accept || new_choice != choice ||
                              new_slot != slot;
    accept = new_accept;
    choice = new_choice;
    slot = new_slot;
    s_accept[i] = accept;
    s_choice[i] = choice;
    changed = __syncthreads_or(mine_changed);
    ++rounds;
  }
  if (i == 0) atomicAdd(a.counters + kRounds, rounds);
  const int accepted = __syncthreads_count(accept);
  if (i == 0) atomicAdd(a.counters + kAccepted, accepted);

  // alloc-vs-pipeline split: nine steps of the antitone fit map on Idle
  const int node = accept ? choice : 0;
  float idle_bid[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    idle_bid[r] = a.idle[static_cast<size_t>(node) * R + r];
  bool alloc = accept;
#pragma unroll 1
  for (int step = 0; step < kAllocSteps; ++step) {
    s_flag[i] = alloc;
    __syncthreads();
    float cum[R];
    lane_sum<R>(i, choice, s_flag, s_choice, s_req, cum);
    bool fits = true;
#pragma unroll
    for (int r = 0; r < R; ++r) fits = fits && q[r] + cum[r] < idle_bid[r] + kEps;
    __syncthreads();
    alloc = accept && fits;
  }
  s_flag[i] = alloc;
  __syncthreads();

  // deltas: the first accepted task of each node sums the node's tasks in
  // task order and applies them
  if (accept) {
    bool first = true;
    for (int j = 0; j < i && first; ++j)
      first = !(s_accept[j] && s_choice[j] == choice);
    if (first) {
      float d_alloc[R], d_all[R];
#pragma unroll
      for (int r = 0; r < R; ++r) d_alloc[r] = d_all[r] = 0.f;
      int count = 0;
      for (int j = i; j < a.chunk; ++j) {
        if (s_accept[j] && s_choice[j] == choice) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            d_all[r] = d_all[r] + s_req[j][r];
            if (s_flag[j]) d_alloc[r] = d_alloc[r] + s_req[j][r];
          }
          ++count;
        }
      }
      const size_t at = static_cast<size_t>(choice) * R;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a.idle[at + r] = a.idle[at + r] - d_alloc[r];
        a.fidle[at + r] = a.fidle[at + r] - d_all[r];
        a.used[at + r] = a.used[at + r] + d_alloc[r];
      }
      a.nt[choice] = a.nt[choice] + count;
    }
  }
  if (fresh) {
    if (accept) a.assign[t] = choice;
    a.pipe[t] = accept && !alloc;
  }
}

struct FreeArgs {
  float* idle;
  float* fidle;
  float* used;
  int* nt;
  const float* req;              // [Tp,R]
  const int* pipe;               // [Tp]
  const int* order;              // dropped tasks by node, in task order
  const int* start;              // [N+1] each node's first entry of order
  const int* count;              // [N+1] each node's dropped tasks
  int N;
};

template <int R>
__global__ void __launch_bounds__(kFreeThreads)
    blocks_free_kernel(const FreeArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const int beg = a.start[n], cnt = a.count[n];
  float acc_all[R], acc_alloc[R], part_all[R], part_alloc[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    acc_all[r] = acc_alloc[r] = part_all[r] = part_alloc[r] = 0.f;
  int block = -1;
  for (int k = beg; k < beg + cnt; ++k) {
    const int t = a.order[k];
    if (t / kFreeBlock != block) {
      if (block >= 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc_all[r] = acc_all[r] + part_all[r];
          acc_alloc[r] = acc_alloc[r] + part_alloc[r];
          part_all[r] = part_alloc[r] = 0.f;
        }
      }
      block = t / kFreeBlock;
    }
    const bool alloc = !a.pipe[t];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = a.req[static_cast<size_t>(t) * R + r];
      part_all[r] = part_all[r] + v;
      if (alloc) part_alloc[r] = part_alloc[r] + v;
    }
  }
  if (block >= 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc_all[r] = acc_all[r] + part_all[r];
      acc_alloc[r] = acc_alloc[r] + part_alloc[r];
    }
  }
  // every node, as the plain version's whole-array update
  const size_t at = static_cast<size_t>(n) * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a.idle[at + r] = a.idle[at + r] + acc_alloc[r];
    a.fidle[at + r] = a.fidle[at + r] + acc_all[r];
    a.used[at + r] = a.used[at + r] - acc_alloc[r];
  }
  a.nt[n] = a.nt[n] - cnt;
}

template <template <int> class Launch, typename Args>
int dispatch_r(int R, const Args& args, dim3 grid, dim3 block,
               cudaStream_t stream) {
  switch (R) {
    case 2: Launch<2>::go(args, grid, block, stream); break;
    case 3: Launch<3>::go(args, grid, block, stream); break;
    case 4: Launch<4>::go(args, grid, block, stream); break;
    case 5: Launch<5>::go(args, grid, block, stream); break;
    case 6: Launch<6>::go(args, grid, block, stream); break;
    case 7: Launch<7>::go(args, grid, block, stream); break;
    case 8: Launch<8>::go(args, grid, block, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int R>
struct TopkLaunch {
  static void go(const TopkArgs& a, dim3 g, dim3 b, cudaStream_t s) {
    blocks_topk_kernel<R><<<g, b, 0, s>>>(a);
  }
};
template <int R>
struct RoundLaunch {
  static void go(const RoundArgs& a, dim3 g, dim3 b, cudaStream_t s) {
    blocks_round_kernel<R><<<g, b, 0, s>>>(a);
  }
};
template <int R>
struct FreeLaunch {
  static void go(const FreeArgs& a, dim3 g, dim3 b, cudaStream_t s) {
    blocks_free_kernel<R><<<g, b, 0, s>>>(a);
  }
};

bool shape_ok(int chunk, int N, int R, int K) {
  return chunk >= 1 && chunk <= kMaxChunk && N >= 1 && R >= 2 &&
         R <= kMaxR && K >= 1 && K <= kMaxK && K <= N;
}

}  // namespace

// The candidates of chunk [lo, lo + chunk): one block of 256 threads a row.
extern "C" int vt_blocks_topk(const float* fidle, const float* used,
                              const int* nt, const float* alloc,
                              const int* maxt, const float* rw,
                              const float* req, const unsigned char* valid,
                              const int* job_ix,
                              const unsigned char* job_dead,
                              const int* assign, const float* ms, float bw,
                              float lw, float mw, float balw, int* cand,
                              float* cand_score, int* counters, int lo,
                              int chunk, int N, int R, int K,
                              cudaStream_t stream) {
  if (!shape_ok(chunk, N, R, K)) return static_cast<int>(cudaErrorInvalidValue);
  const TopkArgs a{fidle, used, nt,   alloc, maxt,       rw,       req,
                   valid, job_ix, job_dead, assign, ms,   bw,       lw,
                   mw,    balw,   cand, cand_score, counters, lo, N,
                   K};
  return dispatch_r<TopkLaunch>(R, a, dim3(chunk), dim3(kTopkThreads),
                                stream);
}

// The rounds, split and deltas of chunk [lo, lo + chunk): one block, a
// thread a task (threads rounded up to a warp).
extern "C" int vt_blocks_round(float* idle, float* fidle, float* used,
                               int* nt, const int* maxt, const float* req,
                               const unsigned char* valid, const int* job_ix,
                               const unsigned char* job_dead, int* assign,
                               int* pipe, const int* cand,
                               const float* cand_score, int* counters, int lo,
                               int chunk, int N, int R, int K,
                               cudaStream_t stream) {
  if (!shape_ok(chunk, N, R, K)) return static_cast<int>(cudaErrorInvalidValue);
  const RoundArgs a{idle,     fidle,  used,   nt,   maxt,       req,
                    valid,    job_ix, job_dead, assign, pipe,     cand,
                    cand_score, counters, lo,   chunk, K};
  const int threads = (chunk + 31) / 32 * 32;
  return dispatch_r<RoundLaunch>(R, a, dim3(1), dim3(threads), stream);
}

// The sweep's frees: a thread a node. ``order``/``start``/``count`` group
// the dropped tasks by node in task order (entry N holds the others).
extern "C" int vt_blocks_free(float* idle, float* fidle, float* used, int* nt,
                              const float* req, const int* pipe,
                              const int* order, const int* start,
                              const int* count, int N, int R,
                              cudaStream_t stream) {
  if (N < 1 || R < 2 || R > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  const FreeArgs a{idle, fidle, used, nt, req, pipe, order, start, count, N};
  return dispatch_r<FreeLaunch>(R, a,
                                dim3((N + kFreeThreads - 1) / kFreeThreads),
                                dim3(kFreeThreads), stream);
}
