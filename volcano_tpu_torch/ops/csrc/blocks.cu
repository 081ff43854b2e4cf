// The block auction: the tpu-blocks allocate engine's solve, as three
// kernels launched by ops/blocks.py::blocks_cuda.
//
// Replaces the XLA program volcano_tpu/ops/unified.py::_chunk_step
// (:152-310) and the sweep/pass loops of _make_blocks_solve (:313-448),
// reached through place_blocks_unified (:497) and ops/auction.py. The plain
// version beside it is ops/blocks.py::blocks_plain; this file is compiled
// with -fmad=false and performs every floating-point operation of that
// version in its order (or, where ops/blocks.py::chunk_exact proves a
// chunk's sums exact, in an order that cannot change a bit), so the two
// agree bit for bit.
//
// The host runs the pass and sweep loops. Once a solve, blocks_class_kernel
// (a block a chunk) and blocks_exact_kernel (one block) compute each task
// row's class in its chunk (rows with the same request bits and the same
// static row bits, or both without one: ops/blocks.py::task_classes) and
// each chunk's exactness flag (ops/blocks.py::chunk_exact). A pass
// launches, for each chunk of C <= 256 tasks in order:
//
// - blocks_topk_kernel: one top-K list per class that has a row with work
//   (not assigned, valid, its job alive), since every row of a class has the
//   same candidates. A fixed grid of blocks (two an SM); every block finds
//   the chunk's classes with work, then takes work items (a group of up to
//   kCPB classes, a split of the node axis): the splits fill the card when
//   the classes are few. A block reads each node's state once (16-byte
//   loads where R allows) and scores it for every class of its group
//   (FutureIdle fit, pod count, static mask; vt::dynamic_score plus the
//   masked static entry; -inf where the node does not fit). Each warp keeps
//   a class's best 32 nodes as 64-bit keys, one a lane, sorted across the
//   lanes: a batch of 32 new keys is sorted by a bitonic network of
//   shuffles and merged in (max of the two lists lane against reversed
//   lane, then a bitonic merge) only when one of them beats the warp's
//   32nd. The block merges its warps' lists; the last block of a group to
//   finish (a counter a group, after a fence) merges the splits' lists.
//   The key is the score's bits made monotone (-0 read as +0) over ~node, a
//   total order, so the merged list is lax.top_k's whatever the order the
//   blocks ran in: highest score first, equal scores in node order, -inf
//   entries in node order when fewer than K nodes fit.
// - blocks_round_kernel: one block, a thread a task of the chunk, each
//   task's class's candidate at its slot in registers and the next one
//   loaded a round ahead. Up to K bidding rounds, to their fixpoint
//   (nothing accepted, no choice or slot changed, found by
//   __syncthreads_or). Each round a block-wide bitonic sort (32-bit keys
//   below 2^23 - 1 nodes, 64-bit keys from there: the card world
//   n-past-2^23 holds that path) groups the chunk by node: on each node
//   its accepted tasks, then its bidders, each in task order. A task's
//   claimed capacity is the accepted tasks' sum on its bid node; three
//   waves decide acceptance in the reference's sequence: acc = wave(all),
//   acc |= wave(acc), acc = wave(acc), where a wave sums the earlier live
//   bidders on the node. Then one more sort groups the accepted tasks by
//   node for exactly nine steps of the alloc/pipe split (the same sums
//   against Idle) and the deltas.
//   Two sum modes, chosen per chunk:
//   * exact (every partial sum of the chunk's requests is a whole number of
//     the solve's unit below 2^24 units): segmented scans over the sorted
//     positions, warp shuffles and one barrier each, in any order (the
//     claims and the first wave in one scan);
//   * in order: the first thread of each node's group walks the group
//     alone, with no barrier between the waves or split steps, summing as
//     the reference does: claims and deltas in task order, a wave or split
//     step in four lanes by task index mod 4, each lane in task order,
//     joined as (l0 + l1) + (l2 + l3) (the order XLA:CPU gives that [C,C]
//     product), the lanes held in registers.
//   Each node's state is read once a round, by its group's first thread.
//
// Over a node mesh of D shards (ops/blocks.py with ``shards``; unified.py's
// solve with ``axis``, :152-310) a chunk launches blocks_topk_kernel once a
// shard over the shard's rows (its K_loc best into slot s of a [D, chunk,
// K_loc] buffer), blocks_merge_kernel (the global top K, ties to the lowest
// global node) and blocks_round_kernel<R, true> as one thread-block cluster
// of D CTAs, each owning a shard's rows and OR-ing its accept and alloc
// verdicts with the others through distributed shared memory; the frees
// launch once a shard.
//
// A sweep then takes the gang vote as integer tensor ops on the host's
// stream and launches blocks_free_kernel, a thread a node: the node's
// dropped tasks (grouped by node in task order by a stable sort) are summed
// in blocks of 256 tasks, each block in order and the blocks' sums in
// order, as XLA:CPU adds the sweep's [T,N] product, and added back. The host
// reads one flag a pass and one a sweep, at most 20 a solve.
//
// What bounds it on an H100: the candidate kernel's arithmetic is about
// 11R + 43 FP32 operations for each (class, node) pair, against the node
// state read once a group; the round kernel's work is the segmented sums of
// a chunk, a few thousand operations a round, on one SM. At 20,000 tasks /
// 5,000 nodes neither fills the card, so launch latency, dependent loads,
// the rounds' sort and barriers and the in-order walks set the time, not
// bytes or FP32 rate (PERF.md has the measured times).
//
// Node state entries are never -0.0 (they come from the host as +0 or
// more, and x - y, x + y of such values stay so), so updating only the
// nodes a chunk chose gives the same bits as the plain version's
// whole-array update.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "score.cuh"

namespace {

namespace cg = cooperative_groups;

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
constexpr int kCPB = 4;               // classes a work group, at most
constexpr int kMinSplit = 512;        // nodes a split of the node axis takes
constexpr int kRoundWarps = kMaxChunk / 32;
constexpr int kFreeThreads = 256;
// device counters (ops/blocks.py ROWS, CHUNKS, ROUNDS, ACCEPTED, DROPPED,
// CLASSES, EXACT_CHUNKS)
constexpr int kRows = 0, kChunks = 1, kRounds = 2, kAccepted = 3,
              kClasses = 5, kExactChunks = 6;

typedef unsigned long long u64;

// a sort key of no node: after every real one
constexpr u64 kNone = 0xffffffff00000000ull;
constexpr u64 kBidBit = 0x100;        // a bidder's key; an accepted task's not

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

// a grouping key's node (0xffffffff: none) and task
__device__ __forceinline__ unsigned key_seg(u64 k) {
  return static_cast<unsigned>(k >> 32);
}
__device__ __forceinline__ int key_task(u64 k) {
  return static_cast<int>(k & 0xff);
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

// Node n's row of an [N,R] f32 array: 16-byte loads where R allows (the
// wrapper hands over 16-byte aligned arrays).
template <int R>
__device__ __forceinline__ void load_row(const float* base, int n,
                                         float (&v)[R]) {
  const float* p = base + static_cast<size_t>(n) * R;
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const float4 x = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      const float2 x = reinterpret_cast<const float2*>(p)[k];
      v[2 * k] = x.x; v[2 * k + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = p[r];
  }
}

// ---------------------------------------------------------------------------
// candidates
// ---------------------------------------------------------------------------

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
  const int* cls;                // [Tp] each row's class in its chunk
  const int* class_rep;          // [Tp/chunk, chunk] each class's first row
  const int* n_class;            // [Tp/chunk] classes of each chunk
  u64* part;                     // [gridDim.x, kCPB, 32] the splits' lists
  int* done;                     // [kMaxChunk/kCPB] splits done, 0 between
  int* cand;                     // [chunk,K] by class
  float* cand_score;             // [chunk,K] by class
  int* counters;
  int lo, chunk, N, K;
  int ms_ld;                     // row stride of ms (N, or the whole axis
                                 // for a shard's columns)
};

// Splits of the node axis for ``groups`` work groups: enough to give every
// block of the grid an item, none shorter than kMinSplit nodes.
__device__ __forceinline__ int split_count(int groups, int N, int grid) {
  const int by_nodes = (N + kMinSplit - 1) / kMinSplit;
  const int by_grid = grid / (groups > 0 ? groups : 1);
  const int s = by_nodes < by_grid ? by_nodes : by_grid;
  return s > 1 ? s : 1;
}

template <int R>
__global__ void __launch_bounds__(kTopkThreads)
    blocks_topk_kernel(const TopkArgs a) {
  __shared__ unsigned char s_has[kMaxChunk];
  __shared__ int s_work[kMaxChunk];
  __shared__ int s_wcount[kTopkWarps];
  __shared__ u64 s_lists[kCPB][kTopkWarps][32];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = a.lo / a.chunk;
  const int ncls = a.n_class[c];

  // the chunk's classes with a row with work, in class order
  if (tid < a.chunk) s_has[tid] = 0;
  __syncthreads();
  bool work = false;
  if (tid < a.chunk) {
    const int t = a.lo + tid;
    work = has_work(t, a.assign, a.valid, a.job_ix, a.job_dead);
    if (work) s_has[a.cls[t]] = 1;
  }
  const int rows = __syncthreads_count(work);
  if (rows == 0) return;
  const bool hk = tid < ncls && s_has[tid];
  const unsigned bal = __ballot_sync(kFull, hk);
  if (lane == 0) s_wcount[warp] = __popc(bal);
  __syncthreads();
  int before = 0, nwork = 0;
#pragma unroll
  for (int w = 0; w < kTopkWarps; ++w) {
    before += w < warp ? s_wcount[w] : 0;
    nwork += s_wcount[w];
  }
  if (hk) s_work[before + __popc(bal & ((1u << lane) - 1u))] = tid;
  if (blockIdx.x == 0 && tid == 0) {
    atomicAdd(a.counters + kRows, rows);
    atomicAdd(a.counters + kClasses, nwork);
  }
  __syncthreads();

  const int groups = (nwork + kCPB - 1) / kCPB;
  const int S = split_count(groups, a.N, gridDim.x);
  float rw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rw[r] = a.rw[r];

  for (int item = blockIdx.x; item < groups * S; item += gridDim.x) {
    const int g = item / S;
    const int s = item - g * S;
    const int nj = min(kCPB, nwork - g * kCPB);   // classes in the group
    float q[kCPB][R];
    const float* srow[kCPB];
#pragma unroll
    for (int j = 0; j < kCPB; ++j) {
      const int k = s_work[g * kCPB + (j < nj ? j : nj - 1)];
      const int t = a.lo + a.class_rep[c * a.chunk + k];
#pragma unroll
      for (int r = 0; r < R; ++r)
        q[j][r] = a.req[static_cast<size_t>(t) * R + r];
      srow[j] = a.ms ? a.ms + static_cast<size_t>(t) * a.ms_ld : nullptr;
    }
    const int n0 = static_cast<int>(static_cast<long long>(s) * a.N / S);
    const int n1 = static_cast<int>(static_cast<long long>(s + 1) * a.N / S);

    u64 best[kCPB];               // 0: no node (every real key is larger)
#pragma unroll
    for (int j = 0; j < kCPB; ++j) best[j] = 0;
    for (int base = n0 + warp * 32; base < n1; base += kTopkThreads) {
      const int n = base + lane;
      const bool real = n < n1;
      float f[R], u[R], al[R];
      bool pods = false;
      if (real) {
        load_row<R>(a.fidle, n, f);
        load_row<R>(a.used, n, u);
        load_row<R>(a.alloc, n, al);
        pods = a.nt[n] < a.maxt[n];
      }
#pragma unroll
      for (int j = 0; j < kCPB; ++j) {
        if (j < nj) {
        u64 key = 0;
        if (real) {
          bool fit = pods;
#pragma unroll
          for (int r = 0; r < R; ++r) fit = fit && q[j][r] < f[r] + kEps;
          float sc = vt::dynamic_score<R>(q[j], u, al, rw, a.bw, a.lw, a.mw,
                                          a.balw);
          if (srow[j]) {
            const float st = srow[j][n];
            fit = fit && st > kNegTest;
            sc = sc + st;
          }
          key = score_key(fit ? sc : -INFINITY, n);
        }
        const u64 kth = __shfl_sync(kFull, best[j], 31);
        if (__any_sync(kFull, key > kth))
          best[j] = warp_merge_desc(best[j], warp_sort_desc(key, lane), lane);
        }
      }
    }

    // the block's list of each class: warp j merges the warps' lists of
    // class j
#pragma unroll
    for (int j = 0; j < kCPB; ++j) s_lists[j][warp][lane] = best[j];
    __syncthreads();
    u64 mine = 0;
    if (warp < nj) {
      mine = s_lists[warp][0][lane];
      for (int w = 1; w < kTopkWarps; ++w)
        mine = warp_merge_desc(mine, s_lists[warp][w][lane], lane);
    }
    bool last = true;
    if (S > 1) {
      if (warp < nj)
        a.part[(static_cast<size_t>(item) * kCPB + warp) * 32 + lane] = mine;
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(a.done + g, 1) == S - 1;
      __syncthreads();
      last = s_last;
      if (last) {
        // the group's last block merges the splits' lists: warp w takes
        // class w % kCPB's lists s = w / kCPB, w / kCPB + 2, ...
        __threadfence();
        constexpr int kHalves = kTopkWarps / kCPB;
        const int j = warp % kCPB, h = warp / kCPB;
        u64 m = 0;
        if (j < nj) {
          for (int s2 = h; s2 < S; s2 += kHalves) {
            const volatile u64* p = a.part +
                (static_cast<size_t>(g * S + s2) * kCPB + j) * 32 + lane;
            m = warp_merge_desc(m, *p, lane);
          }
        }
        s_lists[j][h][lane] = m;
        __syncthreads();
        if (warp < nj) {
          mine = s_lists[warp][0][lane];
          for (int h2 = 1; h2 < kHalves; ++h2)
            mine = warp_merge_desc(mine, s_lists[warp][h2][lane], lane);
        }
        if (tid == 0) a.done[g] = 0;
      }
    }
    if (last && warp < nj && lane < a.K) {
      const int k = s_work[g * kCPB + warp];
      a.cand[k * a.K + lane] = key_node(mine);
      a.cand_score[k * a.K + lane] = key_score(mine);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// rounds, split and deltas
// ---------------------------------------------------------------------------

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
  const int* cls;                // [Tp] each row's class in its chunk
  const unsigned char* exact;    // [Tp/chunk] the chunk's sums are exact
  const int* cand;               // [chunk,K] by class
  const float* cand_score;       // [chunk,K] by class
  int* counters;
  int lo, chunk, N, K;           // N: the nodes of the block's shard
  int shards;                    // the cluster's CTAs (sharded round only)
};

// Ascending bitonic sort of one key a thread over the block (blockDim.x a
// power of two): shuffles within a warp, shared memory across warps.
template <typename Key>
__device__ __forceinline__ Key block_sort(Key v, Key (*buf)[kMaxChunk]) {
  const int i = threadIdx.x;
  const int T = blockDim.x;
  int b = 0;
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      Key o;
      if (j >= 32) {
        buf[b][i] = v;
        __syncthreads();
        o = buf[b][i ^ j];
        b ^= 1;
      } else {
        o = __shfl_xor_sync(kFull, v, j);
      }
      const bool up = (i & k) == 0;
      const bool low = (i & j) == 0;
      v = low == up ? (o < v ? o : v) : (o < v ? v : o);
    }
  }
  return v;
}

// The chunk's tasks grouped by node: sorted keys (node << 32 | kBidBit for
// a bidder | task), kNone | task for a task on no node. Where node numbers
// fit in 23 bits the sort runs on 32-bit keys (node << 9 | bidder << 8 |
// task): a 64-bit shuffle is two, and the 32-bit sort takes the round
// kernel about a ninth less time on the 20k and 100k solves (PERF.md).
__device__ __forceinline__ u64 group_by_node(u64 key, bool narrow,
                                             u64 (*buf)[kMaxChunk]) {
  if (!narrow) return block_sort<u64>(key, buf);
  constexpr unsigned kNone32 = 0x7fffffu;
  const unsigned node = key_seg(key);
  const unsigned k32 =
      ((node == 0xffffffffu ? kNone32 : node) << 9) | (key & 0x1ff);
  const unsigned s = block_sort<unsigned>(
      k32, reinterpret_cast<unsigned (*)[kMaxChunk]>(buf));
  const unsigned n = s >> 9;
  return (n == kNone32 ? kNone : static_cast<u64>(n) << 32) | (s & 0x1ff);
}

struct ScanShared {
  float v[2][kRoundWarps][2 * kMaxR];
  int c[2][kRoundWarps];
  int h[2][kRoundWarps];
  unsigned char f[2][kRoundWarps];
};

// Inclusive segmented scan over the block's positions (thread order), a
// segment starting at each ``head``: NF floats and two ints. The floats add
// in no fixed order, so only sums proven exact may use it. Every thread
// of the block calls it; ``buf`` alternates between calls.
template <int NF>
__device__ __forceinline__ void seg_scan(bool head, float (&v)[NF], int& c,
                                         int& h, int buf, ScanShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  bool f = head;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    float o[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) o[k] = __shfl_up_sync(kFull, v[k], d);
    const int oc = __shfl_up_sync(kFull, c, d);
    const int oh = __shfl_up_sync(kFull, h, d);
    const int of = __shfl_up_sync(kFull, f ? 1 : 0, d);
    if (lane >= d) {
      if (!f) {
#pragma unroll
        for (int k = 0; k < NF; ++k) v[k] = o[k] + v[k];
        c += oc;
        h += oh;
      }
      f = f || of != 0;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < NF; ++k) sh.v[buf][warp][k] = v[k];
    sh.c[buf][warp] = c;
    sh.h[buf][warp] = h;
    sh.f[buf][warp] = f;
  }
  __syncthreads();
  if (!f) {
    for (int w = warp - 1; w >= 0; --w) {
#pragma unroll
      for (int k = 0; k < NF; ++k) v[k] = sh.v[buf][w][k] + v[k];
      c += sh.c[buf][w];
      h += sh.h[buf][w];
      if (sh.f[buf][w]) break;
    }
  }
}


// Four lane sums (task index mod 4), each in task order, in registers.
template <int R>
struct Lanes {
  float l0[R], l1[R], l2[R], l3[R];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int r = 0; r < R; ++r) l0[r] = l1[r] = l2[r] = l3[r] = 0.f;
  }
  __device__ __forceinline__ void add(int t, const float* x) {
    switch (t & 3) {
      case 0:
#pragma unroll
        for (int r = 0; r < R; ++r) l0[r] = l0[r] + x[r];
        break;
      case 1:
#pragma unroll
        for (int r = 0; r < R; ++r) l1[r] = l1[r] + x[r];
        break;
      case 2:
#pragma unroll
        for (int r = 0; r < R; ++r) l2[r] = l2[r] + x[r];
        break;
      default:
#pragma unroll
        for (int r = 0; r < R; ++r) l3[r] = l3[r] + x[r];
    }
  }
  // x + (l0 + l1) + (l2 + l3) < bound + eps in every column
  __device__ __forceinline__ bool fits(const float* x,
                                       const float (&bound)[R]) const {
    bool ok = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float cum = (l0[r] + l1[r]) + (l2[r] + l3[r]);
      ok = ok && x[r] + cum < bound[r] + kEps;
    }
    return ok;
  }
};

// In-order mode, one round of the node whose group starts at sorted
// position p (its accepted tasks, then its bidders), walked by one thread:
// the claims, then the three waves; each bidder's verdict into flag.
template <int R>
__device__ __forceinline__ void round_inorder(int p, int T, const u64* key,
                              float (*req)[R], unsigned char* flag,
                              const RoundArgs& a) {
  const unsigned seg = key_seg(key[p]);
  const int node = static_cast<int>(seg);
  float cl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) cl[r] = 0.f;
  int e = p;
  for (; e < T && key_seg(key[e]) == seg && !(key[e] & kBidBit); ++e) {
    const int t = key_task(key[e]);
#pragma unroll
    for (int r = 0; r < R; ++r) cl[r] = cl[r] + req[t][r];
  }
  const int b0 = e;
  const int claimed_cnt = b0 - p;
  int end = b0;
  while (end < T && key_seg(key[end]) == seg) ++end;
  if (end == b0) return;
  float avail[R];
  load_row<R>(a.fidle, node, avail);
#pragma unroll
  for (int r = 0; r < R; ++r) avail[r] = avail[r] - cl[r];
  const int base = a.nt[node] + claimed_cnt;
  const int maxt = a.maxt[node];
  Lanes<R> lanes;
#pragma unroll 1
  for (int w = 0; w < 3; ++w) {
    lanes.clear();
    int cnt = 0;
    for (int k = b0; k < end; ++k) {
      const int t = key_task(key[k]);
      const bool live = w == 0 || flag[t];
      const bool wv = lanes.fits(req[t], avail) && base + cnt < maxt;
      flag[t] = w == 1 ? (live || wv) : wv;
      if (live) {
        lanes.add(t, req[t]);
        ++cnt;
      }
    }
  }
}

// In-order mode, the split and deltas of the node whose accepted tasks
// start at sorted position p, walked by one thread: each task's alloc
// verdict into flag, the deltas onto the node.
template <int R>
__device__ __forceinline__ void split_inorder(int p, int T, const u64* key,
                              float (*req)[R], unsigned char* flag,
                              const RoundArgs& a) {
  const unsigned seg = key_seg(key[p]);
  const int node = static_cast<int>(seg);
  int end = p;
  while (end < T && key_seg(key[end]) == seg) ++end;
  float idle_b[R];
  load_row<R>(a.idle, node, idle_b);
  for (int k = p; k < end; ++k) flag[key_task(key[k])] = 1;
  Lanes<R> lanes;
#pragma unroll 1
  for (int step = 0; step < kAllocSteps; ++step) {
    lanes.clear();
    for (int k = p; k < end; ++k) {
      const int t = key_task(key[k]);
      const bool live = flag[t];
      flag[t] = lanes.fits(req[t], idle_b);
      if (live) lanes.add(t, req[t]);
    }
  }
  float d_alloc[R], d_all[R];
#pragma unroll
  for (int r = 0; r < R; ++r) d_alloc[r] = d_all[r] = 0.f;
  for (int k = p; k < end; ++k) {
    const int t = key_task(key[k]);
    const bool al = flag[t];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d_all[r] = d_all[r] + req[t][r];
      if (al) d_alloc[r] = d_alloc[r] + req[t][r];
    }
  }
  const size_t at = static_cast<size_t>(node) * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a.idle[at + r] = a.idle[at + r] - d_alloc[r];
    a.fidle[at + r] = a.fidle[at + r] - d_all[r];
    a.used[at + r] = a.used[at + r] + d_alloc[r];
  }
  a.nt[node] = a.nt[node] + (end - p);
}

// Whether ``v`` holds in any CTA of the cluster, for thread i of each: the
// warps' ballots go to this CTA's ``vote[vb]``, one cluster barrier, then
// each thread reads its warp's word of every CTA through distributed
// shared memory. Two vote buffers alternate: a CTA writes buffer vb again
// only after the next call's barrier, which every CTA reaches after its
// reads of this one.
__device__ __forceinline__ bool cluster_any(bool v,
                                            unsigned (*vote)[kRoundWarps],
                                            int& vb, int shards) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned bal = __ballot_sync(kFull, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) vote[vb][warp] = bal;
  cl.sync();
  bool any = false;
  for (int r = 0; r < shards; ++r) {
    const unsigned* w = cl.map_shared_rank(&vote[vb][0], r);
    any = any || ((w[warp] >> lane) & 1u);
  }
  vb ^= 1;
  return any;
}

// One block an SM at most (a chunk is one block): ptxas then need not fit
// two blocks' registers, and no instance spills.
//
// kSharded: the node axis split over a cluster of ``shards`` CTAs, CTA s
// owning nodes [s * N, (s + 1) * N) (N the shard's size, candidates global
// node ids). Every CTA holds the whole chunk's replicated state (accepted,
// choice, slot); it groups and decides only the tasks that bid for, or hold,
// one of its own nodes, reads and writes only its own nodes' rows, and
// each round's accept verdicts and the split's alloc verdicts are OR-ed over
// the cluster (cluster_any): a node's owner decides it, exactly as the
// unsharded kernel does, since a node's sums involve only its own tasks.
// CTA 0 alone writes the task outputs and counters.
template <int R, bool kSharded>
__global__ void __launch_bounds__(kMaxChunk, 1) blocks_round_kernel(
    const RoundArgs ga) {
  __shared__ float s_req[kMaxChunk][R];
  __shared__ u64 s_sort[2][kMaxChunk];
  __shared__ u64 s_key[kMaxChunk];
  __shared__ unsigned char s_flag[kMaxChunk];
  __shared__ float s_nf[kMaxChunk][R];   // by group head: FutureIdle, Idle
  __shared__ int s_ni[kMaxChunk][2];     // by group head: pods, max pods
  __shared__ ScanShared sh;
  __shared__ unsigned s_vote[2][kRoundWarps];

  RoundArgs a = ga;
  int rank = 0;
  if constexpr (kSharded) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    const size_t o = static_cast<size_t>(rank) * a.N;
    a.idle += o * R;
    a.fidle += o * R;
    a.used += o * R;
    a.nt += o;
    a.maxt += o;
  }
  const int off = rank * a.N;         // the shard's first global node
  int vb = 0;
  // thread i is task i of the chunk, and position i of each sort
  const int i = threadIdx.x;
  const int T = blockDim.x;
  const bool active = i < a.chunk;
  const int t = a.lo + i;
  const bool fresh = active && a.assign[t] == -1;
  const bool todo =
      active && has_work(t, a.assign, a.valid, a.job_ix, a.job_dead);
  if (!__syncthreads_or(todo)) {
    // the skipped chunk's rows come back NO_NODE, not pipelined
    if (fresh && rank == 0) a.pipe[t] = 0;
    return;
  }
  const bool exact = a.exact[a.lo / a.chunk] != 0;
  if (i == 0 && rank == 0) {
    atomicAdd(a.counters + kChunks, 1);
    if (exact) atomicAdd(a.counters + kExactChunks, 1);
  }
  // a row without work has no candidates (the candidate kernel skipped its
  // class unless another row has work): it bids nothing, on node 0. A row
  // with work holds its class's entries at its slot and the next one, the
  // next loaded a round ahead.
  const int row = todo ? a.cls[t] * a.K : 0;
  int bid_at = 0, bid_next = 0;
  float score_at = -INFINITY, score_next = -INFINITY;
  if (todo) {
    bid_at = a.cand[row];
    score_at = a.cand_score[row];
    const int nx = a.K > 1 ? 1 : 0;
    bid_next = a.cand[row + nx];
    score_next = a.cand_score[row + nx];
  }
  const bool narrow = a.N < (1 << 23) - 1;

#pragma unroll
  for (int r = 0; r < R; ++r)
    s_req[i][r] = active ? a.req[static_cast<size_t>(t) * R + r] : 0.f;
  bool accept = false;
  int choice = -1, slot = 0;
  int buf = 0;
  __syncthreads();

  int rounds = 0;
  bool changed = true;
  while (rounds < a.K && changed) {
    const int bid = bid_at;
    const bool bidding = !accept && todo && score_at > -INFINITY;
    // group by node: accepted tasks, then bidders, each in task order
    const bool own_choice = !kSharded || (choice >= off && choice < off + a.N);
    const bool own_bid = !kSharded || (bid >= off && bid < off + a.N);
    const u64 mine =
        accept ? (own_choice ? (static_cast<u64>(choice - off) << 32 | i)
                             : (kNone | i))
        : (bidding && own_bid)
            ? (static_cast<u64>(bid - off) << 32 | kBidBit | i)
            : (kNone | i);
    const u64 key = group_by_node(mine, narrow, s_sort);
    s_key[i] = key;
    __syncthreads();
    const bool real = (key & kNone) != kNone;
    const bool head = real && (i == 0 || key_seg(s_key[i - 1]) != key_seg(key));
    if (!exact) {
      if (head) round_inorder<R>(i, T, s_key, s_req, s_flag, a);
    } else {
      const int pt = key_task(key);
      const bool pbid = real && (key & kBidBit);
      const bool pacc = real && !(key & kBidBit);
      const int node = static_cast<int>(key_seg(key));
      if (head) {
        float f[R];
        load_row<R>(a.fidle, node, f);
#pragma unroll
        for (int r = 0; r < R; ++r) s_nf[i][r] = f[r];
        s_ni[i][0] = a.nt[node];
        s_ni[i][1] = a.maxt[node];
      }
      // one scan for the claims (the accepted tasks come first in the
      // group, so a bidder's inclusive sum is its node's claim) and the
      // first wave (every bidder live); counts as accepted << 16 | live
      float v[2 * R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r] = pacc ? s_req[pt][r] : 0.f;
        v[R + r] = pbid ? s_req[pt][r] : 0.f;
      }
      int cc = (pacc ? 1 << 16 : 0) | (pbid ? 1 : 0), hp = head ? i : 0;
      seg_scan<2 * R>(head, v, cc, hp, buf, sh);
      buf ^= 1;
      float avail[R];
#pragma unroll
      for (int r = 0; r < R; ++r) avail[r] = s_nf[hp][r] - v[r];
      const int base = s_ni[hp][0] + (cc >> 16);
      const int maxt = s_ni[hp][1];
      // wave 1 from the joint scan; waves 2 and 3 scan the live bidders
      bool room = true;
#pragma unroll
      for (int r = 0; r < R; ++r)
        room = room &&
               s_req[pt][r] + (v[R + r] - s_req[pt][r]) < avail[r] + kEps;
      bool acc = pbid && room && base + ((cc & 0xffff) - 1) < maxt;
#pragma unroll 1
      for (int w = 1; w < 3; ++w) {
        const bool live = pbid && acc;
        float x[R];
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] = live ? s_req[pt][r] : 0.f;
        int cnt = live, none = 0;
        seg_scan<R>(head, x, cnt, none, buf, sh);
        buf ^= 1;
        room = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float own = live ? s_req[pt][r] : 0.f;
          room = room && s_req[pt][r] + (x[r] - own) < avail[r] + kEps;
        }
        const bool wv = pbid && room && base + (cnt - live) < maxt;
        acc = w == 1 ? (acc || wv) : wv;
      }
      if (pbid) s_flag[pt] = acc;
    }
    __syncthreads();
    bool acc = bidding && own_bid && s_flag[i];
    if constexpr (kSharded) acc = cluster_any(acc, s_vote, vb, a.shards);

    const int new_choice = acc ? bid : choice;
    const bool new_accept = accept || acc;
    const int new_slot =
        bidding && !acc ? (slot + 1 < a.K - 1 ? slot + 1 : a.K - 1) : slot;
    const bool mine_changed = new_accept != accept || new_choice != choice ||
                              new_slot != slot;
    if (new_slot != slot) {
      bid_at = bid_next;
      score_at = score_next;
      const int nx = new_slot + 1 < a.K ? new_slot + 1 : new_slot;
      bid_next = a.cand[row + nx];
      score_next = a.cand_score[row + nx];
    }
    accept = new_accept;
    choice = new_choice;
    slot = new_slot;
    changed = __syncthreads_or(mine_changed);
    ++rounds;
  }
  if (i == 0 && rank == 0) atomicAdd(a.counters + kRounds, rounds);
  const int accepted = __syncthreads_count(accept);
  if (i == 0 && rank == 0) atomicAdd(a.counters + kAccepted, accepted);

  // alloc-vs-pipeline split (nine steps of the antitone fit map on Idle)
  // and deltas, over the accepted tasks grouped by node in task order
  const bool mine_node =
      accept && (!kSharded || (choice >= off && choice < off + a.N));
  const u64 key = group_by_node(
      mine_node ? (static_cast<u64>(choice - off) << 32 | i) : (kNone | i),
      narrow, s_sort);
  s_key[i] = key;
  __syncthreads();
  const bool real = (key & kNone) != kNone;
  const bool head = real && (i == 0 || key_seg(s_key[i - 1]) != key_seg(key));
  if (!exact) {
    if (head) split_inorder<R>(i, T, s_key, s_req, s_flag, a);
  } else {
    const int pt = key_task(key);
    const int node = static_cast<int>(key_seg(key));
    if (head) {
      float f[R];
      load_row<R>(a.idle, node, f);
#pragma unroll
      for (int r = 0; r < R; ++r) s_nf[i][r] = f[r];
    }
    bool al = real;
    int hp = 0;
#pragma unroll 1
    for (int step = 0; step < kAllocSteps; ++step) {
      float x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = al ? s_req[pt][r] : 0.f;
      int cnt = 0, h = head ? i : 0;
      seg_scan<R>(head, x, cnt, h, buf, sh);
      buf ^= 1;
      if (step == 0) hp = h;
      bool fits = true;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float own = al ? s_req[pt][r] : 0.f;
        fits = fits && s_req[pt][r] + (x[r] - own) < s_nf[hp][r] + kEps;
      }
      al = real && fits;
    }
    // deltas: each group's totals, applied by its last position
    float d[2 * R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r] = al ? s_req[pt][r] : 0.f;
      d[R + r] = real ? s_req[pt][r] : 0.f;
    }
    int cnt = real, none = 0;
    seg_scan<2 * R>(head, d, cnt, none, buf, sh);
    buf ^= 1;
    const bool tail =
        real && (i == T - 1 || key_seg(s_key[i + 1]) != key_seg(key));
    if (tail) {
      const size_t at = static_cast<size_t>(node) * R;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a.idle[at + r] = a.idle[at + r] - d[r];
        a.fidle[at + r] = a.fidle[at + r] - d[R + r];
        a.used[at + r] = a.used[at + r] + d[r];
      }
      a.nt[node] = a.nt[node] + cnt;
    }
    if (real) s_flag[pt] = al;
  }
  __syncthreads();
  bool alloc = mine_node && s_flag[i];
  if constexpr (kSharded) alloc = cluster_any(alloc, s_vote, vb, a.shards);
  // the task's row and freshness read again, not held across the rounds
  const int te = a.lo + i;
  if (rank == 0 && active && a.assign[te] == -1) {
    if (accept) a.assign[te] = choice;
    a.pipe[te] = accept && !alloc;
  }
  // no CTA leaves while another may still read its votes
  if constexpr (kSharded) cg::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// once a solve: row classes and the chunks' exactness
// ---------------------------------------------------------------------------

struct PrepArgs {
  const float* req;              // [Tp,R]
  const float* ms;               // [Tp,N] masked static, or null
  int* cls;                      // [Tp] each row's class in its chunk
  int* class_rep;                // [Tp/chunk, chunk] each class's first row
  int* n_class;                  // [Tp/chunk]
  double* total;                 // [Tp/chunk, R] the chunk's column totals
  int* valuation;                // [Tp/chunk, R] smallest 2-adic valuation
  int* bad;                      // [Tp/chunk] a negative, subnormal or
                                 // non-finite request
  unsigned char* exact;          // [Tp/chunk]
  int chunk, N, n_chunks;
};

constexpr int kNoValuation = 1 << 20;  // an all-zero column

__device__ __forceinline__ u64 word_mult(unsigned n, unsigned salt) {
  u64 z = (static_cast<u64>(n) << 8 | salt) * 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 31)) * 0xbf58476d1ce4e5b9ull;
  return (z ^ (z >> 29)) | 1ull;
}

// A chunk a block, a thread a row (warps read static rows cooperatively):
// each row's class is the first row of the chunk with the same request
// bits and static row bits; a 64-bit hash proposes that row and the bits
// decide (a row whose bits differ keeps a class of its own), so the
// classes are ops/blocks.py::task_classes'. Also the chunk's column
// totals (f64: exact below 2^53 units, so the order does not matter where
// the total is compared with 2^24 units), its smallest 2-adic valuation a
// column and whether a request is negative (or -0), subnormal or not
// finite, for blocks_exact_kernel.
template <int R>
__global__ void __launch_bounds__(kMaxChunk) blocks_class_kernel(
    const PrepArgs a) {
  __shared__ u64 s_hash[kMaxChunk];
  __shared__ int s_rep[kMaxChunk];
  __shared__ int s_local[kMaxChunk];
  __shared__ int s_wcount[kRoundWarps];
  __shared__ double s_total[kMaxR];
  __shared__ int s_val[kMaxR];
  __shared__ int s_bad;
  const int c = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const int warps = blockDim.x >> 5;
  const bool active = i < a.chunk;
  const int t = c * a.chunk + i;
  if (i < R) {
    s_total[i] = 0.0;
    s_val[i] = kNoValuation;
  }
  if (i == 0) s_bad = 0;
  __syncthreads();

  unsigned bits[R];
  u64 h = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bits[r] = active ? __float_as_uint(a.req[static_cast<size_t>(t) * R + r])
                     : 0u;
    h += (static_cast<u64>(bits[r]) + 1) * word_mult(r, 1);
    if (active) {
      const unsigned expo = (bits[r] >> 23) & 0xff;
      if ((bits[r] >> 31) || (bits[r] != 0 && (expo == 0 || expo == 0xff)))
        atomicOr(&s_bad, 1);
      if (bits[r] != 0) {
        const unsigned mant = (bits[r] & 0x7fffff) | 0x800000;
        atomicMin(&s_val[r], static_cast<int>(expo) - 150 + __ffs(mant) - 1);
      }
      atomicAdd(&s_total[r],
                static_cast<double>(__uint_as_float(bits[r])));
    }
  }
  s_hash[i] = h;
  __syncthreads();
  if (a.ms) {
    // each warp hashes whole static rows, its lanes across the columns
    for (int row = warp; row < a.chunk; row += warps) {
      const unsigned* p = reinterpret_cast<const unsigned*>(a.ms) +
                          static_cast<size_t>(c * a.chunk + row) * a.N;
      u64 hs = 0;
      for (int n = lane; n < a.N; n += 32)
        hs += (static_cast<u64>(p[n]) + 1) * word_mult(n, 2);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) hs += __shfl_xor_sync(kFull, hs, d);
      if (lane == 0) s_hash[row] = s_hash[row] * 0xd6e8feb86659fd93ull + hs;
    }
    __syncthreads();
  }
  // the proposed first row: the first of the chunk with the same hash
  int rep = i;
  if (active) {
    for (int j = 0; j < i; ++j) {
      if (s_hash[j] == s_hash[i]) {
        rep = j;
        break;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned o =
          __float_as_uint(a.req[static_cast<size_t>(c * a.chunk + rep) * R +
                                r]);
      if (o != bits[r]) rep = i;
    }
  }
  s_rep[i] = rep;
  __syncthreads();
  if (a.ms) {
    // the static rows' bits decide, a warp a row
    for (int row = warp; row < a.chunk; row += warps) {
      const int other = s_rep[row];
      if (other == row) continue;
      const unsigned* p = reinterpret_cast<const unsigned*>(a.ms);
      const size_t x = static_cast<size_t>(c * a.chunk + row) * a.N;
      const size_t y = static_cast<size_t>(c * a.chunk + other) * a.N;
      bool same = true;
      for (int n = lane; n < a.N && same; n += 32) same = p[x + n] == p[y + n];
      if (!__all_sync(kFull, same) && lane == 0) s_rep[row] = row;
    }
    __syncthreads();
    rep = s_rep[i];
  }
  // classes numbered by their first row
  const bool first = active && rep == i;
  const unsigned bal = __ballot_sync(kFull, first);
  if (lane == 0) s_wcount[warp] = __popc(bal);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < warps; ++w) {
    before += w < warp ? s_wcount[w] : 0;
    total += s_wcount[w];
  }
  const int local = before + __popc(bal & ((1u << lane) - 1u));
  s_local[i] = local;
  __syncthreads();
  if (active) {
    a.cls[t] = s_local[rep];
    if (first) a.class_rep[c * a.chunk + local] = i;
  }
  if (i == 0) {
    a.n_class[c] = total;
    a.bad[c] = s_bad;
  }
  if (i < R) {
    a.total[c * R + i] = s_total[i];
    a.valuation[c * R + i] = s_val[i];
  }
}

// One block: the solve's unit a column (the smallest valuation over the
// chunks, as ops/blocks.py::sum_unit) and each chunk's flag: no bad request
// anywhere and every column total below 2^24 units (chunk_exact).
template <int R>
__global__ void __launch_bounds__(kMaxChunk) blocks_exact_kernel(
    const PrepArgs a) {
  __shared__ int s_val[kMaxR];
  __shared__ int s_bad;
  const int i = threadIdx.x;
  if (i < R) s_val[i] = kNoValuation;
  if (i == 0) s_bad = 0;
  __syncthreads();
  for (int c = i; c < a.n_chunks; c += blockDim.x) {
    if (a.bad[c]) atomicOr(&s_bad, 1);
#pragma unroll
    for (int r = 0; r < R; ++r) atomicMin(&s_val[r], a.valuation[c * R + r]);
  }
  __syncthreads();
  for (int c = i; c < a.n_chunks; c += blockDim.x) {
    bool ok = !s_bad;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int u = s_val[r] == kNoValuation ? 0 : s_val[r];
      ok = ok && a.total[c * R + r] < ldexp(1.0, u + 24);
    }
    a.exact[c] = ok;
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

// ---------------------------------------------------------------------------
// the merge of the shards' candidate lists
// ---------------------------------------------------------------------------

struct MergeArgs {
  const int* part_cand;          // [D, chunk, Kl] shard-local nodes by class
  const float* part_score;       // [D, chunk, Kl]
  const int* n_class;            // [Tp/chunk]
  int* cand;                     // [chunk, K] global nodes by class
  float* cand_score;             // [chunk, K]
  int lo, chunk, D, Nl, Kl, K;
};

// A warp a class of the chunk: the global top K of the shards' lists (shard
// s's node j is global node s * Nl + j). A batch of 32 entries a step,
// sorted by the bitonic network and merged into the warp's best 32; the
// keys order a stable top-k of the shard-major concatenation (highest score
// first, equal scores by global node, as each shard's list is), so the
// merged list is the unsharded candidate kernel's.
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
    blocks_merge_kernel(const MergeArgs a) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (k >= a.n_class[a.lo / a.chunk]) return;
  const int total = a.D * a.Kl;
  u64 best = 0;
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    u64 key = 0;
    if (e < total) {
      const int sh = e / a.Kl, j = e - sh * a.Kl;
      const size_t at = (static_cast<size_t>(sh) * a.chunk + k) * a.Kl + j;
      key = score_key(a.part_score[at], sh * a.Nl + a.part_cand[at]);
    }
    best = warp_merge_desc(best, warp_sort_desc(key, lane), lane);
  }
  if (lane < a.K) {
    a.cand[k * a.K + lane] = key_node(best);
    a.cand_score[k * a.K + lane] = key_score(best);
  }
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
    blocks_round_kernel<R, false><<<g, b, 0, s>>>(a);
  }
};
// a cluster of g.x CTAs, one a shard
template <int R>
struct RoundShardedLaunch {
  static void go(const RoundArgs& a, dim3 g, dim3 b, cudaStream_t s) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = g;
    cfg.blockDim = b;
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.x;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, blocks_round_kernel<R, true>, a);
  }
};
template <int R>
struct ClassLaunch {
  static void go(const PrepArgs& a, dim3 g, dim3 b, cudaStream_t s) {
    blocks_class_kernel<R><<<g, b, 0, s>>>(a);
  }
};
template <int R>
struct ExactLaunch {
  static void go(const PrepArgs& a, dim3 g, dim3 b, cudaStream_t s) {
    blocks_exact_kernel<R><<<g, b, 0, s>>>(a);
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

// The scratch of vt_blocks_topk on a grid of ``grid`` blocks: the i64
// entries of ``part`` and the i32 entries of ``done`` (zeroed once).
extern "C" void vt_blocks_topk_scratch(int grid, int* part_entries,
                                       int* done_entries) {
  *part_entries = grid * kCPB * 32;
  *done_entries = kMaxChunk / kCPB;
}

// The candidates of chunk [lo, lo + chunk): one list a class with work, on
// a grid of ``grid`` blocks of 256 threads, with the scratch that
// vt_blocks_topk_scratch sizes (refused if smaller).
extern "C" int vt_blocks_topk(const float* fidle, const float* used,
                              const int* nt, const float* alloc,
                              const int* maxt, const float* rw,
                              const float* req, const unsigned char* valid,
                              const int* job_ix,
                              const unsigned char* job_dead,
                              const int* assign, const float* ms, float bw,
                              float lw, float mw, float balw, const int* cls,
                              const int* class_rep, const int* n_class,
                              void* part, int part_entries, int* done,
                              int done_entries, int* cand,
                              float* cand_score, int* counters, int lo,
                              int chunk, int N, int R, int K, int ms_ld,
                              int grid, cudaStream_t stream) {
  int need_part = 0, need_done = 0;
  vt_blocks_topk_scratch(grid, &need_part, &need_done);
  if (!shape_ok(chunk, N, R, K) || grid < 1 || lo % chunk ||
      part_entries < need_part || done_entries < need_done || ms_ld < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const TopkArgs a{fidle, used, nt, alloc, maxt, rw, req, valid, job_ix,
                   job_dead, assign, ms, bw, lw, mw, balw, cls, class_rep,
                   n_class, static_cast<u64*>(part), done, cand, cand_score,
                   counters, lo, chunk, N, K, ms_ld};
  return dispatch_r<TopkLaunch>(R, a, dim3(grid), dim3(kTopkThreads),
                                stream);
}

// The rounds, split and deltas of chunk [lo, lo + chunk): one block, a
// thread a task (threads rounded up to a power of two, at least a warp).
extern "C" int vt_blocks_round(float* idle, float* fidle, float* used,
                               int* nt, const int* maxt, const float* req,
                               const unsigned char* valid, const int* job_ix,
                               const unsigned char* job_dead, int* assign,
                               int* pipe, const int* cls,
                               const unsigned char* exact, const int* cand,
                               const float* cand_score, int* counters, int lo,
                               int chunk, int N, int R, int K,
                               cudaStream_t stream) {
  if (!shape_ok(chunk, N, R, K) || lo % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const RoundArgs a{idle,   fidle,  used,     nt,     maxt,  req,
                    valid,  job_ix, job_dead, assign, pipe,  cls,
                    exact,  cand,   cand_score, counters, lo, chunk, N, K, 1};
  int threads = 32;
  while (threads < chunk) threads <<= 1;
  return dispatch_r<RoundLaunch>(R, a, dim3(1), dim3(threads), stream);
}

// The same over node state split into ``shards`` equal shards of N nodes
// (2..8, the portable cluster size): one cluster of a CTA a shard. The
// arrays are the whole axis (shards * N rows); candidates are global nodes.
extern "C" int vt_blocks_round_sharded(
    float* idle, float* fidle, float* used, int* nt, const int* maxt,
    const float* req, const unsigned char* valid, const int* job_ix,
    const unsigned char* job_dead, int* assign, int* pipe, const int* cls,
    const unsigned char* exact, const int* cand, const float* cand_score,
    int* counters, int lo, int chunk, int N, int R, int K, int shards,
    cudaStream_t stream) {
  if (shards < 2 || shards > 8 || N < 1 ||
      !shape_ok(chunk, N * shards, R, K) || lo % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const RoundArgs a{idle,   fidle,  used,     nt,     maxt,  req,
                    valid,  job_ix, job_dead, assign, pipe,  cls,
                    exact,  cand,   cand_score, counters, lo, chunk, N, K,
                    shards};
  int threads = 32;
  while (threads < chunk) threads <<= 1;
  return dispatch_r<RoundShardedLaunch>(R, a, dim3(shards), dim3(threads),
                                        stream);
}

// The global candidates of chunk [lo, lo + chunk) from the D shards' lists
// (Kl entries a class each, shard-local nodes of Nl a shard): K entries a
// class, for every class of the chunk.
extern "C" int vt_blocks_merge(const int* part_cand, const float* part_score,
                               const int* n_class, int* cand,
                               float* cand_score, int lo, int chunk, int D,
                               int Nl, int Kl, int K, cudaStream_t stream) {
  if (chunk < 1 || chunk > kMaxChunk || lo % chunk || D < 1 || Nl < 1 ||
      Kl < 1 || Kl > kMaxK || Kl > Nl || K < 1 || K > kMaxK || K > D * Kl)
    return static_cast<int>(cudaErrorInvalidValue);
  const MergeArgs a{part_cand, part_score, n_class, cand, cand_score,
                    lo, chunk, D, Nl, Kl, K};
  constexpr int per = kMergeThreads / 32;
  blocks_merge_kernel<<<(chunk + per - 1) / per, kMergeThreads, 0, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// Once a solve: each row's class in its chunk and each chunk's exactness
// flag (two launches: a block a chunk, then one block). ``total``,
// ``valuation`` and ``bad`` are scratch of Tp/chunk * R, Tp/chunk * R and
// Tp/chunk entries.
extern "C" int vt_blocks_prep(const float* req, const float* ms, int* cls,
                              int* class_rep, int* n_class, double* total,
                              int* valuation, int* bad, unsigned char* exact,
                              int Tp, int chunk, int N, int R,
                              cudaStream_t stream) {
  if (chunk < 1 || chunk > kMaxChunk || Tp < chunk || Tp % chunk || N < 1 ||
      R < 2 || R > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  const PrepArgs a{req,   ms,  cls, class_rep, n_class, total, valuation,
                   bad,   exact, chunk, N,     Tp / chunk};
  int threads = 32;
  while (threads < chunk) threads <<= 1;
  const int err = dispatch_r<ClassLaunch>(R, a, dim3(Tp / chunk),
                                          dim3(threads), stream);
  if (err != 0) return err;
  return dispatch_r<ExactLaunch>(R, a, dim3(1), dim3(kMaxChunk), stream);
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
