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
// statement (restore the snapshot if it missed its quota) and open one;
// skip the job once its quota is met; replay the tiered dispatch over every
// node's victim slots (static plugin masks, drf's dynamic keep rule with the
// same-job prefix); take the best-scoring node where the task fits after
// evicting the eligible victims, lowest index on ties; evict the minimal
// row-order prefix of them; update future idle, job allocations and the
// quota count.
//
// Bound. The work is serial in the tasks: each task depends on the state the
// previous one left. Per task the dispatch reads every node's slots (N*W
// candidate bits, W*R requests, W^2*R prefix adds under drf) and reduces an
// argmax over N nodes. At the preempt world's shapes (N = 1,000, W <= 8,
// R = 2) that is a few thousand operations a task against the card's 67
// TFLOP/s: the bound is a fraction of a microsecond a task, and the kernel
// is bounded by the latency of its per-task chain (two block barriers, a
// block-wide argmax, one thread's eviction), not by bytes or operations.
//
// Design (simple first; making it fast is later work). One block of up to
// 1,024 threads walks the tasks; each thread owns the nodes n = tid,
// tid + blockDim, ... Victim slots of a node are bits of one 64-bit word
// (W <= 64): candidates, static masks, eligibility and drf's "earlier slot of
// the same job" relation (precomputed once) are word operations. All
// mutable state (future idle, alive slots, owners, job allocations, quota
// counts) and the gang snapshot live in device memory; a job boundary copies
// them in parallel. Thread 0 applies each task's evictions between two
// barriers. Every sum runs in the plain version's order, with -fmad=false,
// and no sum goes through a tensor core (the TPU reference hit verdict
// flips through its matrix unit, evict.py:161-167).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAXR 8
#define MAXW 64
#define MAXM 64
#define MAXTIERS 16
#define NPTRS 37

namespace {

constexpr float EPS = 0.1f;
constexpr float SHARE_DELTA = 1e-6f;
constexpr float BIGF = 1073741824.0f;   // 1 << 30: a rolled-back job's count

struct Args {
  int N, W, R, P, PJ, V1, AJ1, G, n_tiers, M, gang, threads;
  int tier_kind[MAXTIERS];   // 0 static, 1 drf
  int tier_size[MAXTIERS];
  const float* fidle0; const int* vslot; const uint8_t* valid;
  const float* vreq; const int* vgroup; const int* rank;
  const uint8_t* cand_mask; const uint8_t* tier_masks;
  const uint8_t* tier_part; const float* preq; const int* pjob;
  const int* pjg; const uint8_t* first; const int* run_id;
  const int* run_end; const int* job_end; const float* score_g;
  const float* needed; const float* jalloc0; const float* total;
  float* fidle; uint64_t* alive; int* owner; float* jalloc; float* count;
  float* s_fidle; uint64_t* s_alive; int* s_owner; float* s_jalloc;
  float* s_count;
  uint64_t* cur_cand; uint64_t* cur_mask; uint64_t* before; uint64_t* elig;
  int* task_node; int* job_done; int* steps;
};

// drf.go calculate_share: max over dims of alloc/total (1 when total == 0
// but alloc > 0)
__device__ __forceinline__ float share_of(const float* alloc,
                                          const float* total, int R) {
  float s = 0.f;
  for (int r = 0; r < R; ++r) {
    float t = total[r];
    float ratio = t > 0.f ? alloc[r] / t : (alloc[r] > 0.f ? 1.f : 0.f);
    s = (r == 0 || ratio > s) ? ratio : s;
  }
  return s;
}

// drf's dynamic keep rule over the node's candidate slots (drf.go:308-330):
// a victim stays iff the preemptor's share with the task stays <= the
// victim job's share after it loses the victim and every earlier
// candidate of the same job on this node
__device__ uint64_t drf_keep(const Args& a, int n, uint64_t cand, float ls) {
  const int W = a.W, R = a.R;
  uint64_t keep = 0;
  for (uint64_t bits = cand; bits; bits &= bits - 1) {
    int w = __ffsll((long long)bits) - 1;
    float prior[MAXR];
    for (int r = 0; r < R; ++r) prior[r] = 0.f;
    for (uint64_t ub = a.before[(size_t)n * W + w] & cand; ub; ub &= ub - 1) {
      int u = __ffsll((long long)ub) - 1;
      const float* vu = a.vreq + ((size_t)n * W + u) * R;
      for (int r = 0; r < R; ++r) prior[r] = prior[r] + vu[r];
    }
    const float* vw = a.vreq + ((size_t)n * W + w) * R;
    const float* ja = a.jalloc + (size_t)a.vgroup[(size_t)n * W + w] * R;
    float ral[MAXR];
    for (int r = 0; r < R; ++r) ral[r] = (ja[r] - prior[r]) - vw[r];
    float rs = share_of(ral, a.total, R);
    if (ls < rs || fabsf(ls - rs) <= SHARE_DELTA) keep |= 1ull << w;
  }
  return keep;
}

// the tiered dispatch on node n (session_plugins.go:187-236): returns the
// eligible victim slots
__device__ uint64_t tier_eval(const Args& a, int n, uint64_t cand,
                              uint64_t part_bits, float ls) {
  uint64_t elig = 0;
  bool decided = false;
  bool have_dset = false;
  uint64_t dset = 0;
  int off = 0;
  for (int t = 0; t < a.n_tiers; ++t) {
    int size = a.tier_size[t];
    uint64_t tset = cand;
    bool ok = true, participated = false;
    for (int k = 0; k < size; ++k) {
      if (!((part_bits >> (off + k)) & 1ull)) continue;
      uint64_t m = a.cur_mask[(size_t)(off + k) * a.N + n];
      participated = true;
      tset &= m;
      ok = ok && (cand & m) != 0;
    }
    if (a.tier_kind[t] == 1) {
      if (!have_dset) { dset = drf_keep(a, n, cand, ls); have_dset = true; }
      tset &= dset;
      ok = ok && dset != 0;
      participated = true;
    }
    if (participated) {
      if (ok && !decided) elig |= tset;
      decided = decided || ok;
    }
    off += size;
  }
  return elig;
}

__device__ __forceinline__ bool better(float s, int n, float bs, int bn) {
  return s > bs || (s == bs && n < bn);
}

__global__ void __launch_bounds__(1024, 1) walk_kernel(Args a) {
  const int N = a.N, W = a.W, R = a.R, tid = threadIdx.x, nt = blockDim.x;
  const uint64_t full = W == 64 ? ~0ull : ((1ull << W) - 1);
  __shared__ float warp_s[32];
  __shared__ int warp_n[32];
  __shared__ int sh_best;

  // prologue: state, snapshot, and drf's slot precedence words
  for (int n = tid; n < N; n += nt) {
    for (int r = 0; r < R; ++r) {
      float v = a.fidle0[(size_t)n * R + r];
      a.fidle[(size_t)n * R + r] = v;
      a.s_fidle[(size_t)n * R + r] = v;
    }
    a.alive[n] = full;
    a.s_alive[n] = full;
    for (int w = 0; w < W; ++w) {
      a.owner[(size_t)n * W + w] = -1;
      a.s_owner[(size_t)n * W + w] = -1;
      int gw = a.vgroup[(size_t)n * W + w];
      int rw = a.rank[(size_t)n * W + w];
      uint64_t bm = 0;
      for (int u = 0; u < W; ++u)
        if (a.valid[(size_t)n * W + u] && a.vgroup[(size_t)n * W + u] == gw
            && a.rank[(size_t)n * W + u] < rw)
          bm |= 1ull << u;
      a.before[(size_t)n * W + w] = bm;
    }
  }
  for (int k = tid; k < a.AJ1 * R; k += nt) {
    a.jalloc[k] = a.jalloc0[k];
    a.s_jalloc[k] = a.jalloc0[k];
  }
  for (int k = tid; k < a.AJ1; k += nt) {
    a.count[k] = 0.f;
    a.s_count[k] = 0.f;
  }
  __syncthreads();

  uint64_t part_bits = 0;
  int last_g = -1;
  int steps = 0;
  for (int i = 0; i < a.P;) {
    const int pj = a.pjob[i], g = a.pjg[i];
    if (a.first[i]) {
      if (a.gang) {
        // close the previous job's statement: discard on a missed quota
        bool failed = last_g >= 0 && a.count[last_g] < a.needed[last_g];
        __syncthreads();
        if (failed) {
          for (int n = tid; n < N; n += nt) {
            for (int r = 0; r < R; ++r)
              a.fidle[(size_t)n * R + r] = a.s_fidle[(size_t)n * R + r];
            a.alive[n] = a.s_alive[n];
            for (int w = 0; w < W; ++w)
              a.owner[(size_t)n * W + w] = a.s_owner[(size_t)n * W + w];
          }
          for (int k = tid; k < a.AJ1 * R; k += nt) a.jalloc[k] = a.s_jalloc[k];
          for (int k = tid; k < a.AJ1; k += nt) a.count[k] = a.s_count[k];
          __syncthreads();
          if (tid == 0) a.count[last_g] = -BIGF;
        }
        __syncthreads();
        // open this job's statement
        for (int n = tid; n < N; n += nt) {
          for (int r = 0; r < R; ++r)
            a.s_fidle[(size_t)n * R + r] = a.fidle[(size_t)n * R + r];
          a.s_alive[n] = a.alive[n];
          for (int w = 0; w < W; ++w)
            a.s_owner[(size_t)n * W + w] = a.owner[(size_t)n * W + w];
        }
        for (int k = tid; k < a.AJ1 * R; k += nt) a.s_jalloc[k] = a.jalloc[k];
        for (int k = tid; k < a.AJ1; k += nt) a.s_count[k] = a.count[k];
      }
      // this job's candidate and mask words
      for (int n = tid; n < N; n += nt) {
        uint64_t cb = 0;
        for (int w = 0; w < W; ++w) {
          int v = a.vslot[(size_t)n * W + w];
          if (a.valid[(size_t)n * W + w] && a.cand_mask[(size_t)pj * a.V1 + v])
            cb |= 1ull << w;
        }
        a.cur_cand[n] = cb;
        for (int k = 0; k < a.M; ++k) {
          const uint8_t* row = a.tier_masks + ((size_t)k * a.PJ + pj) * a.V1;
          uint64_t mb = 0;
          for (int w = 0; w < W; ++w)
            if (row[a.vslot[(size_t)n * W + w]]) mb |= 1ull << w;
          a.cur_mask[(size_t)k * N + n] = mb;
        }
      }
      part_bits = 0;
      for (int k = 0; k < a.M; ++k)
        if (a.tier_part[(size_t)k * a.PJ + pj]) part_bits |= 1ull << k;
      __syncthreads();
    }
    last_g = g;
    if (a.count[g] >= a.needed[g]) {     // quota met: skip the job
      i = a.job_end[i] + 1;
      continue;
    }
    ++steps;
    float req[MAXR];
    for (int r = 0; r < R; ++r) req[r] = a.preq[(size_t)i * R + r];
    float ls = 0.f;
    {
      float lalloc[MAXR];
      for (int r = 0; r < R; ++r)
        lalloc[r] = a.jalloc[(size_t)g * R + r] + req[r];
      ls = share_of(lalloc, a.total, R);
    }
    const float* srow = a.score_g + (size_t)a.run_id[i] * N;

    // every node: eligible victims, fit, score; keep this thread's best
    float bs = -INFINITY;
    int bn = 0x7fffffff;
    for (int n = tid; n < N; n += nt) {
      uint64_t cand = a.alive[n] & a.cur_cand[n];
      uint64_t elig = tier_eval(a, n, cand, part_bits, ls);
      a.elig[n] = elig;
      if (!elig) continue;
      float ev[MAXR];
      for (int r = 0; r < R; ++r) ev[r] = 0.f;
      for (uint64_t bits = elig; bits; bits &= bits - 1) {
        int w = __ffsll((long long)bits) - 1;
        const float* vw = a.vreq + ((size_t)n * W + w) * R;
        for (int r = 0; r < R; ++r) ev[r] = ev[r] + vw[r];
      }
      bool fits = true;
      for (int r = 0; r < R; ++r)
        fits = fits && req[r] < (a.fidle[(size_t)n * R + r] + ev[r]) + EPS;
      float s = srow[n];
      if (fits && s > -INFINITY && better(s, n, bs, bn)) { bs = s; bn = n; }
    }
    // block-wide argmax, the lowest index winning ties
    for (int o = 16; o > 0; o >>= 1) {
      float os = __shfl_down_sync(0xffffffffu, bs, o);
      int on = __shfl_down_sync(0xffffffffu, bn, o);
      if (better(os, on, bs, bn)) { bs = os; bn = on; }
    }
    if ((tid & 31) == 0) { warp_s[tid >> 5] = bs; warp_n[tid >> 5] = bn; }
    __syncthreads();
    if (tid < 32) {
      int nw = (nt + 31) >> 5;
      bs = tid < nw ? warp_s[tid] : -INFINITY;
      bn = tid < nw ? warp_n[tid] : 0x7fffffff;
      for (int o = 16; o > 0; o >>= 1) {
        float os = __shfl_down_sync(0xffffffffu, bs, o);
        int on = __shfl_down_sync(0xffffffffu, bn, o);
        if (better(os, on, bs, bn)) { bs = os; bn = on; }
      }
      if (tid == 0) sh_best = bs > -INFINITY ? bn : -1;
    }
    __syncthreads();
    const int best = sh_best;
    if (best < 0) {
      // phase 1: the rest of the run fails alike; phase 2 stops the job
      i = (a.gang ? a.run_end[i] : a.job_end[i]) + 1;
      continue;
    }
    if (tid == 0) {
      // the minimal row-order prefix of the eligible victims that fits
      const uint64_t elig = a.elig[best];
      float* fb = a.fidle + (size_t)best * R;
      float cum[MAXR], freed[MAXR];
      for (int r = 0; r < R; ++r) { cum[r] = 0.f; freed[r] = 0.f; }
      uint64_t evicted = 0;
      for (int w = 0; w < W; ++w) {
        if (!((elig >> w) & 1ull)) continue;
        const float* vw = a.vreq + ((size_t)best * W + w) * R;
        bool fit = true;
        for (int r = 0; r < R; ++r) fit = fit && req[r] < (fb[r] + cum[r]) + EPS;
        if (!fit) evicted |= 1ull << w;
        for (int r = 0; r < R; ++r) cum[r] = cum[r] + vw[r];
      }
      for (int w = 0; w < W; ++w) {
        if (!((evicted >> w) & 1ull)) continue;
        const float* vw = a.vreq + ((size_t)best * W + w) * R;
        for (int r = 0; r < R; ++r) freed[r] = freed[r] + vw[r];
        a.owner[(size_t)best * W + w] = i;
      }
      for (int r = 0; r < R; ++r) fb[r] = fb[r] + (freed[r] - req[r]);
      a.alive[best] &= ~evicted;
      // each victim job loses its evicted requests (summed per job in slot
      // order, then subtracted once)
      uint64_t left = evicted;
      while (left) {
        int w0 = __ffsll((long long)left) - 1;
        int grp = a.vgroup[(size_t)best * W + w0];
        float d[MAXR];
        for (int r = 0; r < R; ++r) d[r] = 0.f;
        for (uint64_t bits = left; bits; bits &= bits - 1) {
          int w = __ffsll((long long)bits) - 1;
          if (a.vgroup[(size_t)best * W + w] != grp) continue;
          const float* vw = a.vreq + ((size_t)best * W + w) * R;
          for (int r = 0; r < R; ++r) d[r] = d[r] + vw[r];
          left &= ~(1ull << w);
        }
        for (int r = 0; r < R; ++r)
          a.jalloc[(size_t)grp * R + r] = a.jalloc[(size_t)grp * R + r] - d[r];
      }
      for (int r = 0; r < R; ++r)
        a.jalloc[(size_t)g * R + r] = a.jalloc[(size_t)g * R + r] + req[r];
      a.count[g] = a.count[g] + 1.f;
      a.task_node[i] = best;
    }
    __syncthreads();
    ++i;
  }

  // close the last job's statement, then the per-group verdicts
  if (a.gang && last_g >= 0 && a.count[last_g] < a.needed[last_g]) {
    __syncthreads();
    for (int n = tid; n < N; n += nt) {
      a.alive[n] = a.s_alive[n];
      for (int w = 0; w < W; ++w)
        a.owner[(size_t)n * W + w] = a.s_owner[(size_t)n * W + w];
    }
    __syncthreads();
    if (tid == 0) a.count[last_g] = -BIGF;
  }
  __syncthreads();
  for (int k = tid; k < a.AJ1; k += nt)
    a.job_done[k] = a.count[k] >= a.needed[k] ? 1 : 0;
  __syncthreads();
  if (a.gang)
    for (int k = tid; k < a.P; k += nt)
      if (!a.job_done[a.pjg[k]]) a.task_node[k] = -1;
  if (tid == 0) a.steps[0] = steps;
}

__global__ void fill_int(int* p, int n, int v) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) p[k] = v;
}

}  // namespace

extern "C" int vt_evict_walk(const int64_t* ptrs, const int* ints,
                             void* stream) {
  Args a;
  a.N = ints[0]; a.W = ints[1]; a.R = ints[2]; a.P = ints[3];
  a.PJ = ints[4]; a.V1 = ints[5]; a.AJ1 = ints[6]; a.G = ints[7];
  a.n_tiers = ints[8]; a.M = ints[9]; a.gang = ints[10];
  a.threads = ints[11];
  if (a.W < 1 || a.W > MAXW || a.R < 1 || a.R > MAXR || a.M > MAXM
      || a.n_tiers > MAXTIERS || a.threads < 32 || a.threads > 1024
      || a.threads % 32)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < MAXTIERS; ++t) {
    a.tier_kind[t] = ints[12 + t];
    a.tier_size[t] = ints[12 + MAXTIERS + t];
  }
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
  a.fidle = (float*)ptrs[k++]; a.alive = (uint64_t*)ptrs[k++];
  a.owner = (int*)ptrs[k++]; a.jalloc = (float*)ptrs[k++];
  a.count = (float*)ptrs[k++]; a.s_fidle = (float*)ptrs[k++];
  a.s_alive = (uint64_t*)ptrs[k++]; a.s_owner = (int*)ptrs[k++];
  a.s_jalloc = (float*)ptrs[k++]; a.s_count = (float*)ptrs[k++];
  a.cur_cand = (uint64_t*)ptrs[k++]; a.cur_mask = (uint64_t*)ptrs[k++];
  a.before = (uint64_t*)ptrs[k++]; a.elig = (uint64_t*)ptrs[k++];
  a.task_node = (int*)ptrs[k++]; a.job_done = (int*)ptrs[k++];
  a.steps = (int*)ptrs[k++];
  if (k != NPTRS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.P > 0) {
    fill_int<<<(a.P + 255) / 256, 256, 0, s>>>(a.task_node, a.P, -1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  walk_kernel<<<1, a.threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
