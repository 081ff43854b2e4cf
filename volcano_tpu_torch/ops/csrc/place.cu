// The fused allocate solve: every pending task of a scheduling cycle placed
// in order, inside one thread block.
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
// where a plugin gives one, the [T,N] static score matrix, and does about
// 40 flops per (task, node) pair: at T=10,000, N=2,000 that is ~1e-5 s of
// bytes and ~1e-5 s of FP32. The cost is the serial chain: task t+1 depends
// on the node state task t left, so the T steps run one after another, each
// a block-wide argmax.
//
// The design for that: one block of 1,024 threads walks all T tasks in
// order (the TPU's sequential grid over task chunks becomes this loop: blocks
// on Hopper run in no order and share no scratch). Node n belongs to thread
// n % 1024 for the whole solve; only that thread reads or writes the node's
// tentative and saved state, so the state needs no synchronisation and stays
// in L1/L2. Per task: each thread scores its nodes, a warp-shuffle max of
// (score, index) preferring the lower index on a tie, one __syncthreads, and
// every warp reduces the 32 warp results itself, so all threads learn the
// pick without a second barrier (the per-warp slots are double-buffered by
// reduction count). The owner of the chosen node applies the delta. A job's
// first task saves its owned nodes' state; a job that the gang vote rejects
// at its last task copies it back, never subtracting deltas, so the state is
// bit-exact. With no static matrix (a null pointer) no static row is read.
//
// Later work: a thread-block cluster over the node axis and prefetching the
// next task's static row.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 0.1f;          // resource_info.go minResource
constexpr float kNegTest = -1e29f;    // masked static below this: infeasible

constexpr int kValid = 1, kFirst = 2, kLast = 4;
constexpr int kPlace = 1, kPipe = 2, kReady = 4, kKeep = 8;

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// ops/scores.py::combined_dynamic_score for one node, in its operation order.
template <int R>
__device__ __forceinline__ float dynamic_score(const float (&q)[R],
                                               const float (&u)[R],
                                               const float (&al)[R],
                                               const float (&rw)[R],
                                               float bw, float lw, float mw,
                                               float balw) {
  float uf[R];
#pragma unroll
  for (int r = 0; r < R; ++r) uf[r] = u[r] + q[r];

  // binpack (binpack.go:196-260)
  float per_sum = 0.f, wsum = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float per = 0.f;
    if (q[r] > 0.f && rw[r] > 0.f && uf[r] <= al[r] && al[r] > 0.f)
      per = (uf[r] * rw[r]) / al[r];
    const float w = q[r] > 0.f ? rw[r] : 0.f;
    per_sum = r == 0 ? per : per_sum + per;
    wsum = r == 0 ? w : wsum + w;
  }
  float binp = wsum > 0.f ? per_sum / wsum : 0.f;
  binp = binp * 100.f;
  binp = binp * bw;

  // least allocated (nodeorder.go:179-190), cpu and memory columns
  const float l0 = clamp01(al[0] > 0.f ? ((al[0] - u[0]) - q[0]) / al[0] : 0.f);
  const float l1 = clamp01(al[1] > 0.f ? ((al[1] - u[1]) - q[1]) / al[1] : 0.f);
  const float least = ((l0 + l1) / 2.f) * 100.f;

  // most allocated (nodeorder.go:195-202)
  float m0 = al[0] > 0.f ? uf[0] / al[0] : 0.f;
  float m1 = al[1] > 0.f ? uf[1] / al[1] : 0.f;
  m0 = m0 > 1.f ? 0.f : m0;
  m1 = m1 > 1.f ? 0.f : m1;
  const float most = ((m0 + m1) / 2.f) * 100.f;

  // balanced allocation (k8s NodeResourcesBalancedAllocation)
  const float b0 = clamp01(al[0] > 0.f ? uf[0] / al[0] : 0.f);
  const float b1 = clamp01(al[1] > 0.f ? uf[1] / al[1] : 0.f);
  const float mean = (b0 + b1) / 2.f;
  const float d0 = b0 - mean, d1 = b1 - mean;
  const float sd = sqrtf((d0 * d0 + d1 * d1) / 2.f);
  const float bal = (1.f - sd) * 100.f;

  float s = binp;
  s = s + lw * least;
  s = s + mw * most;
  s = s + balw * bal;
  return s;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
place_kernel(const float* __restrict__ req, const int* __restrict__ flags,
             const int* __restrict__ ready_need,
             const int* __restrict__ keep_need,
             const float* __restrict__ mstatic,
             const float* __restrict__ alloc,
             const int* __restrict__ max_tasks,
             const float* __restrict__ binpack_res, float bw, float lw,
             float mw, float balw, float* state, int* ntasks, float* saved,
             int* saved_nt, int* out, int T, int N) {
  __shared__ float s_score[2][kWarps];
  __shared__ int s_idx[2][kWarps];
  __shared__ int s_fit[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t RN = static_cast<size_t>(R) * N;
  float* idle = state;
  float* fidle = state + RN;
  float* used = state + 2 * RN;

  float rw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rw[r] = binpack_res[r];

  int cnt_alloc = 0, cnt_pipe = 0, reductions = 0;
  bool broken = false;

  for (int i = 0; i < T; ++i) {
    const int f = flags[i];
    const bool valid = f & kValid;

    // Job boundary open: the Statement's undo log is "copy the state back".
    if (f & kFirst) {
      for (int n = tid; n < N; n += kThreads) {
        for (size_t k = 0; k < 3 * static_cast<size_t>(R); ++k)
          saved[k * N + n] = state[k * N + n];
        saved_nt[n] = ntasks[n];
      }
      cnt_alloc = cnt_pipe = 0;
      broken = false;
    }

    int word = 0;
    // uniform over the block: every thread holds the same flags and latch
    if (valid && !broken) {
      float q[R];
#pragma unroll
      for (int r = 0; r < R; ++r) q[r] = req[static_cast<size_t>(i) * R + r];
      const float* srow =
          mstatic ? mstatic + static_cast<size_t>(i) * N : nullptr;

      float best_s = -INFINITY;
      int best_i = INT_MAX;
      int best_fit = 0;
      for (int n = tid; n < N; n += kThreads) {
        bool fit = ntasks[n] < max_tasks[n];
        float st = 0.f;
        if (srow) {
          st = srow[n];
          fit = fit && st > kNegTest;
        }
        float u[R], al[R];
        bool fit_idle = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          fit = fit && q[r] < fidle[r * N + n] + kEps;
          fit_idle = fit_idle && q[r] < idle[r * N + n] + kEps;
          u[r] = used[r * N + n];
          al[r] = alloc[r * N + n];
        }
        if (!fit) continue;
        float s = dynamic_score<R>(q, u, al, rw, bw, lw, mw, balw);
        if (srow) s = st + s;
        if (better(s, n, best_s, best_i)) {
          best_s = s;
          best_i = n;
          best_fit = fit_idle;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(kFull, best_s, off);
        const int oi = __shfl_xor_sync(kFull, best_i, off);
        const int of = __shfl_xor_sync(kFull, best_fit, off);
        if (better(os, oi, best_s, best_i)) {
          best_s = os;
          best_i = oi;
          best_fit = of;
        }
      }
      const int buf = reductions & 1;
      ++reductions;
      if (lane == 0) {
        s_score[buf][warp] = best_s;
        s_idx[buf][warp] = best_i;
        s_fit[buf][warp] = best_fit;
      }
      __syncthreads();
      best_s = s_score[buf][lane];
      best_i = s_idx[buf][lane];
      best_fit = s_fit[buf][lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(kFull, best_s, off);
        const int oi = __shfl_xor_sync(kFull, best_i, off);
        const int of = __shfl_xor_sync(kFull, best_fit, off);
        if (better(os, oi, best_s, best_i)) {
          best_s = os;
          best_i = oi;
          best_fit = of;
        }
      }

      if (best_i == INT_MAX) {
        // no node passes: the reference breaks out of the job's task loop
        // (allocate.go:206-210)
        broken = true;
      } else {
        const int n = best_i;
        if (n % kThreads == tid) {
          // allocate consumes idle (and so future idle); pipeline only
          // reserves future resources (node_info.go AddTask)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            fidle[r * N + n] = fidle[r * N + n] - q[r];
            if (best_fit) {
              idle[r * N + n] = idle[r * N + n] - q[r];
              used[r * N + n] = used[r * N + n] + q[r];
            }
          }
          ntasks[n] += 1;
        }
        if (best_fit)
          ++cnt_alloc;
        else
          ++cnt_pipe;
        word = ((n + 1) << 4) | kPlace | (best_fit ? 0 : kPipe);
      }
    }

    // Job boundary close: gang vote (gang.go jobReadyFn) -> commit or roll
    // back to the state saved at the job's first task.
    if (valid && (f & kLast)) {
      const bool ready = cnt_alloc >= ready_need[i];
      const bool keep = ready || cnt_alloc + cnt_pipe >= keep_need[i];
      word |= (ready ? kReady : 0) | (keep ? kKeep : 0);
      if (!keep) {
        for (int n = tid; n < N; n += kThreads) {
          for (size_t k = 0; k < 3 * static_cast<size_t>(R); ++k)
            state[k * N + n] = saved[k * N + n];
          ntasks[n] = saved_nt[n];
        }
      }
    }
    if (tid == 0) out[i] = word;
  }
}

template <int R>
cudaError_t launch(const float* req, const int* flags, const int* ready_need,
                   const int* keep_need, const float* mstatic,
                   const float* alloc, const int* max_tasks,
                   const float* binpack_res, float bw, float lw, float mw,
                   float balw, float* state, int* ntasks, float* saved,
                   int* saved_nt, int* out, int T, int N,
                   cudaStream_t stream) {
  place_kernel<R><<<1, kThreads, 0, stream>>>(
      req, flags, ready_need, keep_need, mstatic, alloc, max_tasks,
      binpack_res, bw, lw, mw, balw, state, ntasks, saved, saved_nt, out, T,
      N);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes (ops/place.py::place_cuda). Layouts:
// req [T,R]; flags/ready_need/keep_need/out [T]; mstatic [T,N] or null;
// alloc, and each of the three planes of state (idle, future idle, used) and
// saved, [R,N]; max_tasks/ntasks/saved_nt [N]. state and ntasks hold the
// initial node state on entry and the final state on return. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); 1 for an R
// this file was not built for.
extern "C" int vt_place(const float* req, const int* flags,
                        const int* ready_need, const int* keep_need,
                        const float* mstatic, const float* alloc,
                        const int* max_tasks, const float* binpack_res,
                        float bw, float lw, float mw, float balw,
                        float* state, int* ntasks, float* saved,
                        int* saved_nt, int* out, int T, int N, int R,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VT_PLACE_CASE(RR)                                                   \
  case RR:                                                                  \
    return static_cast<int>(launch<RR>(                                     \
        req, flags, ready_need, keep_need, mstatic, alloc, max_tasks,       \
        binpack_res, bw, lw, mw, balw, state, ntasks, saved, saved_nt, out, \
        T, N, s));
  switch (R) {
    VT_PLACE_CASE(2)
    VT_PLACE_CASE(3)
    VT_PLACE_CASE(4)
    VT_PLACE_CASE(5)
    VT_PLACE_CASE(6)
    VT_PLACE_CASE(7)
    VT_PLACE_CASE(8)
    default:
      return 1;
  }
#undef VT_PLACE_CASE
}
