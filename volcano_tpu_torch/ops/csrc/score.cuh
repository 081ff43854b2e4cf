// The dynamic node score of one (task, node) pair, shared by the kernels
// of this directory: place.cu (the fused allocate solve) and blocks.cu (the
// block auction). It performs every floating-point operation of
// ops/scores.py::combined_dynamic_score in the same order; with
// -fmad=false (ops/build.py) no multiply-add is contracted, so it rounds as
// the PyTorch version does.

#pragma once

#include <cmath>

namespace vt {

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

}  // namespace vt
