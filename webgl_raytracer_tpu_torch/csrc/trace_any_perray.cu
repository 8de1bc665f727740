// Occlusion of one ray per lane by a per-ray front-to-back walk: the
// routing target of divergent (env-NEE) occlusion batches on
// cluster-rich scenes.
//
// Replaces the TPU kernel `_make_any_kernel_perray` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (_perray_walk, trace_any with perray=True). Its bits equal
// trace_any.cu's: both OR the same predicate over the clusters entered
// before t_max.
//
// Bound on the H100: FP32 intersector arithmetic; rows are read from
// global memory (L2), as in trace_closest_perray.cu, and the schedule is
// what loses time there too.
//
// Design: trace_closest_perray.cu's warp walk (intersect.cuh perray_walk)
// with the fixed cap t_max: a warp walks its rays one at a time, and sweeps
// each popped cluster with intersect.cuh's any_sweep, 32 primitives a step
// with the predicate accept_lo < ts < t_max and __any_sync after each step;
// the ray's walk ends after the step that holds its first hit.
//
// The cost form (wrt_trace_any_perray_cost, kCost = true) also writes
// each ray's count: 128 x the clusters its walk popped, the occluding one
// included. The default form is the kCost = false instantiation.
//
// Operands: od f32[10,n] as trace_any.cu; gbox as trace_closest_perray.cu.
// Output: found i32[n] (1 occluded, 0 not or inactive); the cost form also
// cost i32[n] (0 for an inactive ray).

#include "intersect.cuh"

namespace {

template <bool kCost>
__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_any_perray_kernel(const float* __restrict__ od, long long n,
                        const float* __restrict__ soa,
                        const float* __restrict__ box,
                        const float* __restrict__ gbox, int ng,
                        const int* __restrict__ ct, int k,
                        const float* __restrict__ cp, int clip_on,
                        int* __restrict__ found_out, int* __restrict__ cost_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  wrt::Ray r;
  const bool act = wrt::load_ray(od, n, i, r);
  const float hi = i < n ? od[8 * n + i] : 0.0f;
  const float lo = i < n ? od[9 * n + i] : 0.0f;
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);

  bool found = false;
  int cost_own = 0;
  unsigned todo = __ballot_sync(wrt::kFullMask, act);
  while (todo != 0u) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1u;
    const wrt::Ray b = wrt::shfl_ray(r, src);
    const float hb = __shfl_sync(wrt::kFullMask, hi, src);
    const float lb = __shfl_sync(wrt::kFullMask, lo, src);
    bool hit = false;
    int swept = 0;
    wrt::perray_walk(
        box, gbox, ng, k, wrt::slab_ray(b), lane, [&] { return hb; },
        [&](int c) {
          if constexpr (kCost) {
            ++swept;
          }
          hit = wrt::any_sweep_cluster(soa, ct, c, lane, b, lb, hb, clip);
          return hit;
        });
    found = found || (hit && lane == src);
    if (lane == src) {
      cost_own = swept;
    }
  }
  if (i < n) {
    found_out[i] = found ? 1 : 0;
    if constexpr (kCost) {
      cost_out[i] = cost_own * wrt::kLanes;
    }
  }
}

template <bool kCost>
int launch(const float* od, long long n, const float* soa, const float* box,
           const float* gbox, int ng, const int* ct, int k, const float* cp,
           int clip_on, int* found_out, int* cost_out, void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  trace_any_perray_kernel<kCost><<<static_cast<unsigned int>(blocks), wrt::kThreads,
                                   0, static_cast<cudaStream_t>(stream)>>>(
      od, n, soa, box, gbox, ng, ct, k, cp, clip_on, found_out, cost_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wrt_trace_any_perray(const float* od, long long n,
                                    const float* soa, const float* box,
                                    const float* gbox, int ng, const int* ct,
                                    int k, const float* cp, int clip_on,
                                    int* found_out, void* stream) {
  return launch<false>(od, n, soa, box, gbox, ng, ct, k, cp, clip_on, found_out, nullptr,
                       stream);
}

extern "C" int wrt_trace_any_perray_cost(const float* od, long long n,
                                         const float* soa, const float* box,
                                         const float* gbox, int ng, const int* ct,
                                         int k, const float* cp, int clip_on,
                                         int* found_out, int* cost_out, void* stream) {
  return launch<true>(od, n, soa, box, gbox, ng, ct, k, cp, clip_on, found_out, cost_out,
                      stream);
}
