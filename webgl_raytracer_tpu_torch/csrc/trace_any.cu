// Occlusion of one ray per lane with t in (accept_lo, t_max): the env-NEE
// shadow query and bounded any-hit queries.
//
// Replaces the TPU kernel `_make_any_kernel` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (any_plain, trace_any).
//
// Bound on the H100: FP32 intersector arithmetic (the cluster table stays
// in L1/L2; the ray operand is read once). A ray needs a slab test per
// cluster and up to 128 primitive tests per cluster it enters before
// t_max, fewer once a primitive occludes it. What loses time is the
// schedule, as for trace_any3.cu.
//
// Design: trace_any3.cu's two warp schedules with one direction, a per-ray
// t_max and a per-ray accept_lo; no block barriers, no shared memory. A
// ray that is inactive or misses the root AABB is resolved as unoccluded.
//  * cluster-major (k < kRayMajorClusters): the warp walks the clusters in
//    index order while any of its rays is pending; __ballot_sync gathers
//    the rays that enter the cluster's AABB before their t_max (each
//    lane's reciprocal direction computed once), and a needed cluster's
//    primitives are loaded into registers once (4 a lane, coalesced
//    128-byte row loads) and swept for one needing ray at a time, its ray,
//    accept_lo and t_max broadcast by __shfl_sync, 32 primitives a step
//    with the predicate accept_lo < ts < t_max and __any_sync after each
//    step, so an occluded ray stops after the step that holds its first
//    hit;
//  * ray-major (k >= kRayMajorClusters): the warp takes its pending rays
//    one at a time through intersect.cuh any_raymajor (the lanes test 32
//    cluster AABBs of the ray at once, and the warp sweeps the clusters it
//    enters before t_max until one occludes it).
// Occlusion is an order-free OR over (ray, primitive) predicates, so both
// give any_plain's bits. Lanes past n stay in every collective and write
// nothing.
//
// The cost forms (wrt_trace_any_cost, wrt_trace_any_cost_schedule; kCost
// = true) also write each ray's count: 128 x the clusters swept for it,
// in index order, up to and including the first that occludes it. The
// cluster-major lane adds its own bit of each need mask; the ray-major
// walk counts on every lane and the ray's own lane keeps it. Both visit in
// index order, so both give the same count. The default forms are the
// kCost = false instantiations, with no counter.
//
// Operands: od f32[10,n] rows 0-2 d, 3-5 centred origin, 6 t_min,
// 7 activity (1/0), 8 t_max, 9 accept_lo; soa, box, ct, cp as in
// trace_closest.cu. Output: found i32[n] (1 occluded, 0 not or inactive);
// the cost forms also cost i32[n] (0 for an inactive ray or one missing
// the root).

#include "intersect.cuh"

namespace {

// Scenes of at least this many clusters take the ray-major schedule. On
// the H100 (chip_smoke.py, each schedule forced on the sky-lit 1080p
// bounce-0 env-NEE batches, kernel alone, PERF.md) the cluster-major one
// took 0.043 ms against 0.054 at K = 12 (1000 spheres) and the ray-major
// one 0.128 ms against 0.172 at K = 128 (10k spheres).
constexpr int kRayMajorClusters = 64;

// Lane i's ray, its slab terms, (accept_lo, t_max) and pending bit.
struct AnyRay {
  wrt::Ray r;
  wrt::SlabRay sr;
  float lo, hi;
  bool pending;
};

__device__ __forceinline__ AnyRay load_any_ray(const float* __restrict__ od, long long n,
                                               long long i, const float* __restrict__ cp) {
  AnyRay a;
  const bool act = wrt::load_ray(od, n, i, a.r);
  a.sr = wrt::slab_ray(a.r);
  a.hi = i < n ? od[8 * n + i] : 0.0f;
  a.lo = i < n ? od[9 * n + i] : 0.0f;
  // Root gate: missing the scene box resolves the ray as unoccluded.
  a.pending = act && wrt::slab_entry(cp + 8, a.sr) < INFINITY;
  return a;
}

// Cluster-major: sweep cluster rows (type T) for the warp's rays in need,
// the lane's primitives in registers. Returns whether this lane's ray is
// occluded there.
template <int T>
__device__ __forceinline__ bool any_cluster(const float* __restrict__ rows, int lane,
                                            unsigned need, const AnyRay& a,
                                            const wrt::Clip& clip) {
  float p[wrt::kSteps][wrt::kRows];
  wrt::load_lane_prims<T>(p, rows, lane);
  bool found = false;
  while (need != 0u) {
    const int src = __ffs(need) - 1;
    need &= need - 1u;
    const wrt::Ray b = wrt::shfl_ray(a.r, src);
    const float lo = __shfl_sync(wrt::kFullMask, a.lo, src);
    const float hi = __shfl_sync(wrt::kFullMask, a.hi, src);
    bool hit = false;
#pragma unroll
    for (int q = 0; q < wrt::kSteps; ++q) {
      const float ts = wrt::prim_t_regs<T>(p[q], b, clip);
      if (__any_sync(wrt::kFullMask, ts > lo && ts < hi)) {
        hit = true;
        break;
      }
    }
    found = found || (hit && lane == src);
  }
  return found;
}

template <bool kCost>
__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_any_kernel(const float* __restrict__ od, long long n,
                 const float* __restrict__ soa,
                 const float* __restrict__ box,
                 const int* __restrict__ ct, int k,
                 const float* __restrict__ cp, int clip_on,
                 int* __restrict__ found_out, int* __restrict__ cost_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  AnyRay a = load_any_ray(od, n, i, cp);
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);
  bool found = false;
  int swept = 0;

  for (int c = 0; c < k; ++c) {
    if (!__any_sync(wrt::kFullMask, a.pending)) {
      break;
    }
    const bool want = a.pending && wrt::slab_entry(box + 6 * c, a.sr) < a.hi;
    const unsigned need = __ballot_sync(wrt::kFullMask, want);
    if constexpr (kCost) {
      swept += want ? 1 : 0;
    }
    if (need == 0u) {
      continue;
    }
    const float* rows = soa + static_cast<long long>(c) * wrt::kClusterFloats;
    bool hit = false;
    wrt::by_type(ct[c], [&](auto type) {
      hit = any_cluster<decltype(type)::value>(rows, lane, need, a, clip);
    });
    found = found || hit;
    a.pending = a.pending && !found;
  }
  if (i < n) {
    found_out[i] = found ? 1 : 0;
    if constexpr (kCost) {
      cost_out[i] = swept * wrt::kLanes;
    }
  }
}

// Ray-major: the warp walks each pending ray's clusters with
// intersect.cuh's any_raymajor until one occludes it.
template <bool kCost>
__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_any_raymajor_kernel(const float* __restrict__ od, long long n,
                          const float* __restrict__ soa,
                          const float* __restrict__ box,
                          const int* __restrict__ ct, int k,
                          const float* __restrict__ cp, int clip_on,
                          int* __restrict__ found_out, int* __restrict__ cost_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  const AnyRay a = load_any_ray(od, n, i, cp);
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);
  bool found = false;
  int cost_own = 0;

  unsigned m = __ballot_sync(wrt::kFullMask, a.pending);
  while (m != 0u) {
    const int src = __ffs(m) - 1;
    m &= m - 1u;
    const wrt::Ray b = wrt::shfl_ray(a.r, src);
    const float lo = __shfl_sync(wrt::kFullMask, a.lo, src);
    const float hi = __shfl_sync(wrt::kFullMask, a.hi, src);
    int swept = 0;
    const bool hit =
        wrt::any_raymajor<kCost>(soa, box, ct, k, lane, b, lo, hi, hi, clip, &swept);
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
           const int* ct, int k, const float* cp, int clip_on, int* found_out,
           int* cost_out, int ray_major, void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  const auto kernel =
      ray_major ? trace_any_raymajor_kernel<kCost> : trace_any_kernel<kCost>;
  kernel<<<static_cast<unsigned int>(blocks), wrt::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(od, n, soa, box, ct, k, cp, clip_on,
                                                 found_out, cost_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Either schedule, forced: ray_major 1 or 0. wrt_trace_any picks by k;
// chip_smoke.py times both on the same operands.
extern "C" int wrt_trace_any_schedule(const float* od, long long n, const float* soa,
                                      const float* box, const int* ct, int k,
                                      const float* cp, int clip_on, int* found_out,
                                      int ray_major, void* stream) {
  return launch<false>(od, n, soa, box, ct, k, cp, clip_on, found_out, nullptr, ray_major,
                       stream);
}

extern "C" int wrt_trace_any(const float* od, long long n, const float* soa,
                             const float* box, const int* ct, int k,
                             const float* cp, int clip_on, int* found_out,
                             void* stream) {
  return wrt_trace_any_schedule(od, n, soa, box, ct, k, cp, clip_on, found_out,
                                k >= kRayMajorClusters ? 1 : 0, stream);
}

extern "C" int wrt_trace_any_cost_schedule(const float* od, long long n,
                                           const float* soa, const float* box,
                                           const int* ct, int k, const float* cp,
                                           int clip_on, int* found_out, int* cost_out,
                                           int ray_major, void* stream) {
  return launch<true>(od, n, soa, box, ct, k, cp, clip_on, found_out, cost_out, ray_major,
                      stream);
}

extern "C" int wrt_trace_any_cost(const float* od, long long n, const float* soa,
                                  const float* box, const int* ct, int k,
                                  const float* cp, int clip_on, int* found_out,
                                  int* cost_out, void* stream) {
  return wrt_trace_any_cost_schedule(od, n, soa, box, ct, k, cp, clip_on, found_out,
                                     cost_out, k >= kRayMajorClusters ? 1 : 0, stream);
}
