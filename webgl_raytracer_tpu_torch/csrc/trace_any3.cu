// Occlusion of three co-origin rays per lane: the 3-cone-light shadow fan.
//
// Replaces the TPU kernel `_make_any3_kernel` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (any3_plain, trace_any3).
//
// Bound on the H100: FP32 operations. The cluster table stays in L1/L2;
// a direction needs a slab test per cluster and up to 128 primitive tests
// per cluster it enters, fewer once a primitive occludes it. For the
// 1000-sphere frame's bounce-0 fan that is 0.007 ms of the card's 67
// TFLOP/s. What loses time is the schedule: one thread sweeping its own
// three directions, 128 primitives at a time, keeps its warp busy for as
// long as its slowest lane, whatever share of the lanes needs the sweep,
// and a block-staged walk waits at four block barriers per cluster.
//
// Design: no block barriers and no shared memory. A warp owns 32 lanes,
// each carrying three directions that share an origin, each with its own
// activity bit; a direction that misses the root AABB is resolved as
// unoccluded. A cluster is swept for one (lane, direction) at a time, the
// ray broadcast by __shfl_sync, each lane testing primitives lane,
// lane+32, lane+64, lane+96 of the cluster: 32 primitives a step with the
// hit predicate accept_lo < ts < 1e20 and __any_sync after each step, so
// an occluded direction stops after the step that holds its first hit.
// No lane tests a primitive that no ray needs. Two schedules choose which
// (direction, cluster) pairs to sweep, by the scene's cluster count:
//  * cluster-major (k < kRayMajorClusters): the warp walks the clusters in
//    index order while any of its directions is pending; each lane tests
//    its pending directions against the cluster's AABB (the relevance
//    gate, the reciprocal directions computed once), __ballot_sync
//    gathers one need mask per direction, and a needed cluster's
//    primitives are loaded into registers once (coalesced 128-byte row
//    loads through the read-only path) for all the rays that need it;
//  * ray-major (k >= kRayMajorClusters): the warp takes its pending
//    (lane, direction) pairs one at a time; the lanes test 32 cluster
//    AABBs of that ray at once, and the warp sweeps the clusters it enters
//    until one occludes it, each lane loading its primitive of each step.
//    At K = 128 this costs each lane about K/32 slab tests a ray instead
//    of K per direction, and a resolved ray costs nothing more.
// Occlusion is an order-free OR over (ray, primitive) predicates, so both
// give any3_plain's bits. The primitive tests are intersect.cuh's, built
// -fmad=false; the sphere test returns early on a miss, so a step whose
// 32 primitives all miss skips the square root.
//
// The cost form (wrt_trace_any3_cost, kCost = true) also writes each
// lane's count: 128 x its (direction, cluster) sweeps, each direction's in
// index order up to and including the first cluster that occludes it,
// summed over the three directions; both schedules visit in index order
// and give the same count. The default form is the kCost = false
// instantiation, with no counter.
//
// Operands: od f32[16,n] rows 0-2 d0, 3-5 centred origin, 6 activity
// bitmask a0 + 2 a1 + 4 a2 (as f32), 8 t_min, 9 accept_lo, 10-12 d1,
// 13-15 d2; soa, box, ct, cp as in trace_closest.cu.
// Output: bits i32[n], bit j set when direction j is occluded; the cost
// form also cost i32[n].

#include "intersect.cuh"

namespace {

// Scenes of at least this many clusters take the ray-major schedule. On
// the H100 (chip_smoke.py's sky-lit 1080p bounce-0 fans, each schedule
// forced at every K, PERF.md) the cluster-major one was 27%, 16% and 14%
// faster at K = 12, 32 and 45, within 1.2% at K = 63, and the ray-major
// one 15% faster at K = 128.
constexpr int kRayMajorClusters = 64;

// Lane i's three rays, their slab terms and pending bits, and accept_lo.
struct Fan {
  wrt::Ray r[3];
  wrt::SlabRay sr[3];
  bool pending[3];
  float lo;
};

__device__ __forceinline__ Fan load_fan(const float* __restrict__ od, long long n,
                                        long long i, const float* __restrict__ cp) {
  Fan f = {};
  if (i >= n) {
    return f;
  }
  const int am = static_cast<int>(od[6 * n + i]);
  const int dir_row[3] = {0, 10, 13};
  const float ox = od[3 * n + i];
  const float oy = od[4 * n + i];
  const float oz = od[5 * n + i];
  const float tmin = od[8 * n + i];
  f.lo = od[9 * n + i];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    f.r[j].dx = od[dir_row[j] * n + i];
    f.r[j].dy = od[(dir_row[j] + 1) * n + i];
    f.r[j].dz = od[(dir_row[j] + 2) * n + i];
    f.r[j].ox = ox;
    f.r[j].oy = oy;
    f.r[j].oz = oz;
    f.r[j].tmin = tmin;
    f.sr[j] = wrt::slab_ray(f.r[j]);
    // Root gate per direction: missing the scene box resolves it.
    f.pending[j] = ((am >> j) & 1) && wrt::slab_entry(cp + 8, f.sr[j]) < INFINITY;
  }
  return f;
}

// Cluster-major: sweep cluster rows (type T) for the warp's (lane,
// direction) pairs in need[0..2], the lane's primitives in registers; set
// found[j] on the lane whose direction j is occluded.
template <int T>
__device__ __forceinline__ void any3_cluster(const float* __restrict__ rows, int lane,
                                             const unsigned (&need)[3], const Fan& f,
                                             const wrt::Clip& clip, bool (&found)[3]) {
  float p[wrt::kSteps][wrt::kRows];
  wrt::load_lane_prims<T>(p, rows, lane);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    unsigned m = need[j];
    while (m != 0u) {
      const int src = __ffs(m) - 1;
      m &= m - 1u;
      const wrt::Ray b = wrt::shfl_ray(f.r[j], src);
      const float lo = __shfl_sync(wrt::kFullMask, f.lo, src);
      bool hit = false;
#pragma unroll
      for (int q = 0; q < wrt::kSteps; ++q) {
        const float ts = wrt::prim_t_regs<T>(p[q], b, clip);
        if (__any_sync(wrt::kFullMask, ts > lo && ts < wrt::kBig)) {
          hit = true;
          break;
        }
      }
      found[j] = found[j] || (hit && lane == src);
    }
  }
}

template <bool kCost>
__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_any3_kernel(const float* __restrict__ od, long long n,
                  const float* __restrict__ soa,
                  const float* __restrict__ box,
                  const int* __restrict__ ct, int k,
                  const float* __restrict__ cp, int clip_on,
                  int* __restrict__ bits_out, int* __restrict__ cost_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  Fan f = load_fan(od, n, i, cp);
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);
  bool found[3] = {false, false, false};
  int swept = 0;

  for (int c = 0; c < k; ++c) {
    if (!__any_sync(wrt::kFullMask, f.pending[0] || f.pending[1] || f.pending[2])) {
      break;
    }
    unsigned need[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const bool want =
          f.pending[j] && wrt::slab_entry(box + 6 * c, f.sr[j]) < INFINITY;
      need[j] = __ballot_sync(wrt::kFullMask, want);
      if constexpr (kCost) {
        swept += want ? 1 : 0;
      }
    }
    if ((need[0] | need[1] | need[2]) == 0u) {
      continue;
    }
    const float* rows = soa + static_cast<long long>(c) * wrt::kClusterFloats;
    wrt::by_type(ct[c], [&](auto type) {
      any3_cluster<decltype(type)::value>(rows, lane, need, f, clip, found);
    });
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      f.pending[j] = f.pending[j] && !found[j];
    }
  }
  if (i < n) {
    bits_out[i] = (found[0] ? 1 : 0) | (found[1] ? 2 : 0) | (found[2] ? 4 : 0);
    if constexpr (kCost) {
      cost_out[i] = swept * wrt::kLanes;
    }
  }
}

// Ray-major: the warp walks each pending (lane, direction) pair's clusters
// with intersect.cuh's any_raymajor (t_max 1e20, every entered cluster)
// until one occludes it.
template <bool kCost>
__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_any3_raymajor_kernel(const float* __restrict__ od, long long n,
                           const float* __restrict__ soa,
                           const float* __restrict__ box,
                           const int* __restrict__ ct, int k,
                           const float* __restrict__ cp, int clip_on,
                           int* __restrict__ bits_out, int* __restrict__ cost_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  const Fan f = load_fan(od, n, i, cp);
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);
  bool found[3] = {false, false, false};
  int cost_own = 0;

#pragma unroll
  for (int j = 0; j < 3; ++j) {
    unsigned m = __ballot_sync(wrt::kFullMask, f.pending[j]);
    while (m != 0u) {
      const int src = __ffs(m) - 1;
      m &= m - 1u;
      const wrt::Ray b = wrt::shfl_ray(f.r[j], src);
      const float lo = __shfl_sync(wrt::kFullMask, f.lo, src);
      int swept = 0;
      const bool hit = wrt::any_raymajor<kCost>(soa, box, ct, k, lane, b, lo, wrt::kBig,
                                                INFINITY, clip, &swept);
      found[j] = found[j] || (hit && lane == src);
      if (lane == src) {
        cost_own += swept;
      }
    }
  }
  if (i < n) {
    bits_out[i] = (found[0] ? 1 : 0) | (found[1] ? 2 : 0) | (found[2] ? 4 : 0);
    if constexpr (kCost) {
      cost_out[i] = cost_own * wrt::kLanes;
    }
  }
}

template <bool kCost>
int launch(const float* od, long long n, const float* soa, const float* box,
           const int* ct, int k, const float* cp, int clip_on, int* bits_out,
           int* cost_out, void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  const auto kernel = k >= kRayMajorClusters ? trace_any3_raymajor_kernel<kCost>
                                             : trace_any3_kernel<kCost>;
  kernel<<<static_cast<unsigned int>(blocks), wrt::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(od, n, soa, box, ct, k, cp, clip_on,
                                                 bits_out, cost_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wrt_trace_any3(const float* od, long long n, const float* soa,
                              const float* box, const int* ct, int k,
                              const float* cp, int clip_on, int* bits_out,
                              void* stream) {
  return launch<false>(od, n, soa, box, ct, k, cp, clip_on, bits_out, nullptr, stream);
}

extern "C" int wrt_trace_any3_cost(const float* od, long long n, const float* soa,
                                   const float* box, const int* ct, int k,
                                   const float* cp, int clip_on, int* bits_out,
                                   int* cost_out, void* stream) {
  return launch<true>(od, n, soa, box, ct, k, cp, clip_on, bits_out, cost_out, stream);
}
