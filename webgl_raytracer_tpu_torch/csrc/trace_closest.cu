// Closest hit per ray over the cluster SoA (spheres, capped cylinders,
// triangles with clip rejection).
//
// Replaces the TPU kernel `_make_closest_kernel` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (closest_plain, trace_closest).
//
// Bound on the H100: FP32 operations. The cluster table (72 KB at the
// 1000-sphere scene's K = 12, 768 KB at 10k spheres, K = 128) stays in
// L1/L2, and a ray needs a slab test per cluster and 128 primitive tests
// per cluster it enters before its best t: 0.021 ms of the card's 67
// TFLOP/s for the 1080p primary rays of the 1000-sphere scene, where 95%
// of the rays hit nothing and most warps need no cluster at all. What
// loses time is the schedule, not the arithmetic: a block-staged walk
// (one thread sweeping 128 primitives for its own ray while the rest of
// its warp waits, two block barriers per cluster) runs 128 serial tests
// per warp and cluster even where one lane of 32 needs the cluster.
//
// Design: no block barriers and no shared memory. A warp owns 32 rays
// and walks the clusters in index order. Each lane asks whether its ray
// enters the cluster's AABB before its best t (the ray's reciprocal
// direction computed once, not per box); __ballot_sync gathers the warp's
// need mask, and a cluster no lane needs costs one slab test. Where any
// bit is set, the lanes load primitives lane, lane+32, lane+64, lane+96
// of the cluster into registers once (coalesced 128-byte row loads
// through the read-only path) and sweep them for one needing ray at a
// time, its ray and best t broadcast by __shfl_sync: each lane keeps the
// strict-< minimum over its four primitives in increasing row, two
// __reduce_min_sync take the warp's lexicographic (t, row) minimum (the
// lowest row among equal t), and the ray's own lane keeps it where it is
// below its best t. So a ray takes the lexicographic minimum of (t, row)
// over the primitives of each cluster it needs, in index order, which is
// what closest_plain takes: t and row are identical to it (and to the
// block walk of trace_closest_attrs.cu). The primitive tests are
// intersect.cuh's, built -fmad=false; the sphere test returns early on a
// miss, so a step whose 32 primitives all miss skips the square root.
//
// Operands (all device pointers, contiguous):
//   od   f32[8,n]  rows: d xyz, centred o xyz, t_min, active (1/0)
//   soa  f32[k,12,128] centred cluster rows
//   box  f32[k,6]  centred cluster AABBs (lo xyz, hi xyz)
//   ct   i32[k]    cluster type, -1 for a mixed cluster
//   cp   f32[16]   clip plane (0-4), root AABB (8-13)
// Outputs: t f32[n] (1e20 on a miss), row i32[n] (-1 on a miss).

#include "intersect.cuh"

namespace {

// Sweep cluster c (type T, rows: its SoA block) for the warp's rays in
// `need`; each such ray keeps the lexicographic (t, row) minimum over the
// primitives with 0 < t < best where one exists.
template <int T>
__device__ __forceinline__ void closest_cluster(const float* __restrict__ rows, int c,
                                                int lane, unsigned need,
                                                const wrt::Ray& r, const wrt::Clip& clip,
                                                float& best, int& best_row) {
  float p[wrt::kSteps][wrt::kRows];
  wrt::load_lane_prims<T>(p, rows, lane);
  while (need != 0u) {
    const int src = __ffs(need) - 1;
    need &= need - 1u;
    const wrt::Ray b = wrt::shfl_ray(r, src);
    const float cap = __shfl_sync(wrt::kFullMask, best, src);
    float t = INFINITY;
    int j = wrt::kLanes;
#pragma unroll
    for (int q = 0; q < wrt::kSteps; ++q) {
      const float ts = wrt::prim_t_regs<T>(p[q], b, clip);
      if (ts > 0.0f && ts < cap && ts < t) {
        t = ts;
        j = lane + wrt::kWarp * q;
      }
    }
    // The warp's lexicographic (t, row) minimum: t > 0, so its bit
    // pattern orders as its value does (INFINITY: no candidate).
    unsigned tw, jw;
    wrt::warp_min_pair(__float_as_uint(t), static_cast<unsigned>(j), tw, jw);
    if (lane == src && __uint_as_float(tw) < best) {
      best = __uint_as_float(tw);
      best_row = c * wrt::kLanes + static_cast<int>(jw);
    }
  }
}

__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_closest_kernel(const float* __restrict__ od, long long n,
                     const float* __restrict__ soa,
                     const float* __restrict__ box,
                     const int* __restrict__ ct, int k,
                     const float* __restrict__ cp, int clip_on,
                     float* __restrict__ t_out, int* __restrict__ row_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  wrt::Ray r{};
  bool act = false;
  if (i < n) {
    r.dx = od[i];
    r.dy = od[n + i];
    r.dz = od[2 * n + i];
    r.ox = od[3 * n + i];
    r.oy = od[4 * n + i];
    r.oz = od[5 * n + i];
    r.tmin = od[6 * n + i];
    act = od[7 * n + i] > 0.0f;
  }
  const wrt::SlabRay sr = wrt::slab_ray(r);
  // Root gate: missing the scene box implies missing every cluster box.
  act = act && wrt::slab_entry(cp + 8, sr) < INFINITY;
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);

  float best = wrt::kBig;
  int best_row = -1;
  if (__any_sync(wrt::kFullMask, act)) {
    for (int c = 0; c < k; ++c) {
      const unsigned need = __ballot_sync(
          wrt::kFullMask, act && wrt::slab_entry(box + 6 * c, sr) < best);
      if (need == 0u) {
        continue;
      }
      const float* rows = soa + static_cast<long long>(c) * wrt::kClusterFloats;
      switch (ct[c]) {
        case wrt::kSphere:
          closest_cluster<wrt::kSphere>(rows, c, lane, need, r, clip, best, best_row);
          break;
        case wrt::kCylinder:
          closest_cluster<wrt::kCylinder>(rows, c, lane, need, r, clip, best, best_row);
          break;
        case wrt::kTriangle:
          closest_cluster<wrt::kTriangle>(rows, c, lane, need, r, clip, best, best_row);
          break;
        case wrt::kMixed:
          closest_cluster<wrt::kMixed>(rows, c, lane, need, r, clip, best, best_row);
          break;
        default:
          break;
      }
    }
  }
  if (!(best < wrt::kBig)) {
    best_row = -1;
  }
  if (i < n) {
    t_out[i] = best;
    row_out[i] = best_row;
  }
}

}  // namespace

extern "C" int wrt_trace_closest(const float* od, long long n, const float* soa,
                                 const float* box, const int* ct, int k,
                                 const float* cp, int clip_on, float* t_out,
                                 int* row_out, void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  trace_closest_kernel<<<static_cast<unsigned int>(blocks), wrt::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      od, n, soa, box, ct, k, cp, clip_on, t_out, row_out);
  return static_cast<int>(cudaGetLastError());
}
