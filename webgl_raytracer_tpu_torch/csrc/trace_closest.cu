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
// Design: no block barriers and no shared memory; the walk is
// intersect.cuh closest_walk, which trace_closest_attrs.cu shares. A warp
// owns 32 rays and walks the clusters in index order: __ballot_sync
// gathers which of its rays enter a cluster's AABB before their best t (a
// ray's reciprocal direction computed once, not per box), so a cluster no
// lane needs costs one slab test; a needed cluster's primitives are loaded
// into registers once, 4 a lane by coalesced 128-byte row loads, and swept
// for one needing ray at a time, two __reduce_min_sync taking the warp's
// lexicographic (t, row) minimum. A ray so takes the minimum closest_plain
// takes: t and row are identical to it. The primitive tests are built
// -fmad=false; the sphere test returns early on a miss, so a step whose 32
// primitives all miss skips the square root.
//
// The cost form (wrt_trace_closest_cost, kCost = true) also writes each
// ray's count: 128 x the clusters whose entry lay before its best t when
// the walk reached them (its own bit of each need mask; ops/trace.py,
// "Counts"). The default form is the kCost = false instantiation, which
// compiles no counter.
//
// Operands (all device pointers, contiguous):
//   od   f32[8,n]  rows: d xyz, centred o xyz, t_min, active (1/0)
//   soa  f32[k,12,128] centred cluster rows
//   box  f32[k,6]  centred cluster AABBs (lo xyz, hi xyz)
//   ct   i32[k]    cluster type, -1 for a mixed cluster
//   cp   f32[16]   clip plane (0-4), root AABB (8-13)
// Outputs: t f32[n] (1e20 on a miss), row i32[n] (-1 on a miss); the cost
// form also cost i32[n] (0 for an inactive ray or one missing the root).

#include "intersect.cuh"

namespace {

template <bool kCost>
__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_closest_kernel(const float* __restrict__ od, long long n,
                     const float* __restrict__ soa,
                     const float* __restrict__ box,
                     const int* __restrict__ ct, int k,
                     const float* __restrict__ cp, int clip_on,
                     float* __restrict__ t_out, int* __restrict__ row_out,
                     int* __restrict__ cost_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  int best_row;
  int swept = 0;
  const float best = wrt::closest_walk<kCost>(od, n, i, lane, soa, box, ct, k, cp,
                                              clip_on, best_row, &swept);
  if (i < n) {
    t_out[i] = best;
    row_out[i] = best_row;
    if constexpr (kCost) {
      cost_out[i] = swept * wrt::kLanes;
    }
  }
}

template <bool kCost>
int launch(const float* od, long long n, const float* soa, const float* box,
           const int* ct, int k, const float* cp, int clip_on, float* t_out,
           int* row_out, int* cost_out, void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  trace_closest_kernel<kCost><<<static_cast<unsigned int>(blocks), wrt::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      od, n, soa, box, ct, k, cp, clip_on, t_out, row_out, cost_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wrt_trace_closest(const float* od, long long n, const float* soa,
                                 const float* box, const int* ct, int k,
                                 const float* cp, int clip_on, float* t_out,
                                 int* row_out, void* stream) {
  return launch<false>(od, n, soa, box, ct, k, cp, clip_on, t_out, row_out, nullptr,
                       stream);
}

extern "C" int wrt_trace_closest_cost(const float* od, long long n, const float* soa,
                                      const float* box, const int* ct, int k,
                                      const float* cp, int clip_on, float* t_out,
                                      int* row_out, int* cost_out, void* stream) {
  return launch<true>(od, n, soa, box, ct, k, cp, clip_on, t_out, row_out, cost_out,
                      stream);
}
