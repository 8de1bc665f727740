// Closest hit per ray over the cluster SoA by a per-ray front-to-back
// walk: the routing target of secondary (divergent) closest traces on
// cluster-rich scenes.
//
// Replaces the TPU kernel `_make_closest_kernel_perray` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (_perray_walk, trace_closest with perray=True). Its (t,
// row) equal trace_closest.cu's.
//
// Bound on the H100: FP32 intersector arithmetic. A secondary ray's own
// chain of clusters is short, while a warp of divergent rays touches the
// union of all their chains; so each ray walks its own chain and the
// cluster rows are read from global memory, where they stay in the 50 MB
// L2 (786 KB at K = 128, 12 MB at K = 1976). The TPU kernel's bf16
// mantissa-split one-hot gather is a TPU workaround for a per-ray row
// load: here it is a plain load. What loses time is the schedule: one
// thread per ray, sweeping 128 primitives in series while its warp's other
// lanes sit in other clusters, holds the warp for its longest chain, and
// each row load of such a warp touches 32 sectors for 4 bytes of each.
//
// Design: no shared memory and no per-thread arrays. A warp owns 32 rays
// and walks them one at a time with all its lanes (intersect.cuh
// perray_walk): the active rays are taken from a __ballot_sync in lane
// order, the ray is broadcast by __shfl_sync and its reciprocal direction
// computed once. Its groups of 128 clusters are popped by its entry into
// their boxes; inside a group each lane tests 4 cluster boxes, and two
// __reduce_min_sync pop the nearest entry (the lowest cluster among equal
// entries) while it lies before the ray's best t. The warp sweeps a popped
// cluster with each lane testing 4 primitives loaded into registers by
// coalesced 128-byte row loads (closest_sweep_perray); two more
// __reduce_min_sync take the cluster's lexicographic (t, row) minimum,
// which updates the ray's best lexicographically, so the winner is the one
// the index-order walk finds. Lanes past n and inactive rays take part in
// every collective and write only their own miss.
//
// The cost form (wrt_trace_closest_perray_cost, kCost = true) also
// writes each ray's count: 128 x the clusters its walk popped (visit
// counts them on every lane; the ray's own lane keeps the count). The
// default form is the kCost = false instantiation, with no counter.
//
// Operands: od f32[8,n] as trace_closest.cu; soa, box, ct, cp as there;
// gbox f32[ng,6] group AABBs (clusters [g*128, g*128+128)).
// Outputs: t f32[n] (1e20 on a miss), row i32[n] (-1 on a miss); the cost
// form also cost i32[n] (0 for an inactive ray).

#include "intersect.cuh"

namespace {

template <bool kCost>
__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_closest_perray_kernel(const float* __restrict__ od, long long n,
                            const float* __restrict__ soa,
                            const float* __restrict__ box,
                            const float* __restrict__ gbox, int ng,
                            const int* __restrict__ ct, int k,
                            const float* __restrict__ cp, int clip_on,
                            float* __restrict__ t_out, int* __restrict__ row_out,
                            int* __restrict__ cost_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  wrt::Ray r;
  const bool act = wrt::load_ray(od, n, i, r);
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);

  float t_own = wrt::kBig;
  int row_own = -1;
  int cost_own = 0;
  unsigned todo = __ballot_sync(wrt::kFullMask, act);
  while (todo != 0u) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1u;
    const wrt::Ray b = wrt::shfl_ray(r, src);
    float best = wrt::kBig;
    int best_row = -1;
    int swept = 0;
    wrt::perray_walk(
        box, gbox, ng, k, wrt::slab_ray(b), lane, [&] { return best; },
        [&](int c) {
          if constexpr (kCost) {
            ++swept;
          }
          const float* rows = soa + static_cast<long long>(c) * wrt::kClusterFloats;
          wrt::by_type(ct[c], [&](auto type) {
            wrt::closest_sweep_perray<decltype(type)::value>(rows, c, lane, b, clip, best,
                                                             best_row);
          });
          return false;
        });
    if (lane == src) {
      t_own = best;
      row_own = best < wrt::kBig ? best_row : -1;
      cost_own = swept;
    }
  }
  if (i < n) {
    t_out[i] = t_own;
    row_out[i] = row_own;
    if constexpr (kCost) {
      cost_out[i] = cost_own * wrt::kLanes;
    }
  }
}

template <bool kCost>
int launch(const float* od, long long n, const float* soa, const float* box,
           const float* gbox, int ng, const int* ct, int k, const float* cp,
           int clip_on, float* t_out, int* row_out, int* cost_out, void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  trace_closest_perray_kernel<kCost><<<static_cast<unsigned int>(blocks), wrt::kThreads,
                                       0, static_cast<cudaStream_t>(stream)>>>(
      od, n, soa, box, gbox, ng, ct, k, cp, clip_on, t_out, row_out, cost_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wrt_trace_closest_perray(const float* od, long long n,
                                        const float* soa, const float* box,
                                        const float* gbox, int ng, const int* ct,
                                        int k, const float* cp, int clip_on,
                                        float* t_out, int* row_out, void* stream) {
  return launch<false>(od, n, soa, box, gbox, ng, ct, k, cp, clip_on, t_out, row_out,
                       nullptr, stream);
}

extern "C" int wrt_trace_closest_perray_cost(const float* od, long long n,
                                             const float* soa, const float* box,
                                             const float* gbox, int ng, const int* ct,
                                             int k, const float* cp, int clip_on,
                                             float* t_out, int* row_out, int* cost_out,
                                             void* stream) {
  return launch<true>(od, n, soa, box, gbox, ng, ct, k, cp, clip_on, t_out, row_out,
                      cost_out, stream);
}
