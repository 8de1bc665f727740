// Occlusion of one ray per lane by a per-ray front-to-back walk: the
// routing target of divergent (env-NEE) occlusion batches on
// cluster-rich scenes.
//
// Replaces the TPU kernel `_make_any_kernel_perray` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (_perray_walk, trace_any_perray). Its bits equal
// trace_any.cu's: both OR the same predicate over the clusters entered
// before t_max.
//
// Bound on the H100: FP32 intersector arithmetic; rows are read from
// global memory (L2), as in trace_closest_perray.cu.
//
// Design: one thread per ray (intersect.cuh walk_front_to_back) with the
// fixed cap t_max; the walk ends at the first primitive with
// accept_lo < ts < t_max.
//
// Operands: od f32[10,n] as trace_any.cu; gbox as trace_closest_perray.cu.
// Output: found i32[n] (1 occluded, 0 not or inactive).

#include "intersect.cuh"

namespace {

__global__ void __launch_bounds__(wrt::kThreads)
trace_any_perray_kernel(const float* __restrict__ od, long long n,
                        const float* __restrict__ soa,
                        const float* __restrict__ box,
                        const float* __restrict__ gbox, int ng,
                        const int* __restrict__ ct, int k,
                        const float* __restrict__ cp, int clip_on,
                        int* __restrict__ found_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) {
    return;
  }
  wrt::Ray r;
  r.dx = od[i];
  r.dy = od[n + i];
  r.dz = od[2 * n + i];
  r.ox = od[3 * n + i];
  r.oy = od[4 * n + i];
  r.oz = od[5 * n + i];
  r.tmin = od[6 * n + i];
  const float hi = od[8 * n + i];
  const float lo = od[9 * n + i];
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);

  bool found = false;
  if (od[7 * n + i] > 0.0f) {
    wrt::walk_front_to_back(
        box, gbox, ng, k, r, [&] { return hi; },
        [&](int c) {
          const float* rows = soa + static_cast<long long>(c) * wrt::kClusterFloats;
          const int ctype = ct[c];
          for (int l = 0; l < wrt::kLanes; ++l) {
            const float ts = wrt::prim_t(rows, l, ctype, r, clip);
            if (ts > lo && ts < hi) {
              found = true;
              return true;
            }
          }
          return false;
        });
  }
  found_out[i] = found ? 1 : 0;
}

}  // namespace

extern "C" int wrt_trace_any_perray(const float* od, long long n,
                                    const float* soa, const float* box,
                                    const float* gbox, int ng, const int* ct,
                                    int k, const float* cp, int clip_on,
                                    int* found_out, void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  trace_any_perray_kernel<<<static_cast<unsigned int>(blocks), wrt::kThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(
      od, n, soa, box, gbox, ng, ct, k, cp, clip_on, found_out);
  return static_cast<int>(cudaGetLastError());
}
