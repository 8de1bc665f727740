// Occlusion of one ray per lane with t in (accept_lo, t_max): the env-NEE
// shadow query and bounded any-hit queries.
//
// Replaces the TPU kernel `_make_any_kernel` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (any_plain, trace_any).
//
// Bound on the H100: FP32 intersector arithmetic (the cluster table stays
// in L2 and shared memory; the ray operand is read once).
//
// Design: trace_any3.cu with one direction and a t_max. One thread per
// lane; a ray that misses the root AABB (or is inactive) is unoccluded.
// For each cluster in index order, a still-unresolved ray whose entry into
// the cluster's AABB is before t_max sweeps its 128 primitives with the
// predicate accept_lo < ts < t_max and stops at the first hit. The block
// stages a cluster's rows in shared memory when any of its threads needs
// them and stops once every ray is resolved.
//
// Operands: od f32[10,n] rows 0-2 d, 3-5 centred origin, 6 t_min,
// 7 activity (1/0), 8 t_max, 9 accept_lo; soa, box, ct, cp as in
// trace_closest.cu. Output: found i32[n] (1 occluded, 0 not or inactive).

#include "intersect.cuh"

namespace {

__global__ void __launch_bounds__(wrt::kThreads)
trace_any_kernel(const float* __restrict__ od, long long n,
                 const float* __restrict__ soa,
                 const float* __restrict__ box,
                 const int* __restrict__ ct, int k,
                 const float* __restrict__ cp, int clip_on,
                 int* __restrict__ found_out) {
  __shared__ float rows[wrt::kClusterFloats];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = i < n;

  wrt::Ray r{};
  bool pending = false;
  float hi = 0.0f;
  float lo = 0.0f;
  if (in_range) {
    r.dx = od[i];
    r.dy = od[n + i];
    r.dz = od[2 * n + i];
    r.ox = od[3 * n + i];
    r.oy = od[4 * n + i];
    r.oz = od[5 * n + i];
    r.tmin = od[6 * n + i];
    hi = od[8 * n + i];
    lo = od[9 * n + i];
    // Root gate: missing the scene box resolves the ray as unoccluded.
    pending = od[7 * n + i] > 0.0f && wrt::slab_entry(cp + 8, r) < INFINITY;
  }
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);
  bool found = false;

  for (int c = 0; c < k; ++c) {
    if (!__syncthreads_or(pending)) {
      break;
    }
    const bool need = pending && wrt::slab_entry(box + 6 * c, r) < hi;
    if (!__syncthreads_or(need)) {
      continue;
    }
    wrt::stage_cluster(rows, soa, c);
    __syncthreads();
    if (need) {
      const int ctype = ct[c];
      for (int l = 0; l < wrt::kLanes; ++l) {
        const float ts = wrt::prim_t(rows, l, ctype, r, clip);
        if (ts > lo && ts < hi) {
          found = true;
          pending = false;
          break;
        }
      }
    }
    __syncthreads();
  }
  if (in_range) {
    found_out[i] = found ? 1 : 0;
  }
}

}  // namespace

extern "C" int wrt_trace_any(const float* od, long long n, const float* soa,
                             const float* box, const int* ct, int k,
                             const float* cp, int clip_on, int* found_out,
                             void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  trace_any_kernel<<<static_cast<unsigned int>(blocks), wrt::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      od, n, soa, box, ct, k, cp, clip_on, found_out);
  return static_cast<int>(cudaGetLastError());
}
