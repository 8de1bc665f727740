// Closest hit per ray over the cluster SoA (spheres, capped cylinders,
// triangles with clip rejection).
//
// Replaces the TPU kernel `_make_closest_kernel` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (closest_plain, trace_closest).
//
// Design: one thread per ray, kThreads rays per block, walking the clusters
// in index order with block-staged rows (6 KB of shared memory per
// cluster): wrt::closest_block_walk in intersect.cuh, shared with
// trace_closest_attrs.cu.
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

__global__ void __launch_bounds__(wrt::kThreads)
trace_closest_kernel(const float* __restrict__ od, long long n,
                     const float* __restrict__ soa,
                     const float* __restrict__ box,
                     const int* __restrict__ ct, int k,
                     const float* __restrict__ cp, int clip_on,
                     float* __restrict__ t_out, int* __restrict__ row_out) {
  __shared__ float rows[wrt::kClusterFloats];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int best_row;
  const float best = wrt::closest_block_walk(rows, od, n, i, soa, box, ct, k, cp,
                                             clip_on, best_row);
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
