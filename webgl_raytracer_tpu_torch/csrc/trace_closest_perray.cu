// Closest hit per ray over the cluster SoA by a per-ray front-to-back
// walk: the routing target of secondary (divergent) closest traces on
// cluster-rich scenes.
//
// Replaces the TPU kernel `_make_closest_kernel_perray` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (_perray_walk, trace_closest_perray). Its (t, row) equal
// trace_closest.cu's.
//
// Bound on the H100: FP32 intersector arithmetic. A secondary ray's own
// chain of clusters is short, while a block of divergent rays touches the
// union of all their chains; so each thread walks its own chain and reads
// the cluster rows from global memory, where they stay in the 50 MB L2
// (786 KB at K = 128, 12 MB at K = 1976), instead of staging them in
// shared memory for the whole block as trace_closest.cu does. The TPU
// kernel's bf16 mantissa-split one-hot gather is a TPU workaround for a
// per-ray row load: here it is a plain load.
//
// Design: one thread per ray (intersect.cuh walk_front_to_back): groups of
// 128 clusters by group-AABB entry, inside a group the clusters by entry,
// each popped while its entry is before the ray's best t, with the
// lexicographic (t, row) update, so the winner is the one the index-order
// walk finds.
//
// Operands: od f32[8,n] as trace_closest.cu; soa, box, ct, cp as there;
// gbox f32[ng,6] group AABBs (clusters [g*128, g*128+128)).
// Outputs: t f32[n] (1e20 on a miss), row i32[n] (-1 on a miss).

#include "intersect.cuh"

namespace {

__global__ void __launch_bounds__(wrt::kThreads)
trace_closest_perray_kernel(const float* __restrict__ od, long long n,
                            const float* __restrict__ soa,
                            const float* __restrict__ box,
                            const float* __restrict__ gbox, int ng,
                            const int* __restrict__ ct, int k,
                            const float* __restrict__ cp, int clip_on,
                            float* __restrict__ t_out, int* __restrict__ row_out) {
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
  const wrt::Clip clip = wrt::load_clip(cp, clip_on);

  float best = wrt::kBig;
  int best_row = -1;
  if (od[7 * n + i] > 0.0f) {
    wrt::walk_front_to_back(
        box, gbox, ng, k, r, [&] { return best; },
        [&](int c) {
          const float* rows = soa + static_cast<long long>(c) * wrt::kClusterFloats;
          const int ctype = ct[c];
          for (int l = 0; l < wrt::kLanes; ++l) {
            const float ts = wrt::prim_t(rows, l, ctype, r, clip);
            const int row = c * wrt::kLanes + l;
            if (ts > 0.0f && (ts < best || (ts == best && row < best_row))) {
              best = ts;
              best_row = row;
            }
          }
          return false;
        });
  }
  t_out[i] = best;
  row_out[i] = best < wrt::kBig ? best_row : -1;
}

}  // namespace

extern "C" int wrt_trace_closest_perray(const float* od, long long n,
                                        const float* soa, const float* box,
                                        const float* gbox, int ng, const int* ct,
                                        int k, const float* cp, int clip_on,
                                        float* t_out, int* row_out, void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  trace_closest_perray_kernel<<<static_cast<unsigned int>(blocks), wrt::kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
      od, n, soa, box, gbox, ng, ct, k, cp, clip_on, t_out, row_out);
  return static_cast<int>(cudaGetLastError());
}
