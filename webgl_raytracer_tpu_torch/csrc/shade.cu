// The bounce step's shading between its traces, as two kernels around the
// occlusion queries (render/integrator.py _make_bounce_step; per-lane code
// and its numerics: shade.cuh):
//   shade_surface  the miss radiance (ambient and the environment with its
//                  MIS weight), the surface of every primitive type, glass
//                  and translucent transmission, the three cone-light
//                  samples and the env NEE direction; it writes the shadow
//                  fan's and env NEE's operands and the lane's state so far;
//   shade_scatter  after the queries: direct light with MIS, the rim, env
//                  NEE's contribution, the BRDF lobe sample, the throughput
//                  clamp and Russian roulette; it finishes the state.
//
// Replaces no TPU kernel: the JAX package writes the bounce as jnp code
// that XLA fuses. Written as PyTorch tensor operations a bounce is some
// 2,000 launches of elementwise kernels over the whole buffer, each
// reading and writing a few hundred KB: the frame was bound by their
// count, not by bytes (PERF.md, section 5).
//
// Bound on the H100: instruction issue on the live lanes and the launch.
// A lane reads some 140 bytes and writes some 80 in each kernel, and does
// a few thousand FP32 operations (the env CDF bisections, the cone and
// lobe samples, sin, cos, pow, acos, atan2). The design: one thread a
// lane, everything of a lane in registers, per-frame values read from one
// small params vector; a lane dead on entry (the binned buffer's tail)
// writes its masks and returns, so whole warps of dead lanes cost nothing.
// Configuration (material mode, env, lights, types, rim, shadows, row
// source) is a warp-uniform runtime argument.
//
// Operands (device pointers; rows contiguous):
//   seed i64[n]; origin, direction, throughput, last_pdf each f32[n]
//       (step 1) or one f32 for every lane (step 0); radiance 3 x f32[n],
//       updated in place; alive u8[n]
//   the closest hits: t f32[n], prim_type, prim_local, prim_slot i32[n],
//       extra f32[n, 3]
//   the rows: pa, pb, pc, colour, triangle normals and flags, each a
//       pointer and a stride in floats, indexed by the slot (by the
//       clamped local index for the triangle tables) or by the lane (the
//       attrs kernel's rows)
//   the environment: radiance f32[h, w, 3], marginal f32[h + 1],
//       conditional f32[h, w + 1]; null without one
//   params f32[44] (ops/shade.py)
// Out: seed i64[n], state f32[10, n], alive u8[n], work f32[22, n] and
// lanes u8[5, n] (shade.cuh's rows); shade_scatter updates seed, state,
// alive and radiance in place.

#include <cuda_runtime.h>

#include "shade.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) shade_surface_kernel(shade::SurfaceArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  shade::shade_surface_lane(a, i);
}

__global__ void __launch_bounds__(kThreads) shade_scatter_kernel(shade::ScatterArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  shade::shade_scatter_lane(a, i);
}

unsigned int blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int wrt_shade_surface(
    long long n, int bounce, int mode, int bits, const long long* seed, const float* ox,
    int ox_step, const float* oy, int oy_step, const float* oz, int oz_step, const float* dx,
    int dx_step, const float* dy, int dy_step, const float* dz, int dz_step, const float* tx,
    int tx_step, const float* ty, int ty_step, const float* tz, int tz_step,
    const float* last_pdf, int last_pdf_step, float* rx, float* ry, float* rz,
    const unsigned char* alive, const float* t, const int* ptype, const int* plocal,
    const int* pslot, const float* extra, const float* pa, const float* pb, const float* pc,
    int row_stride, const float* color, int color_stride, const float* tri_normals,
    int tri_normals_stride, const float* tri_flags, int tri_flags_stride, int tri_rows,
    const float* env_radiance, const float* env_marginal, const float* env_conditional,
    int env_w, int env_h, int trips_v, int trips_u, const float* params,
    long long* seed_out, float* state_out, unsigned char* alive_out, float* work,
    unsigned char* lanes, void* stream) {
  using shade::Col;
  const shade::SurfaceArgs a{
      n, bounce, mode, bits, seed,
      {Col{ox, ox_step}, Col{oy, oy_step}, Col{oz, oz_step}},
      {Col{dx, dx_step}, Col{dy, dy_step}, Col{dz, dz_step}},
      {Col{tx, tx_step}, Col{ty, ty_step}, Col{tz, tz_step}},
      Col{last_pdf, last_pdf_step}, {rx, ry, rz}, alive, t, ptype, plocal, pslot, extra,
      pa, pb, pc, row_stride, color, color_stride, tri_normals, tri_normals_stride,
      tri_flags, tri_flags_stride, tri_rows,
      shade::Env{env_radiance, env_marginal, env_conditional, env_w, env_h, trips_v, trips_u},
      params, seed_out, state_out, alive_out, work, lanes};
  shade_surface_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wrt_shade_scatter(
    long long n, int bounce, int mode, int bits, const float* work,
    const unsigned char* lanes, const unsigned char* occ0, const unsigned char* occ1,
    const unsigned char* occ2, const unsigned char* env_occ, float* rx, float* ry,
    float* rz, const float* env_radiance, const float* env_marginal,
    const float* env_conditional, int env_w, int env_h, int trips_v, int trips_u,
    const float* params, long long* seed, float* state, unsigned char* alive,
    void* stream) {
  const shade::ScatterArgs a{
      n, bounce, mode, bits, work, lanes, {occ0, occ1, occ2}, env_occ, {rx, ry, rz},
      shade::Env{env_radiance, env_marginal, env_conditional, env_w, env_h, trips_v, trips_u},
      params, seed, state, alive};
  shade_scatter_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
