// Emission/absorption march through the nitrogen density volume, one
// thread a ray.
//
// Replaces no TPU kernel: the JAX package marches with a jax.lax.fori_loop
// (webgl_raytracer_tpu/ops/volume.py, march_volume, :95), which XLA
// compiles to one device loop. Written as PyTorch tensor operations each
// of the up to 256 steps is some 60 launches (the trilinear lookup alone
// is 8 gathers and 7 lerps), in every bounce of every chunk of a frame.
// Plain version and semantics: ops/volume.py (march_plain).
//
// Bound on the H100: memory traffic, counted as the 8 grid reads a step
// (32 bytes) plus the ray's 44 bytes in and 24 out. The grid of a
// molecule's volume is a few MB and stays in L2, so in practice the loop
// is latency-bound: its steps depend on one another. The design keeps all
// of a ray's state in registers and exits as soon as the ray's march ends
// or its throughput dies; a warp runs as long as its longest ray.
//
// Every expression is the plain version's, in the same operation order
// with float literals, built -fmad=false so each product and sum rounds
// as the plain version's separate tensor ops round. The grid is read
// with plain loads, never through a texture: hardware trilinear
// filtering weighs with 8-bit fixed-point fractions. exp is expf, as
// torch.exp computes it on the card.
//
// Early exit: the plain version runs every lane through all max_steps
// steps; after a lane stops, each step adds (tp * color) * 0 = +0.0 to a
// radiance that started at +0.0 and never turns -0.0, and multiplies tp
// by 1, so the break changes no bit.
//
// Operands (device pointers, contiguous):
//   od     f32[11,n] rows: origin xyz, direction xyz, t_surface,
//                    throughput xyz, active (1/0)
//   params f32[16]   vmin xyz, vmax xyz, max_value, t_min, colour xyz,
//                    density scale, opacity, step, threshold, unused
//   grid   f32[nz,ny,nx], x fastest
// Output: out f32[6,n] rows: added radiance xyz, new throughput xyz.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 1e20f;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ops/intersect.py intersect_aabb_range for one axis: folds the axis into
// the running (near, far, ok).
__device__ __forceinline__ void slab(float o, float d, float lo, float hi, bool first,
                                     float& t_near, float& t_far, bool& ok) {
  const bool parallel = fabsf(d) < 1e-8f;
  const float inv = 1.0f / (parallel ? 1.0f : d);
  const float t1 = (lo - o) * inv;
  const float t2 = (hi - o) * inv;
  const float near = parallel ? -kBig : fminf(t1, t2);
  const float far = parallel ? kBig : fmaxf(t1, t2);
  const bool axis_ok = !parallel || (o >= lo && o <= hi);
  if (first) {
    t_near = near;
    t_far = far;
    ok = axis_ok;
  } else {
    t_near = fmaxf(t_near, near);
    t_far = fminf(t_far, far);
    ok = ok && axis_ok;
  }
}

struct Axis {
  int i0, i1;
  float f;
};

// One axis of ops/volume.py sample_volume_trilinear.
__device__ __forceinline__ Axis texel(float p, float lo, float inv_size, int n) {
  const float uvw = clampf((p - lo) * inv_size, 0.0f, 1.0f);
  const float xyz = uvw * static_cast<float>(n) - 0.5f;
  const float fl = floorf(xyz);
  Axis a;
  a.i0 = min(max(static_cast<int>(fl), 0), n - 1);
  a.i1 = min(max(a.i0 + 1, 0), n - 1);
  a.f = clampf(xyz - fl, 0.0f, 1.0f);
  return a;
}

__global__ void __launch_bounds__(kThreads)
volume_march_kernel(const float* __restrict__ od, long long n,
                    const float* __restrict__ params,
                    const float* __restrict__ grid, int nx, int ny, int nz,
                    int max_steps, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = od[i], oy = od[n + i], oz = od[2 * n + i];
  const float dx = od[3 * n + i], dy = od[4 * n + i], dz = od[5 * n + i];
  const float t_surface = od[6 * n + i];
  const float tp_in[3] = {od[7 * n + i], od[8 * n + i], od[9 * n + i]};
  const bool active = od[10 * n + i] > 0.0f;

  const float vmin[3] = {params[0], params[1], params[2]};
  const float vmax[3] = {params[3], params[4], params[5]};
  const float max_value = params[6], t_min = params[7];
  const float color[3] = {params[8], params[9], params[10]};
  const float density_scale = params[11], opacity = params[12];
  const float step = params[13], threshold = params[14];

  float t_near, t_far;
  bool ok;
  slab(ox, dx, vmin[0], vmax[0], true, t_near, t_far, ok);
  slab(oy, dy, vmin[1], vmax[1], false, t_near, t_far, ok);
  slab(oz, dz, vmin[2], vmax[2], false, t_near, t_far, ok);
  const bool hit_box = ok && (t_far >= fmaxf(t_near, 0.0f));
  const float t_enter = fmaxf(t_near, t_min);
  const float t_exit = fminf(t_far, t_surface);
  const bool run = active && hit_box && (t_exit > t_enter) && (step > 0.0f);

  float rad[3] = {0.0f, 0.0f, 0.0f};
  float tp[3] = {tp_in[0], tp_in[1], tp_in[2]};
  if (run) {
    const float inv_max = 1.0f / fmaxf(max_value, 1e-6f);
    const float inv_size[3] = {1.0f / fmaxf(vmax[0] - vmin[0], 1e-12f),
                               1.0f / fmaxf(vmax[1] - vmin[1], 1e-12f),
                               1.0f / fmaxf(vmax[2] - vmin[2], 1e-12f)};
    const long long nxy = static_cast<long long>(nx) * ny;
    for (int s = 0; s < max_steps; ++s) {
      const float t_cur = t_enter + step * static_cast<float>(s);
      const bool inside = t_cur <= t_exit;
      const float dt = fminf(step, t_exit - t_cur);
      const Axis ax = texel(ox + dx * t_cur, vmin[0], inv_size[0], nx);
      const Axis ay = texel(oy + dy * t_cur, vmin[1], inv_size[1], ny);
      const Axis az = texel(oz + dz * t_cur, vmin[2], inv_size[2], nz);
      const long long z0 = az.i0 * nxy, z1 = az.i1 * nxy;
      const long long y0 = static_cast<long long>(ay.i0) * nx;
      const long long y1 = static_cast<long long>(ay.i1) * nx;
      const float c000 = __ldg(grid + z0 + y0 + ax.i0);
      const float c100 = __ldg(grid + z0 + y0 + ax.i1);
      const float c010 = __ldg(grid + z0 + y1 + ax.i0);
      const float c110 = __ldg(grid + z0 + y1 + ax.i1);
      const float c001 = __ldg(grid + z1 + y0 + ax.i0);
      const float c101 = __ldg(grid + z1 + y0 + ax.i1);
      const float c011 = __ldg(grid + z1 + y1 + ax.i0);
      const float c111 = __ldg(grid + z1 + y1 + ax.i1);
      const float c00 = c000 * (1.0f - ax.f) + c100 * ax.f;
      const float c10 = c010 * (1.0f - ax.f) + c110 * ax.f;
      const float c01 = c001 * (1.0f - ax.f) + c101 * ax.f;
      const float c11 = c011 * (1.0f - ax.f) + c111 * ax.f;
      const float c0 = c00 * (1.0f - ay.f) + c10 * ay.f;
      const float c1 = c01 * (1.0f - ay.f) + c11 * ay.f;
      float density = (c0 * (1.0f - az.f) + c1 * az.f) * inv_max;
      density = fmaxf(density - threshold, 0.0f);
      float alpha = 1.0f - expf(-density * density_scale * dt);
      alpha = clampf(alpha * opacity, 0.0f, 1.0f);
      alpha = (inside && density > 0.0f) ? alpha : 0.0f;
      for (int c = 0; c < 3; ++c) {
        rad[c] = rad[c] + tp[c] * color[c] * alpha;
        tp[c] = tp[c] * (1.0f - alpha);
      }
      const bool dead = fmaxf(tp[0], fmaxf(tp[1], tp[2])) < 1e-3f;
      if (inside && dead) tp[0] = tp[1] = tp[2] = 0.0f;
      if (dead || !(t_cur + step <= t_exit)) break;
    }
  }
  for (int c = 0; c < 3; ++c) {
    out[c * n + i] = rad[c];
    out[(3 + c) * n + i] = run ? tp[c] : tp_in[c];
  }
}

}  // namespace

extern "C" int wrt_volume_march(const float* od, long long n, const float* params,
                                const float* grid, int nx, int ny, int nz, int max_steps,
                                float* out, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  volume_march_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      od, n, params, grid, nx, ny, nz, max_steps, out);
  return static_cast<int>(cudaGetLastError());
}
