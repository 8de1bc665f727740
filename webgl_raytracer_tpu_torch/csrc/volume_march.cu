// Emission/absorption march through the nitrogen density volume.
//
// Replaces no TPU kernel: the JAX package marches with a jax.lax.fori_loop
// (webgl_raytracer_tpu/ops/volume.py, march_volume, :95), which XLA
// compiles to one device loop. Written as PyTorch tensor operations each
// of the up to 256 steps is some 60 launches (the trilinear lookup alone
// is 8 gathers and 7 lerps), in every bounce of every chunk of a frame.
// Plain version and semantics: ops/volume.py (march_plain).
//
// Bound on the H100: instruction issue. A step is some 150 instructions
// (the trilinear lookup's index and weight arithmetic, 8 grid reads, an
// IEEE expf, the compositing) without fused multiply-adds, and the grid of
// a molecule's volume (a few MB) stays in L2. Only a tenth of a frame's
// rays enter the box, but they are the neighbouring pixels of one region,
// so the warps that march are mostly full and the others leave at once.
// The design keeps all of a ray's state in registers, issues every read a
// ray needs before it uses one, reads each ray operand through its own
// pointer (a row or one value for every ray: no staged operand), indexes
// the grid with 32-bit ints, and exits as soon as the ray's march ends or
// its throughput dies. Measured slower on the H100 and left out (PERF.md,
// section 6): compacting the marching rays into a list first, persistent warps
// that refill idle lanes from a queue of marching rays, and a lane issuing
// the grid reads of its next 2 or 4 steps before it uses the first.
//
// Every expression is the plain version's, in the same operation order
// with float literals, built -fmad=false so each product and sum rounds as
// the plain version's separate tensor ops round. The grid is read with
// __ldg, never through a texture: hardware trilinear filtering weighs with
// 8-bit fixed-point fractions. exp is expf, as torch.exp computes it on
// the card.
//
// Early exit: the plain version runs every lane through all max_steps
// steps; after a lane stops, each step adds (tp * color) * 0 = +0.0 to a
// radiance that started at +0.0 and never turns -0.0, and multiplies tp
// by 1, so the break changes no bit. A ray with max_steps 0 keeps its
// throughput's bits, as a ray that does not march.
//
// Operands (device pointers, contiguous):
//   ox, oy, oz, dx, dy, dz, t_surface, tpx, tpy, tpz  origin, direction,
//                    surface t, throughput: each f32[n] (step 1) or one f32
//                    for every ray (step 0)
//   active u8[n]     1 live, 0 inactive; null: every ray live
//   params f32[16]   vmin xyz, vmax xyz, max_value, t_min, colour xyz,
//                    density scale, opacity, step, threshold, unused
//   grid   f32[nz,ny,nx], x fastest, under 2^31 values
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

// A ray operand: a row of n floats (step 1) or one float for every ray
// (step 0).
struct Col {
  const float* p;
  int step;
  __device__ __forceinline__ float at(long long i) const { return __ldg(p + i * step); }
};

struct Rays {
  Col ox, oy, oz, dx, dy, dz, t_surface, tpx, tpy, tpz;
  const unsigned char* active;
  long long n;
};

// The uniforms of the march: the params vector.
struct Params {
  float vmin[3], vmax[3], color[3];
  float max_value, t_min, density_scale, opacity, step, threshold;
};

__device__ __forceinline__ Params load_params(const float* __restrict__ p) {
  Params q;
  for (int a = 0; a < 3; ++a) {
    q.vmin[a] = __ldg(p + a);
    q.vmax[a] = __ldg(p + 3 + a);
    q.color[a] = __ldg(p + 8 + a);
  }
  q.max_value = __ldg(p + 6);
  q.t_min = __ldg(p + 7);
  q.density_scale = __ldg(p + 11);
  q.opacity = __ldg(p + 12);
  q.step = __ldg(p + 13);
  q.threshold = __ldg(p + 14);
  return q;
}

__global__ void __launch_bounds__(kThreads)
volume_march_kernel(Rays rays, const float* __restrict__ params,
                    const float* __restrict__ grid, int nx, int ny, int nz, int max_steps,
                    float* __restrict__ out) {
  const long long n = rays.n;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // Every read a ray needs is issued before any is used.
  const float o[3] = {rays.ox.at(i), rays.oy.at(i), rays.oz.at(i)};
  const float d[3] = {rays.dx.at(i), rays.dy.at(i), rays.dz.at(i)};
  const float t_surface = rays.t_surface.at(i);
  const float tp_in[3] = {rays.tpx.at(i), rays.tpy.at(i), rays.tpz.at(i)};
  const bool active = rays.active == nullptr || rays.active[i] != 0;
  const Params q = load_params(params);

  // The segment marched: the box range clipped to [t_min, t_surface].
  float t_near, t_far;
  bool ok;
  slab(o[0], d[0], q.vmin[0], q.vmax[0], true, t_near, t_far, ok);
  slab(o[1], d[1], q.vmin[1], q.vmax[1], false, t_near, t_far, ok);
  slab(o[2], d[2], q.vmin[2], q.vmax[2], false, t_near, t_far, ok);
  const bool hit_box = ok && (t_far >= fmaxf(t_near, 0.0f));
  const float t_enter = fmaxf(t_near, q.t_min);
  const float t_exit = fminf(t_far, t_surface);
  const bool run = active && hit_box && (t_exit > t_enter) && (q.step > 0.0f);

  float rad[3] = {0.0f, 0.0f, 0.0f};
  float tp[3] = {tp_in[0], tp_in[1], tp_in[2]};
  if (run) {
    const float inv_max = 1.0f / fmaxf(q.max_value, 1e-6f);
    const float inv_size[3] = {1.0f / fmaxf(q.vmax[0] - q.vmin[0], 1e-12f),
                               1.0f / fmaxf(q.vmax[1] - q.vmin[1], 1e-12f),
                               1.0f / fmaxf(q.vmax[2] - q.vmin[2], 1e-12f)};
    const int nxy = nx * ny;
    for (int s = 0; s < max_steps; ++s) {
      const float t_cur = t_enter + q.step * static_cast<float>(s);
      const bool inside = t_cur <= t_exit;
      const float dt = fminf(q.step, t_exit - t_cur);
      const Axis ax = texel(o[0] + d[0] * t_cur, q.vmin[0], inv_size[0], nx);
      const Axis ay = texel(o[1] + d[1] * t_cur, q.vmin[1], inv_size[1], ny);
      const Axis az = texel(o[2] + d[2] * t_cur, q.vmin[2], inv_size[2], nz);
      const int z0 = az.i0 * nxy, z1 = az.i1 * nxy;
      const int y0 = ay.i0 * nx, y1 = ay.i1 * nx;
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
      density = fmaxf(density - q.threshold, 0.0f);
      float alpha = 1.0f - expf(-density * q.density_scale * dt);
      alpha = clampf(alpha * q.opacity, 0.0f, 1.0f);
      alpha = (inside && density > 0.0f) ? alpha : 0.0f;
      for (int c = 0; c < 3; ++c) {
        rad[c] = rad[c] + tp[c] * q.color[c] * alpha;
        tp[c] = tp[c] * (1.0f - alpha);
      }
      const bool dead = fmaxf(tp[0], fmaxf(tp[1], tp[2])) < 1e-3f;
      if (inside && dead) tp[0] = tp[1] = tp[2] = 0.0f;
      if (dead || !(t_cur + q.step <= t_exit)) break;
    }
  }
  for (int c = 0; c < 3; ++c) {
    out[c * n + i] = rad[c];
    out[(3 + c) * n + i] = run ? tp[c] : tp_in[c];
  }
}

}  // namespace

extern "C" int wrt_volume_march(const float* ox, int ox_step, const float* oy, int oy_step,
                                const float* oz, int oz_step, const float* dx, int dx_step,
                                const float* dy, int dy_step, const float* dz, int dz_step,
                                const float* t_surface, int t_surface_step, const float* tpx,
                                int tpx_step, const float* tpy, int tpy_step,
                                const float* tpz, int tpz_step, const unsigned char* active,
                                long long n, const float* params, const float* grid, int nx,
                                int ny, int nz, int max_steps, float* out, void* stream) {
  const Rays rays{Col{ox, ox_step},     Col{oy, oy_step},   Col{oz, oz_step},
                  Col{dx, dx_step},     Col{dy, dy_step},   Col{dz, dz_step},
                  Col{t_surface, t_surface_step},
                  Col{tpx, tpx_step},   Col{tpy, tpy_step}, Col{tpz, tpz_step},
                  active,               n};
  const long long blocks = (n + kThreads - 1) / kThreads;
  volume_march_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(rays, params, grid, nx, ny, nz,
                                                             max_steps, out);
  return static_cast<int>(cudaGetLastError());
}
