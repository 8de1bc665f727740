// The stack tracer: closest hit and occlusion per ray by a walk of the
// unified BVH with a private stack, one thread a ray (the reference
// viewer's traceClosest / traceAny, webgl.js:556-880).
//
// Replaces no TPU kernel: the JAX package walks with a jax.lax.while_loop
// (webgl_raytracer_tpu/ops/traversal.py, _traverse, :130), which XLA runs
// as one device loop over the whole batch. Written as PyTorch tensor
// operations a step of that loop is some 140 launches on a sphere scene
// and 550 on a three-type one, and the loop runs until the longest ray's
// stack empties (hundreds of steps, at most 2048). Plain version and
// semantics: ops/traversal.py (walk_plain).
//
// Bound on the H100: dependent loads. A step pops a node, reads its 36
// bytes of box and links, and for a leaf up to 4 primitive rows of 48
// bytes; the next pop depends on this one's result, so a ray's walk is a
// chain of L1/L2 round trips, not of arithmetic (a step is some 40 FP32
// operations for the slab test and 25-100 a primitive). The tables of a
// molecular scene (a few MB) stay in the 50 MB L2. The design keeps a
// ray's state in registers and its stack of kStack ints in local memory
// (L1), reads the rows straight from device memory through L1/L2, and
// lets each thread run its own walk to its end: a warp runs as long as
// its longest ray. Types are specialised at compile time (kSph, kCyl,
// kTri), as the plain version intersects only the scene's types.
//
// Every expression is the plain version's (ops/intersect.py) in the same
// operation order with float literals, built -fmad=false with IEEE sqrtf
// and division, so t, slot, extra, cost and the occlusion bit equal the
// plain walk's bit for bit. min and max propagate NaN, as torch.minimum
// and torch.maximum do.
//
// Operands (device pointers, contiguous):
//   od   f32[10,n] rows: origin xyz, direction xyz, t_min, t_max (the
//                  closest t the walk starts from), accept_min, active (1/0)
//   node_bmin, node_bmax f32[nodes,3]; node_meta i32[nodes,3]
//                  (leftFirst, primCount, rightChild)
//   prim_a, prim_b, prim_c f32[prims,4]; prim_type i32[prims]
//   cp   f32[8]    clip plane: normal xyz, offset, side (world coordinates)
// Outputs, closest hit: t f32[n], slot i32[n] (-1 on a miss), extra
// f32[n,3], cost i32[n]; occlusion: found u8[n], cost i32[n].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
// The stack's slots: ops/traversal.py STACK_DEPTH, passed by the build
// (ops/kernels.py compile_flags), so the plain walk and this kernel apply
// one overflow guard.
#ifndef WRT_STACK_DEPTH
#error "WRT_STACK_DEPTH (ops/traversal.py STACK_DEPTH) is not defined"
#endif
constexpr int kStack = WRT_STACK_DEPTH;
constexpr float kBig = 1e20f;
constexpr int kTriangle = 0, kSphere = 1, kCylinder = 2;

__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (b < a ? b : a);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (b > a ? b : a);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
// ops/intersect.py dot: the products summed left to right.
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct Slab {
  float near, far;
  bool ok;
};

__device__ __forceinline__ Slab slab(float o, float d, float lo, float hi) {
  const bool parallel = fabsf(d) < 1e-8f;
  const float inv = 1.0f / (parallel ? 1.0f : d);
  const float t1 = (lo - o) * inv;
  const float t2 = (hi - o) * inv;
  return {parallel ? -kBig : nmin(t1, t2), parallel ? kBig : nmax(t1, t2),
          !parallel || (o >= lo && o <= hi)};
}

// ops/intersect.py intersect_aabb.
__device__ __forceinline__ bool box_hit(const float* lo, const float* hi, V3 o, V3 d,
                                        float t_max) {
  const Slab x = slab(o.x, d.x, lo[0], hi[0]);
  const Slab y = slab(o.y, d.y, lo[1], hi[1]);
  const Slab z = slab(o.z, d.z, lo[2], hi[2]);
  const float tmin = nmax(nmax(nmax(x.near, y.near), z.near), 0.0f);
  const float tmax = nmin(nmin(nmin(x.far, y.far), z.far), t_max);
  return x.ok && y.ok && z.ok && tmax >= tmin;
}

// ops/intersect.py intersect_sphere.
__device__ __forceinline__ float sphere(V3 o, V3 d, V3 c, float r, float t_min) {
  const V3 oc = sub(o, c);
  const float b = dot(oc, d);
  const float cc = dot(oc, oc) - r * r;
  const float disc = b * b - cc;
  const bool ok = disc >= 0.0f;
  const float sq = sqrtf(ok ? disc : 0.0f);
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  const float t = t0 > t_min ? t0 : t1;
  return (ok && t > t_min) ? t : -1.0f;
}

// ops/intersect.py intersect_cylinder: t, and the cap code in ht.
__device__ __forceinline__ float cylinder(V3 o, V3 d, V3 p1, V3 p2, float r, float t_min,
                                          float& ht) {
  const V3 axis_raw = sub(p2, p1);
  const float height = sqrtf(dot(axis_raw, axis_raw));
  const bool degen = height < 1e-6f;
  const float safe_h = degen ? 1.0f : height;
  const V3 axis = {axis_raw.x / safe_h, axis_raw.y / safe_h, axis_raw.z / safe_h};
  const V3 oc = sub(o, p1);
  const float dir_dot = dot(d, axis);
  const float oc_dot = dot(oc, axis);
  const V3 dir_perp = sub(d, scale(axis, dir_dot));
  const V3 oc_perp = sub(oc, scale(axis, oc_dot));
  const float a = dot(dir_perp, dir_perp);
  const float b = 2.0f * dot(dir_perp, oc_perp);
  const float c = dot(oc_perp, oc_perp) - r * r;
  const float disc = b * b - 4.0f * a * c;
  const bool body_ok = a > 1e-8f && disc >= 0.0f;
  const float sq = sqrtf(body_ok ? disc : 0.0f);
  const float denom = body_ok ? 2.0f * a : 1.0f;
  const float t1 = (-b - sq) / denom;
  const float t2 = (-b + sq) / denom;
  const float h1 = oc_dot + t1 * dir_dot;
  const float h2 = oc_dot + t2 * dir_dot;
  const bool t1_ok = body_ok && t1 > t_min && h1 >= 0.0f && h1 <= height;
  const bool t2_ok = body_ok && !t1_ok && t2 > t_min && h2 >= 0.0f && h2 <= height;
  float best = t1_ok ? t1 : (t2_ok ? t2 : -1.0f);
  float hit_type = 0.0f;
  const float t_p1 = sphere(o, d, p1, r, t_min);
  {
    const V3 pos = add(o, scale(d, t_p1));
    const float h = dot(sub(pos, p1), axis);
    if (t_p1 > t_min && (best < 0.0f || t_p1 < best) && h * -1.0f >= 0.0f) {
      best = t_p1;
      hit_type = 1.0f;
    }
  }
  {
    const float tc = sphere(o, d, p2, r, t_min);
    const V3 pos = add(o, scale(d, tc));
    const float h = dot(sub(pos, p2), axis);
    if (tc > t_min && (best < 0.0f || tc < best) && h * 1.0f >= 0.0f) {
      best = tc;
      hit_type = 2.0f;
    }
  }
  if (degen) {
    best = t_p1;
    hit_type = 0.0f;
  }
  ht = hit_type;
  return best;
}

// ops/intersect.py intersect_triangle, then clip_reject.
__device__ __forceinline__ float triangle(V3 o, V3 d, V3 v0, V3 v1, V3 v2, float t_min,
                                          const float* cp, bool clip_on, float& u,
                                          float& v) {
  const V3 e1 = sub(v1, v0);
  const V3 e2 = sub(v2, v0);
  const V3 p = cross(d, e2);
  const float det = dot(e1, p);
  bool ok = fabsf(det) >= 1e-6f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const V3 tvec = sub(o, v0);
  u = dot(tvec, p) * inv;
  const V3 q = cross(tvec, e1);
  v = dot(d, q) * inv;
  const float t = dot(e2, q) * inv;
  ok = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min;
  float tt = ok ? t : -1.0f;
  if (clip_on) {
    const V3 pos = add(o, scale(d, tt));
    const float s = dot(pos, V3{cp[0], cp[1], cp[2]}) - cp[3];
    if (s * cp[4] > 0.0f) tt = -1.0f;
  }
  return tt;
}

__device__ __forceinline__ V3 row3(const float* __restrict__ p, int i) {
  return {p[4 * i], p[4 * i + 1], p[4 * i + 2]};
}

template <bool kAny, bool kSph, bool kCyl, bool kTri>
__global__ void __launch_bounds__(kThreads)
trace_stack_kernel(const float* __restrict__ od, long long n,
                   const float* __restrict__ node_bmin, const float* __restrict__ node_bmax,
                   const int* __restrict__ node_meta, const float* __restrict__ prim_a,
                   const float* __restrict__ prim_b, const float* __restrict__ prim_c,
                   const int* __restrict__ prim_type, const float* __restrict__ cp,
                   int clip_on, int max_steps, int max_leaf, float* __restrict__ t_out,
                   int* __restrict__ slot_out, float* __restrict__ extra_out,
                   unsigned char* __restrict__ found_out, int* __restrict__ cost_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = {od[i], od[n + i], od[2 * n + i]};
  const V3 d = {od[3 * n + i], od[4 * n + i], od[5 * n + i]};
  const float t_min = od[6 * n + i];
  const float accept_min = od[8 * n + i];
  float closest = od[7 * n + i];
  int sp = od[9 * n + i] > 0.0f ? 1 : 0;
  int stack[kStack];
  stack[0] = 0;
  int best = -1, cost = 0;
  float e0 = 0.0f, e1 = 0.0f;
  bool found = false;
  for (int step = 0; step < max_steps && sp > 0; ++step) {
    const int sp_pop = sp - 1;
    const int node = stack[sp_pop];
    const int left = node_meta[3 * node], count = node_meta[3 * node + 1];
    const int right = node_meta[3 * node + 2];
    const bool hit = box_hit(node_bmin + 3 * node, node_bmax + 3 * node, o, d, closest);
    int tests = 0;
    if (hit && count > 0) {
      for (int k = 0; k < max_leaf && k < count; ++k) {
        const int slot = left + k;
        const int type = prim_type[slot];
        float t = -1.0f, x0 = 0.0f, x1 = 0.0f;
        if (kSph && type == kSphere) {
          t = sphere(o, d, row3(prim_a, slot), prim_a[4 * slot + 3], t_min);
        } else if (kCyl && type == kCylinder) {
          t = cylinder(o, d, row3(prim_a, slot), row3(prim_b, slot), prim_a[4 * slot + 3],
                       t_min, x0);
        } else if (kTri && type == kTriangle) {
          t = triangle(o, d, row3(prim_a, slot), row3(prim_b, slot), row3(prim_c, slot),
                       t_min, cp, clip_on != 0, x0, x1);
        }
        if (kAny) {
          if (t > accept_min && t < closest) found = true;
        } else if (t > 0.0f && t < closest) {
          closest = t;
          best = slot;
          e0 = x0;
          e1 = x1;
        }
        ++tests;
      }
    }
    const bool push = hit && count <= 0 && sp_pop <= kStack - 2 && !(kAny && found);
    if (push) {
      stack[sp_pop] = right;
      stack[sp_pop + 1] = left;
      sp = sp_pop + 2;
    } else {
      sp = sp_pop;
    }
    if (kAny && found) sp = 0;
    cost += 1 + tests;
  }
  cost_out[i] = cost;
  if (kAny) {
    found_out[i] = found ? 1 : 0;
  } else {
    t_out[i] = closest;
    slot_out[i] = best;
    extra_out[3 * i] = e0;
    extra_out[3 * i + 1] = e1;
    extra_out[3 * i + 2] = 0.0f;
  }
}

template <bool kAny, bool kSph, bool kCyl, bool kTri>
int launch_typed(const float* od, long long n, const float* node_bmin, const float* node_bmax,
                 const int* node_meta, const float* prim_a, const float* prim_b,
                 const float* prim_c, const int* prim_type, const float* cp, int clip_on,
                 int max_steps, int max_leaf, float* t_out, int* slot_out, float* extra_out,
                 unsigned char* found_out, int* cost_out, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  trace_stack_kernel<kAny, kSph, kCyl, kTri>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          od, n, node_bmin, node_bmax, node_meta, prim_a, prim_b, prim_c, prim_type, cp,
          clip_on, max_steps, max_leaf, t_out, slot_out, extra_out, found_out, cost_out);
  return static_cast<int>(cudaGetLastError());
}

// types: 1 spheres, 2 cylinders, 4 triangles (ops/traversal.py type_mask).
template <bool kAny>
int launch(const float* od, long long n, const float* node_bmin, const float* node_bmax,
           const int* node_meta, const float* prim_a, const float* prim_b, const float* prim_c,
           const int* prim_type, int types, const float* cp, int clip_on, int max_steps,
           int max_leaf, float* t_out, int* slot_out, float* extra_out,
           unsigned char* found_out, int* cost_out, void* stream) {
#define WRT_STACK_CASE(mask, s, c, t)                                                    \
  case mask:                                                                             \
    return launch_typed<kAny, s, c, t>(od, n, node_bmin, node_bmax, node_meta, prim_a,  \
                                       prim_b, prim_c, prim_type, cp, clip_on,          \
                                       max_steps, max_leaf, t_out, slot_out, extra_out, \
                                       found_out, cost_out, stream);
  switch (types) {
    WRT_STACK_CASE(0, false, false, false)
    WRT_STACK_CASE(1, true, false, false)
    WRT_STACK_CASE(2, false, true, false)
    WRT_STACK_CASE(3, true, true, false)
    WRT_STACK_CASE(4, false, false, true)
    WRT_STACK_CASE(5, true, false, true)
    WRT_STACK_CASE(6, false, true, true)
    WRT_STACK_CASE(7, true, true, true)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WRT_STACK_CASE
}

}  // namespace

extern "C" int wrt_trace_stack_closest(const float* od, long long n, const float* node_bmin,
                                       const float* node_bmax, const int* node_meta,
                                       const float* prim_a, const float* prim_b,
                                       const float* prim_c, const int* prim_type, int types,
                                       const float* cp, int clip_on, int max_steps,
                                       int max_leaf, float* t_out, int* slot_out,
                                       float* extra_out, int* cost_out, void* stream) {
  return launch<false>(od, n, node_bmin, node_bmax, node_meta, prim_a, prim_b, prim_c,
                       prim_type, types, cp, clip_on, max_steps, max_leaf, t_out, slot_out,
                       extra_out, nullptr, cost_out, stream);
}

extern "C" int wrt_trace_stack_any(const float* od, long long n, const float* node_bmin,
                                   const float* node_bmax, const int* node_meta,
                                   const float* prim_a, const float* prim_b,
                                   const float* prim_c, const int* prim_type, int types,
                                   const float* cp, int clip_on, int max_steps, int max_leaf,
                                   unsigned char* found_out, int* cost_out, void* stream) {
  return launch<true>(od, n, node_bmin, node_bmax, node_meta, prim_a, prim_b, prim_c,
                      prim_type, types, cp, clip_on, max_steps, max_leaf, nullptr, nullptr,
                      nullptr, found_out, cost_out, stream);
}
