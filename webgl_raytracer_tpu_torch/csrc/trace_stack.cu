// The stack tracer: closest hit and occlusion per ray by a walk of the
// unified BVH with a private stack (the reference viewer's traceClosest /
// traceAny, webgl.js:556-880).
//
// Replaces no TPU kernel: the JAX package walks with a jax.lax.while_loop
// (webgl_raytracer_tpu/ops/traversal.py, _traverse, :130), which XLA runs
// as one device loop over the whole batch. Written as PyTorch tensor
// operations a step of that loop is some 140 launches on a sphere scene
// and 550 on a three-type one, and the loop runs until the longest ray's
// stack empties (hundreds of steps, at most 2048). Plain version and
// semantics: ops/traversal.py (walk_plain).
//
// Bound on the H100: dependent loads and divergence. A step pops a node,
// reads its 32 bytes of box and links, and for a leaf up to 4 primitive
// rows of 16-48 bytes; the next pop depends on this one's result, so a
// ray's walk is a chain of L1/L2 round trips (a step is some 40 FP32
// operations for the slab test and 25-100 a primitive). The tables of a
// molecular scene (a few MB) stay in the 50 MB L2. Walks differ in length
// (a mean of 6.4 units and a maximum of 101 on the 1000-sphere primaries),
// and most rays of a shadow batch are inactive. The design, one thread a
// ray:
//   * a batch with an activity mask is compacted first (stack_compact_
//     kernel): an inactive ray reads its activity byte (and, for a closest
//     hit, its t_max), writes its miss and takes no lane of the walk; the
//     walk runs over the live rays' list, its count read on the device,
//     in ray order within each 1024-ray block, so that a warp walks
//     neighbouring rays (in the order warps reached an atomic, the [3N]
//     shadow fan walked 11% slower);
//   * each ray operand is its own pointer (no staged operand), a row or
//     one value for every ray (the primaries' origin, t_min);
//   * one node is 32 bytes, two aligned float4 read with __ldg
//     (ops/traversal.pack_nodes: bmin and leftFirst, bmax and the count or
//     the right child); a leaf's primitive rows are float4s, the rows the
//     scene's types need issued together with the type;
//   * a ray's state in registers, its stack of kStack ints in local memory
//     (L1); types specialised at compile time (kSph, kCyl, kTri), as the
//     plain version intersects only the scene's types.
// Measured slower on the H100 and left out (PERF.md, section 6): persistent
// warps that refill idle lanes from a per-warp queue (Aila & Laine 2009),
// and the node table in shared memory.
//
// Every expression is the plain version's (ops/intersect.py) in the same
// operation order with float literals, built -fmad=false with IEEE sqrtf
// and division, so t, slot, extra, cost and the occlusion bit equal the
// plain walk's bit for bit. min and max propagate NaN, as torch.minimum
// and torch.maximum do. A masked square root takes 1 where the plain
// version takes 0 (IEEE sqrtf's slow path serves 0); the mask discards the
// result either way. Each ray's walk order is fixed (right pushed, then
// left), because cost counts it.
//
// Operands (device pointers, contiguous):
//   ox, oy, oz, dx, dy, dz  origin and direction, each f32[n] (step 1) or
//                  one f32 for every ray (step 0)
//   t_min, t_max, accept_min  the same, or a value (null pointer); t_max is
//                  the closest t the walk starts from
//   active u8[n]   1 live, 0 inactive; null: every ray live
//   nodes  f32[nodes,8] (ops/traversal.pack_nodes)
//   prim_a, prim_b, prim_c f32[prims,4]; prim_type i32[prims]
//   cp     f32[8]  clip plane: normal xyz, offset, side (world coordinates);
//                  null without a plane
//   list   i32[n], count u32[1] zero: the live rays' list, with a mask only
// Outputs, closest hit: t f32[n], slot i32[n] (-1 on a miss), extra
// f32[n,3], cost i32[n]; occlusion: found u8[n], cost i32[n].

#include <cuda_runtime.h>
#include <math.h>


namespace {

constexpr int kThreads = 128;
constexpr int kCompactThreads = 1024;   // the compaction pass's block: its rays stay in order
constexpr unsigned kFullMask = 0xffffffffu;
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
__device__ __forceinline__ bool box_hit(float4 lo, float4 hi, V3 o, V3 d, float t_max) {
  const Slab x = slab(o.x, d.x, lo.x, hi.x);
  const Slab y = slab(o.y, d.y, lo.y, hi.y);
  const Slab z = slab(o.z, d.z, lo.z, hi.z);
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
  const float sq = sqrtf(ok ? disc : 1.0f);
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
  const float sq = sqrtf(body_ok ? disc : 1.0f);
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

__device__ __forceinline__ V3 xyz(float4 a) { return {a.x, a.y, a.z}; }

// A ray operand: a row of n floats (step 1) or one float for every ray
// (step 0).
struct Col {
  const float* p;
  int step;
  __device__ __forceinline__ float at(long long i) const { return __ldg(p + i * step); }
};

// A ray operand that may also be a value v for every ray (null pointer).
struct Val {
  const float* p;
  int step;
  float v;
  __device__ __forceinline__ float at(long long i) const {
    return p == nullptr ? v : __ldg(p + i * step);
  }
};

struct Rays {
  Col ox, oy, oz, dx, dy, dz;
  Val t_min, t_max, accept_min;
  const unsigned char* active;
  long long n;
};

struct Tables {
  const float4* nodes;
  const float4 *prim_a, *prim_b, *prim_c;
  const int* prim_type;
  const float* cp;
  int clip_on, max_steps, max_leaf;
};

struct Outs {
  float* t;
  int* slot;
  float* extra;
  unsigned char* found;
  int* cost;
};

template <bool kAny>
__device__ __forceinline__ void store(const Outs& out, long long i, float closest, int best,
                                      float e0, float e1, bool found, int cost) {
  out.cost[i] = cost;
  if (kAny) {
    out.found[i] = found ? 1 : 0;
  } else {
    out.t[i] = closest;
    out.slot[i] = best;
    out.extra[3 * i] = e0;
    out.extra[3 * i + 1] = e1;
    out.extra[3 * i + 2] = 0.0f;
  }
}

// The compaction pass of a batch with an activity mask, one thread a ray:
// an inactive ray writes its outputs; a live ray's index is appended to
// list (its count in *count, zero before the launch), in ray order within
// a block, the blocks' runs reserved by one atomicAdd a block, so that a
// warp of the walk takes neighbouring rays.
template <bool kAny>
__global__ void __launch_bounds__(kCompactThreads)
stack_compact_kernel(Rays rays, Outs out, int* list, unsigned int* count) {
  __shared__ unsigned int warp_base[kCompactThreads / 32];
  __shared__ unsigned int block_base;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in = i < rays.n;
  const bool live = in && rays.active[i] != 0;
  // An inactive ray walks nothing: t_max, slot -1, cost 0, not found.
  if (in && !live) {
    store<kAny>(out, i, kAny ? 0.0f : rays.t_max.at(i), -1, 0.0f, 0.0f, false, 0);
  }
  const unsigned m = __ballot_sync(kFullMask, live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  if (lane == 0) warp_base[warp] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int total = 0;
    for (int w = 0; w < kCompactThreads / 32; ++w) {
      const unsigned int c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    block_base = total ? atomicAdd(count, total) : 0u;
  }
  __syncthreads();
  if (live) {
    list[block_base + warp_base[warp] + __popc(m & ((1u << lane) - 1u))] =
        static_cast<int>(i);
  }
}

// The walk, one thread a ray: of the j-th ray of list (its count in
// *n_live), or of ray j of the batch where list is null.
template <bool kAny, bool kSph, bool kCyl, bool kTri>
__global__ void __launch_bounds__(kThreads)
trace_stack_kernel(Rays rays, Tables tab, Outs out, const int* list,
                   const unsigned int* n_live) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= (list == nullptr ? rays.n : static_cast<long long>(*n_live))) return;
  const long long i = list == nullptr ? j : list[j];
  const V3 o = {rays.ox.at(i), rays.oy.at(i), rays.oz.at(i)};
  const V3 d = {rays.dx.at(i), rays.dy.at(i), rays.dz.at(i)};
  const float t_min = rays.t_min.at(i);
  const float accept_min = kAny ? rays.accept_min.at(i) : 0.0f;
  float closest = rays.t_max.at(i);
  int stack[kStack];
  stack[0] = 0;
  int sp = 1, best = -1, cost = 0;
  float e0 = 0.0f, e1 = 0.0f;
  bool found = false;
  for (int step = 0; step < tab.max_steps && sp > 0; ++step) {
    const int sp_pop = sp - 1;
    const int node = stack[sp_pop];
    const float4 lo = __ldg(tab.nodes + 2 * node);
    const float4 hi = __ldg(tab.nodes + 2 * node + 1);
    // pack_nodes: leftFirst, then the count of a leaf (> 0) or the
    // complement of an inner node's right child (<= 0).
    const int left = __float_as_int(lo.w), link = __float_as_int(hi.w);
    const int count = link > 0 ? link : 0;
    const bool hit = box_hit(lo, hi, o, d, closest);
    int tests = 0;
    if (hit && count > 0) {
      for (int k = 0; k < tab.max_leaf && k < count; ++k) {
        const int slot = left + k;
        const int type = __ldg(tab.prim_type + slot);
        const float4 a = __ldg(tab.prim_a + slot);
        const float4 b = (kCyl || kTri) ? __ldg(tab.prim_b + slot) : float4{};
        const float4 c = kTri ? __ldg(tab.prim_c + slot) : float4{};
        float t = -1.0f, x0 = 0.0f, x1 = 0.0f;
        if (kSph && type == kSphere) {
          t = sphere(o, d, xyz(a), a.w, t_min);
        } else if (kCyl && type == kCylinder) {
          t = cylinder(o, d, xyz(a), xyz(b), a.w, t_min, x0);
        } else if (kTri && type == kTriangle) {
          t = triangle(o, d, xyz(a), xyz(b), xyz(c), t_min, tab.cp, tab.clip_on != 0, x0,
                       x1);
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
      stack[sp_pop] = ~link;
      stack[sp_pop + 1] = left;
      sp = sp_pop + 2;
    } else {
      sp = sp_pop;
    }
    if (kAny && found) sp = 0;
    cost += 1 + tests;
  }
  store<kAny>(out, i, closest, best, e0, e1, found, cost);
}

// A batch with an activity mask is compacted first (list and count the
// caller's, count zero), so that the walk's warps hold live rays only.
template <bool kAny, bool kSph, bool kCyl, bool kTri>
int launch_typed(const Rays& rays, const Tables& tab, const Outs& out, int* list,
                 unsigned int* count, void* stream) {
  const unsigned int blocks = static_cast<unsigned int>((rays.n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool compact = rays.active != nullptr;
  if (compact) {
    const unsigned int scan_blocks =
        static_cast<unsigned int>((rays.n + kCompactThreads - 1) / kCompactThreads);
    stack_compact_kernel<kAny><<<scan_blocks, kCompactThreads, 0, s>>>(rays, out, list, count);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  trace_stack_kernel<kAny, kSph, kCyl, kTri><<<blocks, kThreads, 0, s>>>(
      rays, tab, out, compact ? list : nullptr, count);
  return static_cast<int>(cudaGetLastError());
}

// types: 1 spheres, 2 cylinders, 4 triangles (ops/traversal.py type_mask).
template <bool kAny>
int launch(const Rays& rays, const Tables& tab, int types, const Outs& out, int* list,
           unsigned int* count, void* stream) {
#define WRT_STACK_CASE(mask, s, c, t) \
  case mask:                          \
    return launch_typed<kAny, s, c, t>(rays, tab, out, list, count, stream);
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

Rays make_rays(const float* ox, int ox_step, const float* oy, int oy_step, const float* oz,
               int oz_step, const float* dx, int dx_step, const float* dy, int dy_step,
               const float* dz, int dz_step, const float* t_min, int t_min_step,
               float t_min_value, const float* t_max, int t_max_step, float t_max_value,
               const float* accept_min, int accept_step, float accept_value,
               const unsigned char* active, long long n) {
  return Rays{Col{ox, ox_step},
              Col{oy, oy_step},
              Col{oz, oz_step},
              Col{dx, dx_step},
              Col{dy, dy_step},
              Col{dz, dz_step},
              Val{t_min, t_min_step, t_min_value},
              Val{t_max, t_max_step, t_max_value},
              Val{accept_min, accept_step, accept_value},
              active,
              n};
}

Tables make_tables(const float* nodes, const float* prim_a, const float* prim_b,
                   const float* prim_c, const int* prim_type, const float* cp, int clip_on,
                   int max_steps, int max_leaf) {
  return Tables{reinterpret_cast<const float4*>(nodes),
                reinterpret_cast<const float4*>(prim_a),
                reinterpret_cast<const float4*>(prim_b),
                reinterpret_cast<const float4*>(prim_c),
                prim_type, cp, clip_on, max_steps, max_leaf};
}

}  // namespace

// The two entry points take the same operands up to the outputs: the ray
// operands (ox ... accept_value, active, n), the tables (nodes ...
// prim_type), the type bits, the clip operand, max_steps, max_leaf and the
// live list with its count.
#define WRT_STACK_OPERANDS                                                                 \
  const float *ox, int ox_step, const float *oy, int oy_step, const float *oz, int oz_step, \
      const float *dx, int dx_step, const float *dy, int dy_step, const float *dz,         \
      int dz_step, const float *t_min, int t_min_step, float t_min_value,                  \
      const float *t_max, int t_max_step, float t_max_value, const float *accept_min,      \
      int accept_step, float accept_value, const unsigned char *active, long long n,       \
      const float *nodes, const float *prim_a, const float *prim_b, const float *prim_c,   \
      const int *prim_type, int types, const float *cp, int clip_on, int max_steps,        \
      int max_leaf, int *list, unsigned int *count
#define WRT_STACK_MAKE                                                                     \
  make_rays(ox, ox_step, oy, oy_step, oz, oz_step, dx, dx_step, dy, dy_step, dz, dz_step,  \
            t_min, t_min_step, t_min_value, t_max, t_max_step, t_max_value, accept_min,    \
            accept_step, accept_value, active, n),                                         \
      make_tables(nodes, prim_a, prim_b, prim_c, prim_type, cp, clip_on, max_steps,        \
                  max_leaf)

extern "C" int wrt_trace_stack_closest(WRT_STACK_OPERANDS, float* t_out, int* slot_out,
                                       float* extra_out, int* cost_out, void* stream) {
  return launch<false>(WRT_STACK_MAKE, types,
                       Outs{t_out, slot_out, extra_out, nullptr, cost_out}, list, count,
                       stream);
}

extern "C" int wrt_trace_stack_any(WRT_STACK_OPERANDS, unsigned char* found_out,
                                   int* cost_out, void* stream) {
  return launch<true>(WRT_STACK_MAKE, types,
                      Outs{nullptr, nullptr, nullptr, found_out, cost_out}, list, count, stream);
}
