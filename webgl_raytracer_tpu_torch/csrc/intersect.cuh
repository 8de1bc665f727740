// Per-ray cluster tracing maths shared by the trace kernels
// (trace_closest.cu, trace_closest_attrs.cu, trace_any3.cu, trace_any.cu,
// trace_closest_perray.cu, trace_any_perray.cu), and the warp schedules
// they share: the index-order closest-hit walk (closest_walk:
// trace_closest.cu and trace_closest_attrs.cu), the ray-major occlusion
// walk (any_raymajor: trace_any3.cu and trace_any.cu) and the per-ray
// front-to-back walk (perray_walk: trace_closest_perray.cu,
// trace_any_perray.cu). No trace kernel uses shared memory or a block
// barrier: a warp owns 32 rays and its collectives are full-mask.
//
// Every expression here is the one in ops/wavefront.py (cluster_entry_t,
// intersect_soa_t), written in the same operation order with float
// literals, so that under -fmad=false each product and sum rounds exactly
// as the plain PyTorch version's separate tensor ops round. Padding
// primitives carry NaN radii (ops/trace.scene_operands): every compare
// against a NaN is false, so they never hit. Do not build with
// --use_fast_math: it breaks both the NaN rule and IEEE sqrtf / division.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace wrt {

constexpr float kBig = 1e20f;
constexpr int kLanes = 128;             // primitives per cluster
constexpr int kRows = 12;               // SoA rows per cluster
constexpr int kClusterFloats = kRows * kLanes;
constexpr int kThreads = 128;           // rays per block
// Blocks per SM the trace kernels' register budget must allow: at most
// 128 registers a thread, 16 resident warps.
constexpr int kMinBlocks = 4;
constexpr int kGroup = 128;             // clusters per group (per-ray walk)

constexpr int kTriangle = 0;
constexpr int kSphere = 1;
constexpr int kCylinder = 2;

struct Ray {
  float dx, dy, dz;   // direction
  float ox, oy, oz;   // origin, scene-centred
  float tmin;
};

struct Clip {
  bool on;
  float nx, ny, nz, off, side;   // centred plane n.x = off; reject s*side > 0
};

__device__ __forceinline__ Clip load_clip(const float* cp, int clip_on) {
  Clip c;
  c.on = clip_on != 0;
  c.nx = cp[0];
  c.ny = cp[1];
  c.nz = cp[2];
  c.off = cp[3];
  c.side = cp[4];
  return c;
}

// Ray i of an operand whose rows 0-7 are d xyz, centred o xyz, t_min and
// activity (1/0); a lane past n gets a zero ray. Returns its activity.
__device__ __forceinline__ bool load_ray(const float* __restrict__ od, long long n,
                                         long long i, Ray& r) {
  r = Ray{};
  if (i >= n) {
    return false;
  }
  r.dx = od[i];
  r.dy = od[n + i];
  r.dz = od[2 * n + i];
  r.ox = od[3 * n + i];
  r.oy = od[4 * n + i];
  r.oz = od[5 * n + i];
  r.tmin = od[6 * n + i];
  return od[7 * n + i] > 0.0f;
}

// The terms of a ray's slab tests that no box changes: per axis the
// origin, whether the direction is parallel to the axis, and the
// reciprocal of the direction (of 1 where parallel). A walk over many
// boxes computes them once instead of three IEEE divisions a box.
struct SlabRay {
  float o[3];
  float inv[3];
  bool parallel[3];
};

__device__ __forceinline__ SlabRay slab_ray(const Ray& r) {
  const float d[3] = {r.dx, r.dy, r.dz};
  SlabRay s;
  s.o[0] = r.ox;
  s.o[1] = r.oy;
  s.o[2] = r.oz;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    s.parallel[a] = fabsf(d[a]) < 1e-8f;
    s.inv[a] = 1.0f / (s.parallel[a] ? 1.0f : d[a]);
  }
  return s;
}

// Entry distance into an AABB (lo xyz at box[0..2], hi at box[3..5]);
// +inf on a miss. ops/wavefront.cluster_entry_t.
__device__ __forceinline__ float slab_entry(const float* box, const SlabRay& s) {
  float tn = -kBig;
  float tf = kBig;
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = box[a];
    const float hi = box[3 + a];
    const float t1 = (lo - s.o[a]) * s.inv[a];
    const float t2 = (hi - s.o[a]) * s.inv[a];
    tn = fmaxf(tn, s.parallel[a] ? -kBig : fminf(t1, t2));
    tf = fminf(tf, s.parallel[a] ? kBig : fmaxf(t1, t2));
    ok = ok && (!s.parallel[a] || (s.o[a] >= lo && s.o[a] <= hi));
  }
  const float tn0 = fmaxf(tn, 0.0f);
  return (ok && tf >= tn0) ? tn0 : INFINITY;
}

// Sphere quadratic; -1 on a miss. It returns as soon as the discriminant
// says miss, with the value the full sequence would give: a warp whose
// lanes all miss then skips the IEEE sqrtf sequence (35% of
// trace_closest's time on the 1000-sphere 1080p primaries, PERF.md).
__device__ __forceinline__ float sphere_t(const Ray& r, float cx, float cy, float cz,
                                          float ra) {
  const float sx = r.ox - cx;
  const float sy = r.oy - cy;
  const float sz = r.oz - cz;
  const float b = sx * r.dx + sy * r.dy + sz * r.dz;
  const float cterm = sx * sx + sy * sy + sz * sz - ra * ra;
  const float disc = b * b - cterm;
  if (!(disc >= 0.0f)) {
    return -1.0f;
  }
  const float sq = sqrtf(disc);
  const float t0 = -b - sq;
  const float t1 = -b + sq;
  float ts = (t0 > r.tmin) ? t0 : t1;
  return (ts > r.tmin) ? ts : -1.0f;
}

// Capped cylinder p1 -> p2; a degenerate one is a sphere at p1.
__device__ __forceinline__ float cylinder_t(const Ray& r, float p1x, float p1y,
                                            float p1z, float ra, float p2x,
                                            float p2y, float p2z) {
  const float avx = p2x - p1x;
  const float avy = p2y - p1y;
  const float avz = p2z - p1z;
  const float h2 = avx * avx + avy * avy + avz * avz;
  const float height = sqrtf(h2);
  const bool degen = height < 1e-6f;
  const float inv_h = 1.0f / (degen ? 1.0f : height);
  const float ax = avx * inv_h;
  const float ay = avy * inv_h;
  const float az = avz * inv_h;

  const float ocx = r.ox - p1x;
  const float ocy = r.oy - p1y;
  const float ocz = r.oz - p1z;
  const float dir_dot = r.dx * ax + r.dy * ay + r.dz * az;
  const float oc_dot = ocx * ax + ocy * ay + ocz * az;
  const float dpx = r.dx - ax * dir_dot;
  const float dpy = r.dy - ay * dir_dot;
  const float dpz = r.dz - az * dir_dot;
  const float opx = ocx - ax * oc_dot;
  const float opy = ocy - ay * oc_dot;
  const float opz = ocz - az * oc_dot;
  const float a_q = dpx * dpx + dpy * dpy + dpz * dpz;
  const float b_q = 2.0f * (dpx * opx + dpy * opy + dpz * opz);
  const float c_q = opx * opx + opy * opy + opz * opz - ra * ra;
  const float disc = b_q * b_q - 4.0f * a_q * c_q;
  const bool okq = (a_q > 1e-8f) && (disc >= 0.0f);
  const float sq = sqrtf(okq ? disc : 0.0f);
  const float den = okq ? 2.0f * a_q : 1.0f;
  const float t1c = (-b_q - sq) / den;
  const float t2c = (-b_q + sq) / den;
  const float hh1 = oc_dot + t1c * dir_dot;
  const float hh2 = oc_dot + t2c * dir_dot;
  const bool ok1 = okq && (t1c > r.tmin) && (hh1 >= 0.0f) && (hh1 <= height);
  const bool ok2 = okq && !ok1 && (t2c > r.tmin) && (hh2 >= 0.0f) && (hh2 <= height);
  float tc = ok1 ? t1c : (ok2 ? t2c : -1.0f);

  const float cap[2][3] = {{p1x, p1y, p1z}, {p2x, p2y, p2z}};
  const float sign[2] = {-1.0f, 1.0f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float qx = r.ox - cap[e][0];
    const float qy = r.oy - cap[e][1];
    const float qz = r.oz - cap[e][2];
    const float bq = qx * r.dx + qy * r.dy + qz * r.dz;
    const float cq = qx * qx + qy * qy + qz * qz - ra * ra;
    const float dq = bq * bq - cq;
    const bool okc = dq >= 0.0f;
    const float sqc = sqrtf(okc ? dq : 0.0f);
    float tq = (-bq - sqc > r.tmin) ? (-bq - sqc) : (-bq + sqc);
    tq = (okc && tq > r.tmin) ? tq : -1.0f;
    const float h = (qx + r.dx * tq) * ax + (qy + r.dy * tq) * ay +
                    (qz + r.dz * tq) * az;
    const bool better = (tq > r.tmin) && ((tc < 0.0f) || (tq < tc)) &&
                        ((h * sign[e]) >= 0.0f);
    tc = better ? tq : tc;
  }

  if (degen) {
    tc = sphere_t(r, p1x, p1y, p1z, ra);
  }
  return tc;
}

// Moller-Trumbore triangle with clip-plane rejection.
__device__ __forceinline__ float triangle_t(const Ray& r, const Clip& clip,
                                            float v0x, float v0y, float v0z,
                                            float v1x, float v1y, float v1z,
                                            float v2x, float v2y, float v2z) {
  const float e1x = v1x - v0x;
  const float e1y = v1y - v0y;
  const float e1z = v1z - v0z;
  const float e2x = v2x - v0x;
  const float e2y = v2y - v0y;
  const float e2z = v2z - v0z;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  bool okt = fabsf(det) >= 1e-6f;
  const float inv = 1.0f / (okt ? det : 1.0f);
  const float tvx = r.ox - v0x;
  const float tvy = r.oy - v0y;
  const float tvz = r.oz - v0z;
  const float u = (tvx * px + tvy * py + tvz * pz) * inv;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
  okt = okt && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (tt > r.tmin);
  tt = okt ? tt : -1.0f;
  if (clip.on) {
    const float hx = r.ox + r.dx * tt;
    const float hy = r.oy + r.dy * tt;
    const float hz = r.oz + r.dz * tt;
    const float s = hx * clip.nx + hy * clip.ny + hz * clip.nz - clip.off;
    tt = (s * clip.side > 0.0f) ? -1.0f : tt;
  }
  return tt;
}

// ---------------------------------------------------------------------------
// Warp-cooperative sweeps: a warp owns 32 rays, one per lane, and sweeps a
// cluster for one of them at a time, each lane testing primitives lane,
// lane+32, lane+64, lane+96 of the cluster.

constexpr int kWarp = 32;
constexpr int kSteps = kLanes / kWarp;    // primitives per lane and cluster
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMixed = -1;                // cluster type of a mixed cluster

// Call f(std::integral_constant<int, T>) for the cluster type ct (kSphere,
// kCylinder, kTriangle or kMixed), so that f compiles its sweep for that
// type; any other value calls nothing.
template <class F>
__device__ __forceinline__ void by_type(int ct, F&& f) {
  switch (ct) {
    case kSphere:
      f(std::integral_constant<int, kSphere>{});
      break;
    case kCylinder:
      f(std::integral_constant<int, kCylinder>{});
      break;
    case kTriangle:
      f(std::integral_constant<int, kTriangle>{});
      break;
    case kMixed:
      f(std::integral_constant<int, kMixed>{});
      break;
    default:
      break;
  }
}

// Whether the primitive test of a cluster of this type reads SoA row i.
__host__ __device__ constexpr bool uses_row(int type, int i) {
  return type == kSphere     ? i < 4
         : type == kCylinder ? i < 7
         : type == kTriangle ? (i < 11 && i != 3 && i != 7)
                             : true;
}

// Candidate t of one primitive held in registers (p[i] = its row i), for a
// cluster of type T (kMixed: each primitive's own type from row 11; a
// type that is none of the three never hits).
template <int T>
__device__ __forceinline__ float prim_t_regs(const float (&p)[kRows], const Ray& r,
                                             const Clip& clip) {
  if constexpr (T == kSphere) {
    return sphere_t(r, p[0], p[1], p[2], p[3]);
  } else if constexpr (T == kCylinder) {
    return cylinder_t(r, p[0], p[1], p[2], p[3], p[4], p[5], p[6]);
  } else if constexpr (T == kTriangle) {
    return triangle_t(r, clip, p[0], p[1], p[2], p[4], p[5], p[6], p[8], p[9], p[10]);
  } else {
    const int type = static_cast<int>(p[11]);
    if (type == kSphere) {
      return prim_t_regs<kSphere>(p, r, clip);
    }
    if (type == kCylinder) {
      return prim_t_regs<kCylinder>(p, r, clip);
    }
    if (type == kTriangle) {
      return prim_t_regs<kTriangle>(p, r, clip);
    }
    return -1.0f;
  }
}

// Load the rows a type-T test reads of primitive j of a cluster (rows: its
// [kRows][kLanes] SoA block in global memory) through the read-only path.
template <int T>
__device__ __forceinline__ void load_prim(float (&p)[kRows], const float* __restrict__ rows,
                                          int j) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    p[i] = uses_row(T, i) ? __ldg(rows + i * kLanes + j) : 0.0f;
  }
}

// This lane's kSteps primitives of a cluster: lane + kWarp * q. A warp's
// load of one row is 128 contiguous bytes.
template <int T>
__device__ __forceinline__ void load_lane_prims(float (&p)[kSteps][kRows],
                                                const float* __restrict__ rows, int lane) {
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    load_prim<T>(p[q], rows, lane + kWarp * q);
  }
}

// The warp's lexicographic minimum (kmin, imin) of the lanes' (key, idx)
// pairs, on every lane: the least key, then the least idx among the lanes
// holding it.
__device__ __forceinline__ void warp_min_pair(unsigned key, unsigned idx, unsigned& kmin,
                                              unsigned& imin) {
  kmin = __reduce_min_sync(kFullMask, key);
  imin = __reduce_min_sync(kFullMask, key == kmin ? idx : ~0u);
}

// Ray r of lane src, on every lane.
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray b;
  b.dx = __shfl_sync(kFullMask, r.dx, src);
  b.dy = __shfl_sync(kFullMask, r.dy, src);
  b.dz = __shfl_sync(kFullMask, r.dz, src);
  b.ox = __shfl_sync(kFullMask, r.ox, src);
  b.oy = __shfl_sync(kFullMask, r.oy, src);
  b.oz = __shfl_sync(kFullMask, r.oz, src);
  b.tmin = __shfl_sync(kFullMask, r.tmin, src);
  return b;
}

// ---------------------------------------------------------------------------
// The closest-hit walk of trace_closest.cu and trace_closest_attrs.cu:
// both kernels call closest_walk, so their t and winning row agree by
// construction.

// Sweep cluster c (type T, rows: its SoA block) for the warp's rays in
// `need`; each such ray keeps the lexicographic (t, row) minimum over the
// primitives with 0 < t < best where one exists. The cluster's primitives
// are loaded into registers once for all the rays that need them; for each
// ray, broadcast with its best t, every lane keeps the strict-< minimum
// over its four primitives in increasing row, and two __reduce_min_sync
// take the warp's (t, row) minimum (the lowest row among equal t).
template <int T>
__device__ __forceinline__ void closest_cluster(const float* __restrict__ rows, int c,
                                                int lane, unsigned need, const Ray& r,
                                                const Clip& clip, float& best,
                                                int& best_row) {
  float p[kSteps][kRows];
  load_lane_prims<T>(p, rows, lane);
  while (need != 0u) {
    const int src = __ffs(need) - 1;
    need &= need - 1u;
    const Ray b = shfl_ray(r, src);
    const float cap = __shfl_sync(kFullMask, best, src);
    float t = INFINITY;
    int j = kLanes;
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const float ts = prim_t_regs<T>(p[q], b, clip);
      if (ts > 0.0f && ts < cap && ts < t) {
        t = ts;
        j = lane + kWarp * q;
      }
    }
    // t > 0, so its bit pattern orders as its value does (INFINITY: no
    // candidate).
    unsigned tw, jw;
    warp_min_pair(__float_as_uint(t), static_cast<unsigned>(j), tw, jw);
    if (lane == src && __uint_as_float(tw) < best) {
      best = __uint_as_float(tw);
      best_row = c * kLanes + static_cast<int>(jw);
    }
  }
}

// Closest hit of ray i (od f32[8,n], load_ray's layout), the warp's 32
// rays together; every lane of the warp calls it, lanes past n included.
// A ray that is inactive or misses the root AABB (cp[8..13]) is a miss.
// The warp walks the clusters in index order; each lane asks whether its
// ray enters the cluster's AABB before its best t, __ballot_sync gathers
// the need mask, a cluster no lane needs costs one slab test, and a needed
// one is swept by closest_cluster. So a ray takes the lexicographic
// minimum of (t, row) over the primitives of each cluster it needs, in
// index order: closest_plain's t and row. Returns best t (kBig on a miss)
// and sets best_row (-1 on a miss). kCost: also add to *swept the clusters
// this lane's ray needed (its own bit of each need mask: the count of
// ops/trace.py); without it the counter is not compiled in.
template <bool kCost = false>
__device__ __forceinline__ float closest_walk(const float* __restrict__ od, long long n,
                                              long long i, int lane,
                                              const float* __restrict__ soa,
                                              const float* __restrict__ box,
                                              const int* __restrict__ ct, int k,
                                              const float* __restrict__ cp, int clip_on,
                                              int& best_row, int* swept = nullptr) {
  Ray r;
  bool act = load_ray(od, n, i, r);
  const SlabRay sr = slab_ray(r);
  // Root gate: missing the scene box implies missing every cluster box.
  act = act && slab_entry(cp + 8, sr) < INFINITY;
  const Clip clip = load_clip(cp, clip_on);

  float best = kBig;
  best_row = -1;
  if (__any_sync(kFullMask, act)) {
    for (int c = 0; c < k; ++c) {
      const bool want = act && slab_entry(box + 6 * c, sr) < best;
      const unsigned need = __ballot_sync(kFullMask, want);
      if constexpr (kCost) {
        *swept += want ? 1 : 0;
      }
      if (need == 0u) {
        continue;
      }
      const float* rows = soa + static_cast<long long>(c) * kClusterFloats;
      by_type(ct[c], [&](auto type) {
        closest_cluster<decltype(type)::value>(rows, c, lane, need, r, clip, best, best_row);
      });
    }
  }
  if (!(best < kBig)) {
    best_row = -1;
  }
  return best;
}

// ---------------------------------------------------------------------------
// The warp sweeps of one broadcast ray (the per-ray kernels, and the
// ray-major schedules of trace_any3.cu and trace_any.cu): every lane calls
// them with the same ray b, and each lane tests primitives lane, lane+32,
// lane+64, lane+96.

// Whether a primitive of cluster rows (type T) is hit by b with
// lo < t < hi, each lane loading its own primitive of each step: the sweep
// ends after the 32-primitive step that holds the first hit.
template <int T>
__device__ __forceinline__ bool any_sweep(const float* __restrict__ rows, int lane,
                                          const Ray& b, float lo, float hi,
                                          const Clip& clip) {
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    float p[kRows];
    load_prim<T>(p, rows, lane + kWarp * q);
    const float ts = prim_t_regs<T>(p, b, clip);
    if (__any_sync(kFullMask, ts > lo && ts < hi)) {
      return true;
    }
  }
  return false;
}

// any_sweep of cluster c, dispatched on its type ct[c].
__device__ __forceinline__ bool any_sweep_cluster(const float* __restrict__ soa,
                                                  const int* __restrict__ ct, int c,
                                                  int lane, const Ray& b, float lo,
                                                  float hi, const Clip& clip) {
  const float* rows = soa + static_cast<long long>(c) * kClusterFloats;
  bool hit = false;
  by_type(ct[c], [&](auto type) {
    hit = any_sweep<decltype(type)::value>(rows, lane, b, lo, hi, clip);
  });
  return hit;
}

// The ray-major occlusion walk: whether b is hit with lo < t < hi in a
// cluster whose AABB it enters before box_cap. The lanes test 32 cluster
// AABBs of b at once (its reciprocal direction computed once), and the
// warp sweeps the clusters entered, in index order, until one occludes b.
// At K = 128 that is about K/32 slab tests a lane and ray, where the
// cluster-major schedules test every cluster box for every pending ray.
// kCost: also add to *swept, on every lane, the clusters swept for b.
template <bool kCost = false>
__device__ __forceinline__ bool any_raymajor(const float* __restrict__ soa,
                                             const float* __restrict__ box,
                                             const int* __restrict__ ct, int k, int lane,
                                             const Ray& b, float lo, float hi,
                                             float box_cap, const Clip& clip,
                                             int* swept = nullptr) {
  const SlabRay bs = slab_ray(b);
  for (int c0 = 0; c0 < k; c0 += kWarp) {
    const int c = c0 + lane;
    unsigned cm = __ballot_sync(kFullMask, c < k && slab_entry(box + 6 * c, bs) < box_cap);
    while (cm != 0u) {
      const int cc = c0 + __ffs(cm) - 1;
      cm &= cm - 1u;
      if constexpr (kCost) {
        ++*swept;
      }
      if (any_sweep_cluster(soa, ct, cc, lane, b, lo, hi, clip)) {
        return true;
      }
    }
  }
  return false;
}

// Sweep cluster c (type T, rows: its SoA block) for b: (best, best_row),
// the same on every lane, become the lexicographic (t, row) minimum of
// themselves and the cluster's primitives with t > 0. A per-ray walk
// visits clusters out of index order, so an equal t in a lower row found
// later must still win: the lanes keep candidates with t <= best, and the
// update is lexicographic (closest_cluster's `t < cap` and `t < best` are
// right only for visits in index order).
template <int T>
__device__ __forceinline__ void closest_sweep_perray(const float* __restrict__ rows, int c,
                                                     int lane, const Ray& b,
                                                     const Clip& clip, float& best,
                                                     int& best_row) {
  float p[kSteps][kRows];
  load_lane_prims<T>(p, rows, lane);
  float t = INFINITY;
  int j = kLanes;
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const float ts = prim_t_regs<T>(p[q], b, clip);
    if (ts > 0.0f && ts <= best && ts < t) {
      t = ts;
      j = lane + kWarp * q;
    }
  }
  // t > 0, so its bit pattern orders as its value does (INFINITY: none).
  unsigned tw, jw;
  warp_min_pair(__float_as_uint(t), static_cast<unsigned>(j), tw, jw);
  const float tb = __uint_as_float(tw);
  const int row = c * kLanes + static_cast<int>(jw);
  if (tb < best || (tb == best && row < best_row)) {
    best = tb;
    best_row = row;
  }
}

// ---------------------------------------------------------------------------
// The per-ray warp walk of trace_closest_perray.cu and trace_any_perray.cu.

static_assert(kGroup == kSteps * kWarp, "a lane holds kSteps cluster entries of a group");

// An entry as the key of an unsigned warp reduction. Entries are +0.0 or
// more, or +inf, and such floats order as their bit patterns do; but for a
// ray whose origin lies on a box plane slab_entry's fmaxf(-0.0, 0.0) may
// give -0.0 (IEEE leaves the sign open), whose bits sort after +inf. Adding
// +0.0 turns -0.0 into +0.0 and leaves every other value as it is.
__device__ __forceinline__ unsigned entry_key(float e) { return __float_as_uint(e + 0.0f); }

// Visit the clusters that ray s enters before cap(), front to back, with
// the whole warp: every lane calls it with the same ray, cap and visit.
// The groups of kGroup clusters (boxes gbox[0..ng)) are popped in order of
// the ray's entry into them, the lowest group first among equal entries:
// at each pop lane q tests groups q, q+32, ... (one box a lane up to 32
// groups) for the nearest after the last one popped, and the walk ends at
// a group entered at or beyond cap(). Inside a group lane j holds the
// entries of clusters j, j+32, j+64, j+96 that lie before cap() at the
// group's start, and the warp pops the nearest, the lowest cluster first
// among equal entries, while it lies before cap(). cap() is read at every
// pop, so a closest hit that shrinks it prunes the rest. visit(c) returns
// true to end the walk (an occluder found). ops/trace.py _perray_walk is
// this walk in plain PyTorch; the per-ray kernels count the clusters they
// visit (compiled in by their kCost), so the walk itself has no counter.
template <class Cap, class Visit>
__device__ __forceinline__ void perray_walk(const float* __restrict__ box,
                                            const float* __restrict__ gbox, int ng, int k,
                                            const SlabRay& s, int lane, Cap cap,
                                            Visit visit) {
  float last_e = -INFINITY;
  int last_g = -1;
  for (;;) {
    float ge = INFINITY;
    int g = -1;
    for (int q = lane; q < ng; q += kWarp) {
      const float e = slab_entry(gbox + 6 * q, s);
      const bool after = e > last_e || (e == last_e && q > last_g);
      if (after && e < ge) {
        ge = e;
        g = q;
      }
    }
    unsigned gk, gq;
    warp_min_pair(entry_key(ge), static_cast<unsigned>(g), gk, gq);
    last_e = __uint_as_float(gk);
    if (!(last_e < cap())) {
      return;
    }
    last_g = static_cast<int>(gq);

    const int c0 = last_g * kGroup;
    const int m = min(kGroup, k - c0);
    const float limit = cap();
    float ev[kSteps];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int j = lane + kWarp * q;
      const float e = j < m ? slab_entry(box + 6 * (c0 + j), s) : INFINITY;
      ev[q] = e < limit ? e + 0.0f : INFINITY;
    }
    for (;;) {
      float e = INFINITY;
      int j = -1;
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        if (ev[q] < e) {
          e = ev[q];
          j = lane + kWarp * q;
        }
      }
      unsigned ek, jm;
      warp_min_pair(entry_key(e), static_cast<unsigned>(j), ek, jm);
      if (!(__uint_as_float(ek) < cap())) {
        break;
      }
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        ev[q] = lane + kWarp * q == static_cast<int>(jm) ? INFINITY : ev[q];
      }
      if (visit(c0 + static_cast<int>(jm))) {
        return;
      }
    }
  }
}

}  // namespace wrt
