// The bounce step's per-lane shading: the arithmetic of
// render/integrator.py _make_bounce_step between its traces, one lane at
// a time. csrc/shade.cu launches it as two kernels around the occlusion
// queries: shade_surface_lane (the miss radiance, the surface, glass and
// translucent transmission, the cone-light samples and the env NEE
// direction) and shade_scatter_lane (direct light, rim, env NEE, the BRDF
// sample and Russian roulette).
//
// Every expression is the plain step's, in its operation order and with
// float literals, built -fmad=false with IEEE sqrtf and division, so that
// a product and a sum round as the plain step's separate tensor ops do.
// What ATen does on the card and the port therefore repeats:
//   * `x / c` of a tensor by a Python number is x * (1 / c), the
//     reciprocal rounded first (div_true on a CPU scalar): div_host;
//   * `c / x` of a Python number by a tensor is reciprocal(x) * c
//     (Tensor.__rtruediv__): rdiv;
//   * clamp, clamp_min, maximum and minimum propagate NaN;
//   * pow(x, 3) is x * x * x, pow(x, 2) x * x, any other exponent powf;
//   * sqrt, cos, sin, acos, atan2 and floor are the CUDA maths library's,
//     as ATen's kernels call them.
// Values of one frame (the light cones, the glass constants) are computed
// per lane from the raw uniforms with the same operations; the light axes,
// which the plain step normalises with a tensor sum, come from
// ops/shade.py.
//
// A lane draws the PCG stream in the plain step's order: glass (4 draws,
// material modes 2 and 3), two per enabled cone light, two for env NEE,
// three for the BRDF lobe and one for roulette from bounce 1. A lane that
// misses, or transmits, still draws them all, as the plain step advances
// every lane's seed.

#ifndef WRT_SHADE_CUH
#define WRT_SHADE_CUH

#include <math.h>

namespace shade {

// Primitive types (scene/bvh.py).
constexpr int kTriangle = 0;
constexpr int kSphere = 1;
constexpr int kCylinder = 2;

// Configuration bits (ops/shade.py config_bits).
constexpr int kUseEnv = 1 << 0;
constexpr int kImportedColor = 1 << 1;
constexpr int kTriFlags = 1 << 2;     // surface_flag_mode != 0 on a scene with triangles
constexpr int kRowsByLane = 1 << 3;   // rows are the attrs kernel's, one a lane
constexpr int kShadows = 1 << 4;
constexpr int kRim = 1 << 5;
constexpr int kHasSphere = 1 << 8;
constexpr int kHasCylinder = 1 << 9;
constexpr int kHasTriangle = 1 << 10;
constexpr int kLight0 = 1 << 12;      // light i enabled: kLight0 << i

// Lane codes between the kernels (shade_surface writes, shade_scatter reads).
constexpr unsigned char kDone = 0;       // dead on entry, or a miss: finished
constexpr unsigned char kShadeLane = 1;  // a hit that is shaded
constexpr unsigned char kTransmit = 2;   // a hit that transmits (glass)

// Rows of the work buffer f32[kWorkRows, n] (ops/shade.py WORK_ROWS).
constexpr int kShadowOrigin = 0;   // 3 rows
constexpr int kFanDir = 3;         // 3 x 3 rows, light j at 3 + 3 j
constexpr int kEnvDir = 12;        // 3 rows
constexpr int kEnvPdf = 15;
constexpr int kShadingNormal = 16; // 3 rows
constexpr int kBaseColor = 19;     // 3 rows
constexpr int kWorkRows = 22;
// Rows of the lane buffer u8[kLaneRowsCount, n]: the three fan masks, the
// env NEE mask, the lane code.
constexpr int kEnvMask = 3;
constexpr int kCode = 4;
constexpr int kLaneRowsCount = 5;
// Rows of the state buffer f32[10, n]: origin, direction, throughput,
// last pdf.
constexpr int kOrigin = 0, kDirection = 3, kThroughput = 6, kLastPdf = 9;

// Params f32[kParams] (ops/shade.py PARAM_FIELDS).
constexpr int kParams = 44;

constexpr float kPi = 3.14159274101257324f;       // float32(pi), ops/sampling.PI
constexpr float kTwoPi = 6.28318548202514648f;    // float32(2 pi)
constexpr float kNeeClamp = 20.0f;
constexpr float kThroughputClamp = 10.0f;
// Python constants that reach ATen as float scalars.
constexpr float kInvPiPy = static_cast<float>(1.0 / 3.14159274101257324);  // 1.0 / PI
constexpr float kTwoPiPiPy = static_cast<float>(2.0 * 3.14159274101257324 *
                                                3.14159274101257324);      // 2.0 * PI * PI
constexpr float kInvU32Max = static_cast<float>(1.0 / 4294967295.0);

// ---------------------------------------------------------------------------
// ATen's elementwise semantics.

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return is_nan(v) ? v : ::fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return is_nan(v) ? v : ::fminf(::fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : ::fmaxf(a, b));
}

__device__ __forceinline__ float minimum(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : ::fminf(a, b));
}

// x / c, c a Python number: x times the float reciprocal of c.
__device__ __forceinline__ float div_host(float x, float c) { return x * (1.0f / c); }

// c / x, c a Python number: reciprocal(x) * c.
__device__ __forceinline__ float rdiv(float c, float x) { return (1.0f / x) * c; }

__device__ __forceinline__ long long clamp_i(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// Vectors (ops/vec3.py).

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ float max_component(V3 a) {
  return maximum(a.x, maximum(a.y, a.z));
}
__device__ __forceinline__ V3 normalize(V3 a) {
  const float inv = rdiv(1.0f, clamp_min(sqrtf(dot(a, a)), 1e-12f));
  return scale(a, inv);
}
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  const float k = 2.0f * dot(d, n);
  return v3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z);
}
__device__ __forceinline__ float pow3(float b) { return b * b * b; }

// ---------------------------------------------------------------------------
// The PCG stream (ops/rng.py), a uint32 state.

__device__ __forceinline__ float rand(unsigned int& s) {
  s = s * 747796405u + 2891336453u;
  unsigned int word = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
  word = (word >> 22) ^ word;
  return static_cast<float>(word) * kInvU32Max;
}

__device__ __forceinline__ void skip(unsigned int& s, int draws) {
  for (int k = 0; k < draws; ++k) s = s * 747796405u + 2891336453u;
}

// ---------------------------------------------------------------------------
// Sampling (ops/sampling.py) and BRDF terms (ops/brdf.py).

__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float a2 = a * a;
  const float b2 = b * b;
  return a2 / clamp_min(a2 + b2, 1e-8f);
}

__device__ __forceinline__ V3 to_world(V3 axis, float lx, float ly, float lz) {
  const bool use_z = fabsf(axis.z) < 0.999f;
  const V3 up = v3(use_z ? 0.0f : 1.0f, 0.0f, use_z ? 1.0f : 0.0f);
  const V3 t = normalize(cross(up, axis));
  const V3 b = cross(axis, t);
  return normalize(v3(t.x * lx + b.x * ly + axis.x * lz, t.y * lx + b.y * ly + axis.y * lz,
                      t.z * lx + b.z * ly + axis.z * lz));
}

__device__ __forceinline__ V3 cone_dir(V3 axis, float cos_max, float r1, float r2) {
  const float cos_t = cos_max + (1.0f - cos_max) * r1;
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  const float phi = kTwoPi * r2;
  return to_world(axis, cosf(phi) * sin_t, sinf(phi) * sin_t, cos_t);
}

__device__ __forceinline__ V3 cosine_hemisphere(V3 n, float r1, float r2) {
  const float phi = kTwoPi * r1;
  const float cos_t = sqrtf(1.0f - r2);
  const float sin_t = sqrtf(r2);
  return to_world(n, cosf(phi) * sin_t, sinf(phi) * sin_t, cos_t);
}

__device__ __forceinline__ V3 ggx_half_vector(V3 n, float rough, float r1, float r2) {
  const float a = rough * rough;
  const float a2 = a * a;
  const float phi = kTwoPi * r1;
  const float cos_t = sqrtf((1.0f - r2) / (1.0f + (a2 - 1.0f) * r2));
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  return to_world(n, cosf(phi) * sin_t, sinf(phi) * sin_t, cos_t);
}

__device__ __forceinline__ float fresnel_w(float cos_theta) {
  return powf(clamp(1.0f - cos_theta, 0.0f, 1.0f), 5.0f);
}

__device__ __forceinline__ V3 fresnel_v3(float cos_theta, V3 f0) {
  const float w = fresnel_w(cos_theta);
  return v3(f0.x + (1.0f - f0.x) * w, f0.y + (1.0f - f0.y) * w, f0.z + (1.0f - f0.z) * w);
}

__device__ __forceinline__ float distribution_ggx(float ndh, float rough) {
  const float a = rough * rough;
  const float a2 = a * a;
  const float denom = (ndh * ndh) * (a2 - 1.0f) + 1.0f;
  return a2 / (kPi * denom * denom + 1e-6f);
}

__device__ __forceinline__ float geometry_schlick_ggx(float ndv, float rough) {
  const float r = rough + 1.0f;
  const float k = div_host(r * r, 8.0f);
  return ndv / (ndv * (1.0f - k) + k + 0.0001f);
}

__device__ __forceinline__ float geometry_smith(float ndv, float ndl, float rough) {
  return geometry_schlick_ggx(ndv, rough) * geometry_schlick_ggx(ndl, rough);
}

// Lambert or Oren-Nayar times the wrap-lighting scale (eval_diffuse_brdf_v3).
__device__ __forceinline__ V3 eval_diffuse(V3 n, V3 v, V3 l, V3 base, float diff_rough,
                                           float wrap) {
  V3 brdf;
  if (diff_rough > 1e-4f) {
    const float ndl = clamp_min(dot(n, l), 0.0f);
    const float ndv = clamp_min(dot(n, v), 0.0f);
    const float sigma2 = diff_rough * diff_rough;
    const float a = 1.0f - 0.5f * (sigma2 / (sigma2 + 0.33f));
    const float b = 0.45f * (sigma2 / (sigma2 + 0.09f));
    const float sin_l = sqrtf(clamp_min(1.0f - ndl * ndl, 0.0f));
    const float sin_v = sqrtf(clamp_min(1.0f - ndv * ndv, 0.0f));
    const float tan_l = sin_l / clamp_min(ndl, 1e-4f);
    const float tan_v = sin_v / clamp_min(ndv, 1e-4f);
    const float sin_alpha = maximum(sin_l, sin_v);
    const float tan_beta = minimum(tan_l, tan_v);
    const V3 lp = normalize(sub(l, scale(n, ndl)));
    const V3 vp = normalize(sub(v, scale(n, ndv)));
    const float cos_phi = clamp_min(dot(lp, vp), 0.0f);
    const float oren = div_host(a + b * cos_phi * sin_alpha * tan_beta, kPi);
    const bool lit = (ndl > 0.0f) && (ndv > 0.0f);
    brdf = scale(base, lit ? oren : 0.0f);
  } else {
    brdf = scale(base, kInvPiPy);
  }
  if (!(wrap > 0.0f)) return scale(brdf, 1.0f);
  const float ndl = clamp_min(dot(n, l), 0.0f);
  const float wrapped = clamp((ndl + wrap) / (1.0f + wrap), 0.0f, 1.0f);
  const float s = ndl > 1e-4f ? wrapped / clamp_min(ndl, 1e-4f) : 0.0f;
  return scale(brdf, s);
}

__device__ __forceinline__ float spec_probability(V3 f0, V3 base, float metallic) {
  const float spec_w = max_component(f0);
  const float diff_w = (1.0f - metallic) * max_component(base);
  const float s = spec_w + diff_w;
  return s > 0.0f ? spec_w / clamp_min(s, 1e-12f) : 0.5f;
}

__device__ __forceinline__ float brdf_pdf(V3 n, V3 v, V3 l, float rough, float spec_prob) {
  const float ndl = clamp_min(dot(n, l), 0.0f);
  const float diff_pdf = div_host(ndl, kPi);
  const V3 h = normalize(add(v, l));
  const float ndh = clamp_min(dot(n, h), 0.001f);
  const float vdh = clamp_min(dot(v, h), 0.001f);
  const float d = distribution_ggx(ndh, rough);
  const float spec_pdf = d * ndh / (4.0f * vdh);
  const float pdf = spec_prob * spec_pdf + (1.0f - spec_prob) * diff_pdf;
  return ndl > 0.0f ? pdf : 0.0f;
}

// The BRDF times n.l's light weight of one direction l: spec + diffuse
// (1 - F) (the direct-light and env-NEE terms of the plain step).
__device__ __forceinline__ V3 brdf_value(V3 sn, V3 v, V3 l, float rough, V3 f0, V3 base,
                                         float metallic, float diff_rough, float wrap) {
  const V3 h = normalize(add(v, l));
  const float ndv = clamp_min(dot(sn, v), 0.001f);
  const float ndl = clamp_min(dot(sn, l), 0.0f);
  const float ndh = clamp_min(dot(sn, h), 0.001f);
  const float vdh = clamp_min(dot(v, h), 0.001f);
  const float d = distribution_ggx(ndh, rough);
  const float g = geometry_smith(ndv, ndl, rough);
  const V3 f = fresnel_v3(vdh, f0);
  const float k = (d * g) / clamp_min(4.0f * ndv * ndl, 0.001f);
  const V3 spec = scale(f, k);
  const V3 diff = scale(eval_diffuse(sn, v, l, base, diff_rough, wrap), 1.0f - metallic);
  const V3 one_minus_f = v3(1.0f - f.x, 1.0f - f.y, 1.0f - f.z);
  return add(spec, mul(diff, one_minus_f));
}

// ---------------------------------------------------------------------------
// The environment (ops/envmap.py).

struct Env {
  const float* radiance;      // f32[h, w, 3]
  const float* marginal;      // f32[h + 1]
  const float* conditional;   // f32[h, w + 1]
  int w, h;
  int trips_v, trips_u;       // ceil(log2(size)) of the two bisections
};

__device__ __forceinline__ void dir_to_uv(V3 d, float& u, float& v) {
  u = div_host(atan2f(d.z, d.x), kTwoPi) + 0.5f;
  v = div_host(acosf(clamp(d.y, -1.0f, 1.0f)), kPi);
}

__device__ __forceinline__ V3 env_radiance(const Env& e, V3 d, float intensity,
                                           float max_lum) {
  float u, v;
  dir_to_uv(d, u, v);
  const float x = u * static_cast<float>(e.w) - 0.5f;
  const float y = v * static_cast<float>(e.h) - 0.5f;
  const float flx = floorf(x), fly = floorf(y);
  const long long x0 = clamp_i(static_cast<long long>(flx), 0, e.w - 1);
  const long long y0 = clamp_i(static_cast<long long>(fly), 0, e.h - 1);
  const long long x1 = clamp_i(x0 + 1, 0, e.w - 1);
  const long long y1 = clamp_i(y0 + 1, 0, e.h - 1);
  const float fx = clamp(x - flx, 0.0f, 1.0f);
  const float fy = clamp(y - fly, 0.0f, 1.0f);
  const float* p00 = e.radiance + (y0 * e.w + x0) * 3;
  const float* p10 = e.radiance + (y0 * e.w + x1) * 3;
  const float* p01 = e.radiance + (y1 * e.w + x0) * 3;
  const float* p11 = e.radiance + (y1 * e.w + x1) * 3;
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  float out[3];
  for (int c = 0; c < 3; ++c) {
    const float val = __ldg(p00 + c) * w00 + __ldg(p10 + c) * w10 + __ldg(p01 + c) * w01 +
                      __ldg(p11 + c) * w11;
    out[c] = val * intensity;
  }
  const float lum = out[0] * 0.2126f + out[1] * 0.7152f + out[2] * 0.0722f;
  const float excess = lum - max_lum;
  const float compressed = max_lum + excess / (1.0f + excess / clamp_min(max_lum, 1e-12f));
  const float s = ((max_lum > 0.0f) && (lum > max_lum))
                      ? compressed / clamp_min(lum, 1e-12f) : 1.0f;
  return v3(out[0] * s, out[1] * s, out[2] * s);
}

__device__ __forceinline__ float env_pdf(const Env& e, V3 d) {
  float u, v;
  dir_to_uv(d, u, v);
  const long long ui = clamp_i(static_cast<long long>(u * static_cast<float>(e.w)), 0,
                               e.w - 1);
  const long long vi = clamp_i(static_cast<long long>(v * static_cast<float>(e.h)), 0,
                               e.h - 1);
  const float marginal_pdf = __ldg(e.marginal + vi + 1) - __ldg(e.marginal + vi);
  const float* row = e.conditional + vi * (e.w + 1);
  const float cond_pdf = __ldg(row + ui + 1) - __ldg(row + ui);
  const float pdf_uv = marginal_pdf * static_cast<float>(e.h) * cond_pdf *
                       static_cast<float>(e.w);
  const float theta = v * kPi;
  const float sin_t = clamp_min(sinf(theta), 1e-4f);
  return clamp_min(pdf_uv / (kTwoPiPiPy * sin_t), 1e-6f);
}

// _bisect_cdf: (idx, idx + in-bucket fraction) over cdf[0, size).
__device__ __forceinline__ float bisect_cdf(const float* cdf, int size, int trips, float xi,
                                            long long& idx) {
  long long lo = 0, hi = size - 1;
  for (int k = 0; k < trips; ++k) {
    const bool cont = lo < hi;
    const long long mid = (lo + hi) / 2;
    const bool go_right = cont && (__ldg(cdf + mid) <= xi);
    lo = go_right ? mid + 1 : lo;
    hi = (cont && !go_right) ? mid : hi;
  }
  idx = lo - 1 < 0 ? 0 : lo - 1;
  const float c_lo = __ldg(cdf + idx);
  const float c_hi = __ldg(cdf + idx + 1);
  const float t = c_hi > c_lo ? clamp((xi - c_lo) / (c_hi - c_lo), 0.0f, 1.0f) : 0.0f;
  return static_cast<float>(idx) + t;
}

// sample_env_direction_v3: direction and solid-angle pdf; two draws.
__device__ __forceinline__ V3 sample_env_direction(const Env& e, unsigned int& s,
                                                   float& pdf) {
  const float r1 = rand(s);
  const float r2 = rand(s);
  long long vraw, unused;
  const float v_float = bisect_cdf(e.marginal, e.h + 1, e.trips_v, r1, vraw);
  const long long vi = clamp_i(vraw, 0, e.h - 1);
  const float v = div_host(v_float + 0.5f, static_cast<float>(e.h));
  const float* row = e.conditional + vi * (e.w + 1);
  const float u_float = bisect_cdf(row, e.w + 1, e.trips_u, r2, unused);
  const float u = div_host(u_float + 0.5f, static_cast<float>(e.w));
  const float theta = v * kPi;
  const float phi = u * kTwoPi - kPi;
  const float sin_t = sinf(theta);
  const V3 d = v3(sin_t * cosf(phi), cosf(theta), sin_t * sinf(phi));
  const float marginal_pdf = __ldg(e.marginal + vi + 1) - __ldg(e.marginal + vi);
  const long long u_bin = static_cast<long long>(u_float);
  const float cond_pdf = __ldg(row + clamp_i(u_bin + 1, 0, e.w)) -
                         __ldg(row + clamp_i(u_bin, 0, e.w));
  const float pdf_uv = marginal_pdf * static_cast<float>(e.h) * cond_pdf *
                       static_cast<float>(e.w);
  pdf = clamp_min(pdf_uv / (kTwoPiPiPy * clamp_min(sin_t, 1e-4f)), 1e-6f);
  return d;
}

// ---------------------------------------------------------------------------
// Operands.

// A ray operand: a row of n floats (step 1) or one float for every lane
// (step 0).
struct Col {
  const float* p;
  int step;
  __device__ __forceinline__ float at(long long i) const { return __ldg(p + i * step); }
};

// The uniforms of one frame (params f32[kParams], ops/shade.py PARAM_FIELDS).
struct Params {
  V3 base;
  float metallic, roughness, rim_boost, matte_specular, matte_roughness, matte_diff_rough,
      wrap, ior, transmission, opacity, amb_intensity;
  V3 amb_color;
  float env_intensity, env_max_lum, ray_bias;
  V3 axis[3], lcolor[3];
  float lintensity[3], langle[3];
};

__device__ __forceinline__ V3 load3(const float* p) {
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

__device__ __forceinline__ Params load_params(const float* p) {
  Params q;
  q.base = load3(p);
  q.metallic = __ldg(p + 3);
  q.roughness = __ldg(p + 4);
  q.rim_boost = __ldg(p + 5);
  q.matte_specular = __ldg(p + 6);
  q.matte_roughness = __ldg(p + 7);
  q.matte_diff_rough = __ldg(p + 8);
  q.wrap = __ldg(p + 9);
  q.ior = __ldg(p + 10);
  q.transmission = __ldg(p + 11);
  q.opacity = __ldg(p + 12);
  q.amb_intensity = __ldg(p + 13);
  q.amb_color = load3(p + 14);
  q.env_intensity = __ldg(p + 17);
  q.env_max_lum = __ldg(p + 18);
  q.ray_bias = __ldg(p + 19);
  for (int i = 0; i < 3; ++i) {
    q.axis[i] = load3(p + 20 + 3 * i);
    q.lcolor[i] = load3(p + 29 + 3 * i);
    q.lintensity[i] = __ldg(p + 38 + i);
    q.langle[i] = __ldg(p + 41 + i);
  }
  return q;
}

// _material_params of the material mode: metallic, roughness, diffuse
// roughness, wrap, and whether f0 is the matte specular.
struct Material {
  float metallic, rough, diff_rough, wrap;
  bool matte;
};

__device__ __forceinline__ Material material(const Params& q, int mode) {
  if (mode == 1) return Material{0.0f, q.matte_roughness, q.matte_diff_rough, q.wrap, true};
  return Material{mode == 0 ? q.metallic : 0.0f, q.roughness, 0.0f, 0.0f, false};
}

__device__ __forceinline__ V3 material_f0(const Params& q, const Material& m, V3 base) {
  if (m.matte) {
    const float f = q.matte_specular + 0.0f * base.x;
    return v3(f, f, f);
  }
  const float k = (1.0f - m.metallic) * 0.04f;
  return v3(k + base.x * m.metallic, k + base.y * m.metallic, k + base.z * m.metallic);
}

// Draws of a bounce (see the header).
__device__ __forceinline__ int surface_draws(int mode, int bits) {
  int n = (mode == 2 || mode == 3) ? 4 : 0;
  for (int i = 0; i < 3; ++i) n += (bits & (kLight0 << i)) ? 2 : 0;
  return n + ((bits & kUseEnv) ? 2 : 0);
}

__device__ __forceinline__ int scatter_draws(int bounce) { return bounce >= 1 ? 4 : 3; }

// throughput * tscale: the clamp of its largest component to 10.
__device__ __forceinline__ V3 clamp_throughput(V3 thr) {
  const float mx = max_component(thr);
  const float s = mx > kThroughputClamp ? rdiv(kThroughputClamp, clamp_min(mx, 1e-12f))
                                        : 1.0f;
  return scale(thr, s);
}

struct SurfaceArgs {
  long long n;
  int bounce, mode, bits;
  // The path state in.
  const long long* seed;            // uint32 values in int64
  Col o[3], d[3], thr[3], last_pdf;
  float* rad[3];                    // in place
  const unsigned char* alive;
  // The closest hits.
  const float* t;
  const int* ptype;
  const int* plocal;
  const int* pslot;
  const float* extra;               // f32[n, 3]
  // The primitives' rows: row index (slot, or the lane under kRowsByLane)
  // times row_stride; colour, triangle normals and flags likewise (the
  // triangle tables by the clamped local index unless kRowsByLane).
  const float* pa;
  const float* pb;
  const float* pc;
  int row_stride;
  const float* color;
  int color_stride;
  const float* tri_normals;
  int tri_normals_stride;
  const float* tri_flags;
  int tri_flags_stride;
  int tri_rows;
  Env env;
  const float* params;
  // Out.
  long long* seed_out;
  float* state_out;                 // f32[10, n]
  unsigned char* alive_out;
  float* work;                      // f32[kWorkRows, n]
  unsigned char* lanes;             // u8[kLaneRowsCount, n]
};

// shade_surface for lane i: everything of the bounce up to the occlusion
// queries.
__device__ __forceinline__ void shade_surface_lane(const SurfaceArgs& a, long long i) {
  const long long n = a.n;
  unsigned char* lanes = a.lanes;
  if (!a.alive[i]) {
    for (int j = 0; j < kLaneRowsCount; ++j) lanes[j * n + i] = 0;
    a.alive_out[i] = 0;
    return;
  }
  const Params q = load_params(a.params);
  const int mode = a.mode, bits = a.bits;
  unsigned int s = static_cast<unsigned int>(a.seed[i]);
  const V3 o = v3(a.o[0].at(i), a.o[1].at(i), a.o[2].at(i));
  const V3 d = v3(a.d[0].at(i), a.d[1].at(i), a.d[2].at(i));
  V3 thr = v3(a.thr[0].at(i), a.thr[1].at(i), a.thr[2].at(i));
  float last_pdf = a.last_pdf.at(i);
  const int ptype = a.ptype[i];
  float* st = a.state_out;

  if (ptype < 0) {
    // The miss: environment / ambient, MIS against BRDF sampling.
    const V3 amb = scale(q.amb_color, q.amb_intensity);
    V3 contrib = amb;
    float mis_w = 1.0f;
    if (bits & kUseEnv) {
      contrib = add(amb, env_radiance(a.env, d, q.env_intensity, q.env_max_lum));
      if (a.bounce > 0) {
        mis_w = last_pdf > 0.0f ? power_heuristic(last_pdf, env_pdf(a.env, d)) : 1.0f;
      }
    }
    const V3 add_rad = scale(mul(thr, contrib), mis_w);
    a.rad[0][i] = a.rad[0][i] + add_rad.x;
    a.rad[1][i] = a.rad[1][i] + add_rad.y;
    a.rad[2][i] = a.rad[2][i] + add_rad.z;
    // The rest of the bounce draws and clamps the throughput, nothing else.
    skip(s, surface_draws(mode, bits) + scatter_draws(a.bounce));
    thr = clamp_throughput(thr);
    a.seed_out[i] = static_cast<long long>(s);
    st[(kOrigin + 0) * n + i] = o.x;
    st[(kOrigin + 1) * n + i] = o.y;
    st[(kOrigin + 2) * n + i] = o.z;
    st[(kDirection + 0) * n + i] = d.x;
    st[(kDirection + 1) * n + i] = d.y;
    st[(kDirection + 2) * n + i] = d.z;
    st[(kThroughput + 0) * n + i] = thr.x;
    st[(kThroughput + 1) * n + i] = thr.y;
    st[(kThroughput + 2) * n + i] = thr.z;
    st[kLastPdf * n + i] = last_pdf;
    a.alive_out[i] = 0;
    for (int j = 0; j < kLaneRowsCount; ++j) lanes[j * n + i] = 0;
    return;
  }

  // --- surface reconstruction ---
  const float t = a.t[i];
  const V3 pos = add(o, scale(d, t));
  const bool lane_rows = (bits & kRowsByLane) != 0;
  const long long slot = a.pslot[i] < 0 ? 0 : a.pslot[i];
  const long long row = lane_rows ? i : slot;
  const float* ra = a.pa + row * a.row_stride;
  const float* rb = a.pb + row * a.row_stride;
  const float* rc = a.pc + row * a.row_stride;
  const V3 pa = load3(ra);
  V3 n_raw = v3(0.0f, 0.0f, 0.0f);
  V3 tri_shading = n_raw;
  long long tri = 0;
  if ((bits & kHasSphere) && ptype == kSphere) {
    n_raw = normalize(sub(pos, pa));
  }
  if ((bits & kHasCylinder) && ptype == kCylinder) {
    const V3 pb = load3(rb);
    const float hit_type = a.extra[i * 3];
    V3 axis = sub(pb, pa);
    axis = scale(axis, rdiv(1.0f, clamp_min(sqrtf(dot(axis, axis)), 1e-12f)));
    const float h = dot(sub(pos, pa), axis);
    const V3 side = sub(pos, add(pa, scale(axis, h)));
    n_raw = normalize(hit_type == 1.0f ? sub(pos, pa) : (hit_type == 2.0f ? sub(pos, pb)
                                                                          : side));
  }
  if ((bits & kHasTriangle) && ptype == kTriangle) {
    const V3 pb = load3(rb);
    const V3 pc = load3(rc);
    n_raw = normalize(cross(sub(pb, pa), sub(pc, pa)));
    const int local = a.plocal[i];
    tri = lane_rows ? i : clamp_i(local, 0, a.tri_rows - 1);
    const float* tn = a.tri_normals + tri * a.tri_normals_stride;
    const float bu = a.extra[i * 3];
    const float bv = a.extra[i * 3 + 1];
    const float b0 = 1.0f - bu - bv;
    tri_shading = normalize(v3(b0 * __ldg(tn + 0) + bu * __ldg(tn + 3) + bv * __ldg(tn + 6),
                               b0 * __ldg(tn + 1) + bu * __ldg(tn + 4) + bv * __ldg(tn + 7),
                               b0 * __ldg(tn + 2) + bu * __ldg(tn + 5) + bv * __ldg(tn + 8)));
  }
  const bool front = dot(n_raw, d) < 0.0f;
  const V3 n_geom = sel(front, n_raw, neg(n_raw));
  V3 sn = n_geom;
  if ((bits & kHasTriangle) && ptype == kTriangle) {
    const bool flip = dot(tri_shading, n_geom) < 0.0f;
    sn = sel(flip, neg(tri_shading), tri_shading);
  }
  const V3 base = (bits & kImportedColor)
                      ? load3(a.color + (lane_rows ? i : slot) * a.color_stride)
                      : q.base;
  const float bias = clamp_min(q.ray_bias, 1e-4f);

  // --- glass / translucent transmission ---
  bool transmit = false;
  V3 o_new = o, d_new = d;
  if (mode == 2 || mode == 3) {
    const float r_op = rand(s);
    bool glass_lane = true;
    if (mode == 2) {
      glass_lane = ptype == kTriangle;
      if (bits & kTriFlags) {
        glass_lane = glass_lane && (__ldg(a.tri_flags + tri * a.tri_flags_stride) > 0.5f);
      }
    }
    transmit = glass_lane && (r_op >= q.opacity);
    const float cosi = clamp(-dot(d, n_geom), 0.0f, 1.0f);
    const float qi = (q.ior - 1.0f) / (q.ior + 1.0f);
    const float f0s = qi * qi;
    const float fres = f0s + (1.0f - f0s) * fresnel_w(cosi);
    const float ior = clamp_min(q.ior, 1e-3f);
    const float eta = front ? rdiv(1.0f, ior) : ior;
    // refract_dir_v3
    const float cosr = clamp(-dot(d, n_geom), 0.0f, 1.0f);
    const float sin2 = eta * eta * (1.0f - cosr * cosr);
    const bool can_refract = sin2 <= 1.0f;
    const float cost = sqrtf(clamp_min(1.0f - sin2, 0.0f));
    const float kr = eta * cosr - cost;
    const V3 refr = v3(eta * d.x + kr * n_geom.x, eta * d.y + kr * n_geom.y,
                       eta * d.z + kr * n_geom.z);
    const float reflect_prob = can_refract ? fres : 1.0f;
    const float r_ref = rand(s);
    const float b1 = rand(s);
    const float b2 = rand(s);
    const bool do_reflect = r_ref < reflect_prob;
    if (transmit) {
      V3 new_dir;
      if (mode == 3) {
        const float trough = clamp(q.roughness, 0.02f, 1.0f);
        const bool smooth = trough <= 0.02f;
        if (do_reflect) {
          // reflect_from_uv_v3
          const V3 r = reflect(d, n_geom);
          const V3 rn = normalize(r);
          if (smooth) {
            new_dir = rn;
          } else {
            const float phi = kTwoPi * b1;
            const float cos_t = powf(1.0f - b2, rdiv(1.0f, trough * 4.0f + 1.0f));
            const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
            new_dir = to_world(rn, cosf(phi) * sin_t, sinf(phi) * sin_t, cos_t);
          }
        } else {
          // around_direction_from_uv_v3
          const V3 ax = normalize(refr);
          if (smooth) {
            new_dir = ax;
          } else {
            const float cone = clamp(trough * trough * 0.75f, 0.0f, 1.2f);
            new_dir = cone_dir(ax, cosf(cone), b1, b2);
          }
        }
      } else {
        new_dir = do_reflect ? normalize(reflect(d, n_geom)) : normalize(refr);
      }
      const V3 off = scale(n_geom, bias);
      o_new = do_reflect ? add(pos, off) : sub(pos, off);
      d_new = new_dir;
      if (!do_reflect) {
        const float tt = q.transmission;
        const float ts = 1.0f - tt;
        const V3 tint = v3(1.0f * ts + base.x * tt, 1.0f * ts + base.y * tt,
                           1.0f * ts + base.z * tt);
        thr = mul(thr, tint);
      }
      last_pdf = 0.0f;
    }
  }
  const bool shade_lane = !transmit;

  // --- the cone lights' samples (one fan query for all) ---
  const V3 shadow_origin = add(pos, scale(n_geom, bias));
  float* w = a.work;
  for (int j = 0; j < 3; ++j) {
    V3 ldir = v3(1.0f, 0.0f, 0.0f);
    bool candidate = false;
    if (bits & (kLight0 << j)) {
      const float l1 = rand(s);
      const float l2 = rand(s);
      ldir = cone_dir(q.axis[j], cosf(q.langle[j]), l1, l2);
      const float ndl = clamp_min(dot(sn, ldir), 0.0f);
      candidate = shade_lane && (ndl > 0.0f);
    }
    w[(kFanDir + 3 * j + 0) * n + i] = ldir.x;
    w[(kFanDir + 3 * j + 1) * n + i] = ldir.y;
    w[(kFanDir + 3 * j + 2) * n + i] = ldir.z;
    lanes[j * n + i] = candidate;
  }

  // --- env NEE's direction ---
  bool env_candidate = false;
  if (bits & kUseEnv) {
    float spdf;
    const V3 ed = sample_env_direction(a.env, s, spdf);
    env_candidate = shade_lane && (dot(sn, ed) > 0.0f);
    w[(kEnvDir + 0) * n + i] = ed.x;
    w[(kEnvDir + 1) * n + i] = ed.y;
    w[(kEnvDir + 2) * n + i] = ed.z;
    w[kEnvPdf * n + i] = spdf;
  }
  lanes[kEnvMask * n + i] = env_candidate;
  lanes[kCode * n + i] = transmit ? kTransmit : kShadeLane;

  w[(kShadowOrigin + 0) * n + i] = shadow_origin.x;
  w[(kShadowOrigin + 1) * n + i] = shadow_origin.y;
  w[(kShadowOrigin + 2) * n + i] = shadow_origin.z;
  w[(kShadingNormal + 0) * n + i] = sn.x;
  w[(kShadingNormal + 1) * n + i] = sn.y;
  w[(kShadingNormal + 2) * n + i] = sn.z;
  w[(kBaseColor + 0) * n + i] = base.x;
  w[(kBaseColor + 1) * n + i] = base.y;
  w[(kBaseColor + 2) * n + i] = base.z;
  a.seed_out[i] = static_cast<long long>(s);
  st[(kOrigin + 0) * n + i] = o_new.x;
  st[(kOrigin + 1) * n + i] = o_new.y;
  st[(kOrigin + 2) * n + i] = o_new.z;
  st[(kDirection + 0) * n + i] = d_new.x;
  st[(kDirection + 1) * n + i] = d_new.y;
  st[(kDirection + 2) * n + i] = d_new.z;
  st[(kThroughput + 0) * n + i] = thr.x;
  st[(kThroughput + 1) * n + i] = thr.y;
  st[(kThroughput + 2) * n + i] = thr.z;
  st[kLastPdf * n + i] = last_pdf;
}

struct ScatterArgs {
  long long n;
  int bounce, mode, bits;
  const float* work;
  const unsigned char* lanes;
  const unsigned char* occluded[3];   // the fan's bits of light j; null: none
  const unsigned char* env_occluded;  // null without env NEE
  float* rad[3];                      // in place
  Env env;
  const float* params;
  // The state shade_surface wrote, updated in place.
  long long* seed;
  float* state;
  unsigned char* alive;
};

// shade_scatter for lane i: direct light, rim, env NEE, the BRDF sample
// and roulette.
__device__ __forceinline__ void shade_scatter_lane(const ScatterArgs& a, long long i) {
  const long long n = a.n;
  const unsigned char code = a.lanes[kCode * n + i];
  if (code == kDone) return;
  const int bits = a.bits;
  float* st = a.state;
  unsigned int s = static_cast<unsigned int>(a.seed[i]);
  V3 thr = v3(st[(kThroughput + 0) * n + i], st[(kThroughput + 1) * n + i],
              st[(kThroughput + 2) * n + i]);
  if (code == kTransmit) {
    skip(s, scatter_draws(a.bounce));
    thr = clamp_throughput(thr);
    a.seed[i] = static_cast<long long>(s);
    st[(kThroughput + 0) * n + i] = thr.x;
    st[(kThroughput + 1) * n + i] = thr.y;
    st[(kThroughput + 2) * n + i] = thr.z;
    a.alive[i] = 1;
    return;
  }
  const Params q = load_params(a.params);
  const float* w = a.work;
  const Material m = material(q, a.mode);
  const V3 d = v3(st[(kDirection + 0) * n + i], st[(kDirection + 1) * n + i],
                  st[(kDirection + 2) * n + i]);
  const V3 v = neg(d);
  const V3 sn = v3(w[(kShadingNormal + 0) * n + i], w[(kShadingNormal + 1) * n + i],
                   w[(kShadingNormal + 2) * n + i]);
  const V3 base = v3(w[(kBaseColor + 0) * n + i], w[(kBaseColor + 1) * n + i],
                     w[(kBaseColor + 2) * n + i]);
  const V3 f0 = material_f0(q, m, base);
  float rad[3] = {a.rad[0][i], a.rad[1][i], a.rad[2][i]};

  // --- direct lighting: 3 cone lights + shadows + MIS ---
  V3 direct = v3(0.0f, 0.0f, 0.0f);
  for (int j = 0; j < 3; ++j) {
    if (!(bits & (kLight0 << j))) continue;
    bool lit = a.lanes[j * n + i] != 0;
    if (lit && (bits & kShadows)) lit = a.occluded[j][i] == 0;
    V3 contrib = v3(0.0f, 0.0f, 0.0f);
    if (lit) {
      const V3 ldir = v3(w[(kFanDir + 3 * j + 0) * n + i], w[(kFanDir + 3 * j + 1) * n + i],
                         w[(kFanDir + 3 * j + 2) * n + i]);
      const float cos_max = cosf(q.langle[j]);
      const float l_pdf = rdiv(1.0f, clamp_min(kTwoPi * (1.0f - cos_max), 1e-6f));
      const float ndl = clamp_min(dot(sn, ldir), 0.0f);
      const V3 brdf = brdf_value(sn, v, ldir, m.rough, f0, base, m.metallic, m.diff_rough,
                                 m.wrap);
      const float spec_prob = spec_probability(f0, base, m.metallic);
      const float pdf_b = brdf_pdf(sn, v, ldir, m.rough, spec_prob);
      const float mis = power_heuristic(l_pdf, pdf_b);
      const float wl = ndl * mis / clamp_min(l_pdf, 1e-6f) * q.lintensity[j];
      contrib = v3(brdf.x * q.lcolor[j].x * wl, brdf.y * q.lcolor[j].y * wl,
                   brdf.z * q.lcolor[j].z * wl);
    }
    direct = add(direct, contrib);
  }
  const V3 shaded = mul(thr, direct);
  rad[0] = rad[0] + shaded.x;
  rad[1] = rad[1] + shaded.y;
  rad[2] = rad[2] + shaded.z;

  // --- rim boost at the primary hit ---
  if ((bits & kRim) && a.mode == 0 && a.bounce == 0) {
    const float ndv = clamp_min(dot(sn, v), 0.0f);
    const float rim = pow3(1.0f - ndv) * q.rim_boost;
    const V3 rim_add = scale(mul(thr, base), rim);
    rad[0] = rad[0] + rim_add.x;
    rad[1] = rad[1] + rim_add.y;
    rad[2] = rad[2] + rim_add.z;
  }

  // --- env NEE with MIS ---
  if ((bits & kUseEnv) && a.lanes[kEnvMask * n + i] != 0 && a.env_occluded[i] == 0) {
    const V3 ed = v3(w[(kEnvDir + 0) * n + i], w[(kEnvDir + 1) * n + i],
                     w[(kEnvDir + 2) * n + i]);
    const float spdf = w[kEnvPdf * n + i];
    const float ndl_e = dot(sn, ed);
    const V3 brdf = brdf_value(sn, v, ed, m.rough, f0, base, m.metallic, m.diff_rough,
                               m.wrap);
    const V3 env_rad = env_radiance(a.env, ed, q.env_intensity, q.env_max_lum);
    const float spec_prob = spec_probability(f0, base, m.metallic);
    const float pdf_b = brdf_pdf(sn, v, ed, m.rough, spec_prob);
    const float mis = power_heuristic(spdf, pdf_b);
    const float we = clamp_min(ndl_e, 0.0f) * mis / clamp_min(spdf, 1e-6f);
    V3 contrib = scale(mul(mul(thr, brdf), env_rad), we);
    const float mx = max_component(contrib);
    const float cs = mx > kNeeClamp ? rdiv(kNeeClamp, clamp_min(mx, 1e-12f)) : 1.0f;
    contrib = scale(contrib, cs);
    rad[0] = rad[0] + contrib.x;
    rad[1] = rad[1] + contrib.y;
    rad[2] = rad[2] + contrib.z;
  }
  a.rad[0][i] = rad[0];
  a.rad[1][i] = rad[1];
  a.rad[2][i] = rad[2];

  // --- BRDF sampling ---
  const float spec_w = max_component(f0);
  const float diff_w = (1.0f - m.metallic) * max_component(base);
  const float wsum = spec_w + diff_w;
  const float spec_prob = clamp(wsum > 0.0f ? spec_w / clamp_min(wsum, 1e-12f) : 1.0f,
                                0.0f, 1.0f);
  const float r_lobe = rand(s);
  const float s1 = rand(s);
  const float s2 = rand(s);
  const bool choose_spec = r_lobe < spec_prob;
  V3 new_dir, weight;
  float new_pdf;
  bool dead_spec = false;
  if (choose_spec) {
    const V3 h = ggx_half_vector(sn, m.rough, s1, s2);
    const V3 spec_dir = normalize(reflect(d, h));
    const float ndl_s = clamp_min(dot(sn, spec_dir), 0.0f);
    const float ndv = clamp_min(dot(sn, v), 0.001f);
    const float ndh = clamp_min(dot(sn, h), 0.001f);
    const float vdh = clamp_min(dot(v, h), 0.001f);
    const float g = geometry_smith(ndv, ndl_s, m.rough);
    const V3 f = fresnel_v3(vdh, f0);
    weight = scale(f, g * vdh / (ndv * ndh * clamp_min(spec_prob, 0.01f)));
    const float d_ggx = distribution_ggx(ndh, m.rough);
    new_pdf = spec_prob * d_ggx * ndh / (4.0f * vdh);
    new_dir = spec_dir;
    dead_spec = ndl_s <= 0.0f;
  } else {
    const V3 diff_dir = cosine_hemisphere(sn, s1, s2);
    const float ndl_d = clamp_min(dot(sn, diff_dir), 0.0f);
    const V3 diff_brdf = eval_diffuse(sn, v, diff_dir, base, m.diff_rough, m.wrap);
    weight = scale(diff_brdf, (1.0f - m.metallic) * kPi / clamp_min(1.0f - spec_prob, 0.01f));
    new_pdf = div_host((1.0f - spec_prob) * ndl_d, kPi);
    new_dir = diff_dir;
  }
  thr = clamp_throughput(mul(thr, weight));

  // --- Russian roulette from bounce 1 ---
  bool rr_kill = false;
  if (a.bounce >= 1) {
    const float rr = rand(s);
    const float p = clamp(max_component(thr), 0.05f, 0.95f);
    rr_kill = rr > p;
    thr = scale(thr, rdiv(1.0f, p));
  }
  a.seed[i] = static_cast<long long>(s);
  st[(kOrigin + 0) * n + i] = w[(kShadowOrigin + 0) * n + i];
  st[(kOrigin + 1) * n + i] = w[(kShadowOrigin + 1) * n + i];
  st[(kOrigin + 2) * n + i] = w[(kShadowOrigin + 2) * n + i];
  st[(kDirection + 0) * n + i] = new_dir.x;
  st[(kDirection + 1) * n + i] = new_dir.y;
  st[(kDirection + 2) * n + i] = new_dir.z;
  st[(kThroughput + 0) * n + i] = thr.x;
  st[(kThroughput + 1) * n + i] = thr.y;
  st[(kThroughput + 2) * n + i] = thr.z;
  st[kLastPdf * n + i] = new_pdf;
  a.alive[i] = !dead_spec && !rr_kill;
}

}  // namespace shade

#endif  // WRT_SHADE_CUH
