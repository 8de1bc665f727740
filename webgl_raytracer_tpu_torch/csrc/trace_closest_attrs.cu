// Closest hit per ray plus the winner's 32-column attribute row.
//
// Replaces the TPU kernel `_make_closest_attrs_kernel` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (closest_attrs_plain, trace_closest_attrs).
//
// What bounds it on the H100: the walk's FP32 intersector arithmetic, as
// for trace_closest.cu, and the attribute rows: 128 B written per ray and
// at most 128 B read per hit ray from a table (K*128 rows of 128 B: 1.5 MB
// at K = 12, 16 MB at K = 128) that stays in the 50 MB L2. On the
// 1000-sphere 1080p primaries the 265 MB of rows written bound it.
//
// Design: trace_closest.cu's warp walk (intersect.cuh closest_walk), so t
// and the winning row are trace_closest's by construction. Then the warp
// writes its 32 rays' rows, which lie contiguous in attr_out (4 KB), 512
// bytes a store: at step s lane l stores 16-byte vector (l mod 8) of the
// row of ray (l / 8) + 4 s, that ray's winning row broadcast by
// __shfl_sync and read from the table through the read-only path (8 lanes
// a 128-byte row), or the miss row. The TPU kernel extracted the row with
// a one-hot [block,128]x[128,32] matrix product after every cluster sweep
// because its vector unit has no per-lane load; here the row is loaded
// once, after the walk.
//
// Operands (all device pointers, contiguous): od, soa, box, ct, cp as in
// trace_closest.cu; tab f32[k*128,32] (ops/trace.attr_operand: cluster row
// in global coordinates, shading attributes, slot as f32) and attr_out,
// both 16-byte aligned (the wrapper checks). Outputs: t f32[n] (1e20 on a
// miss); attrs f32[n,32], the winner's table row, or zeros with column
// 11 = -1 on a miss (inactive lanes included).

#include "intersect.cuh"

namespace {

constexpr int kAttrCols = 32;
constexpr int kAttrVecs = kAttrCols / 4;          // float4 a row
constexpr int kRowsPerStore = wrt::kWarp / kAttrVecs;

__global__ void __launch_bounds__(wrt::kThreads, wrt::kMinBlocks)
trace_closest_attrs_kernel(const float* __restrict__ od, long long n,
                           const float* __restrict__ soa,
                           const float* __restrict__ box,
                           const int* __restrict__ ct, int k,
                           const float* __restrict__ cp, int clip_on,
                           const float* __restrict__ tab,
                           float* __restrict__ t_out,
                           float* __restrict__ attr_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % wrt::kWarp;
  int best_row;
  const float best = wrt::closest_walk(od, n, i, lane, soa, box, ct, k, cp, clip_on,
                                       best_row);
  if (i < n) {
    t_out[i] = best;
  }
  const long long i0 = i - lane;
  const int v = lane % kAttrVecs;
  const float4* src = reinterpret_cast<const float4*>(tab);
  float4* dst = reinterpret_cast<float4*>(attr_out);
  // Vector 2 of the miss row holds columns 8-11: column 11 = -1.
  const float4 miss = make_float4(0.0f, 0.0f, 0.0f, v == 2 ? -1.0f : 0.0f);
#pragma unroll
  for (int s = 0; s < kAttrVecs; ++s) {
    const int owner = lane / kAttrVecs + kRowsPerStore * s;
    const int row = __shfl_sync(wrt::kFullMask, best_row, owner);
    const long long ray = i0 + owner;
    if (ray < n) {
      dst[ray * kAttrVecs + v] =
          row >= 0 ? __ldg(src + static_cast<long long>(row) * kAttrVecs + v) : miss;
    }
  }
}

}  // namespace

extern "C" int wrt_trace_closest_attrs(const float* od, long long n,
                                       const float* soa, const float* box,
                                       const int* ct, int k, const float* cp,
                                       int clip_on, const float* tab,
                                       float* t_out, float* attr_out,
                                       void* stream) {
  const long long blocks = (n + wrt::kThreads - 1) / wrt::kThreads;
  trace_closest_attrs_kernel<<<static_cast<unsigned int>(blocks), wrt::kThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
      od, n, soa, box, ct, k, cp, clip_on, tab, t_out, attr_out);
  return static_cast<int>(cudaGetLastError());
}
