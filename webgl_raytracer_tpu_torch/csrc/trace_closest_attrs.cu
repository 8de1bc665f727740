// Closest hit per ray plus the winner's 32-column attribute row.
//
// Replaces the TPU kernel `_make_closest_attrs_kernel` of
// webgl_raytracer_tpu/ops/pallas_trace.py. Plain version and semantics:
// ops/trace.py (closest_attrs_plain, trace_closest_attrs).
//
// What bounds it on the H100: the walk's FP32 intersector arithmetic, as
// for trace_closest.cu; the attribute rows add 128 B written per ray and
// at most 128 B read per hit ray from a table (K*128 rows of 128 B: 1.5 MB
// at K = 12, 16 MB at K = 128) that stays in the 50 MB L2.
//
// Design: the block walk (wrt::closest_block_walk, one thread a ray,
// clusters staged in shared memory). It takes the same lexicographic
// (t, row) minimum in index order as trace_closest.cu's warp walk, so t
// and the winning row are bit for bit the ones trace_closest returns
// (chip_smoke.py holds the two kernels to each other). After it, each hit lane copies its winner's row from the table with
// eight 16-byte loads and stores; a miss lane writes the miss row. The TPU
// kernel extracted the row with a one-hot [block,128]x[128,32] matrix
// product after every cluster sweep because its vector unit has no
// per-lane load; a thread here loads its own row once, after the walk.
//
// Operands (all device pointers, contiguous): od, soa, box, ct, cp as in
// trace_closest.cu; tab f32[k*128,32] (ops/trace.attr_operand: cluster row
// in global coordinates, shading attributes, slot as f32), 16-byte aligned.
// Outputs: t f32[n] (1e20 on a miss); attrs f32[n,32], the winner's table
// row, or zeros with column 11 = -1 on a miss (inactive lanes included).

#include "intersect.cuh"

namespace {

constexpr int kAttrCols = 32;
constexpr int kAttrVecs = kAttrCols / 4;

__global__ void __launch_bounds__(wrt::kThreads)
trace_closest_attrs_kernel(const float* __restrict__ od, long long n,
                           const float* __restrict__ soa,
                           const float* __restrict__ box,
                           const int* __restrict__ ct, int k,
                           const float* __restrict__ cp, int clip_on,
                           const float* __restrict__ tab,
                           float* __restrict__ t_out,
                           float* __restrict__ attr_out) {
  __shared__ float rows[wrt::kClusterFloats];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int best_row;
  const float best = wrt::closest_block_walk(rows, od, n, i, soa, box, ct, k, cp,
                                             clip_on, best_row);
  if (i >= n) {
    return;
  }
  t_out[i] = best;
  float4* dst = reinterpret_cast<float4*>(attr_out + i * kAttrCols);
  if (best_row >= 0) {
    const float4* src = reinterpret_cast<const float4*>(
        tab + static_cast<long long>(best_row) * kAttrCols);
#pragma unroll
    for (int q = 0; q < kAttrVecs; ++q) {
      dst[q] = src[q];
    }
  } else {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < kAttrVecs; ++q) {
      dst[q] = zero;
    }
    dst[2] = make_float4(0.0f, 0.0f, 0.0f, -1.0f);   // column 11: type -1
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
