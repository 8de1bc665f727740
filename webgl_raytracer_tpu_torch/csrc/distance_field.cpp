// Signed-distance field builder for the SES pipeline (the port's copy of
// webgl_raytracer_tpu/native/distance_field.cpp, built by scene/native.py).
//
// The reference rasterizes per-sphere distance quads with GL MIN blending
// on a hidden context (surface_webgl.js:376-520); here the same bounded
// per-sphere splat runs as a native loop. Two entry points:
//
//   wrt_probe_field  — hundreds of thousands of EQUAL-radius spheres (the
//     SAS-vertex probe respray, surface_webgl.js:1051-1077). Equal radii
//     let the inner loop min squared distances (no sqrt), with one sqrt
//     pass at the end; the x-inner loop auto-vectorizes.
//   wrt_sphere_field — mixed radii (the atom pass): per-sphere signed
//     distance with the sqrt in the loop. Atom counts are small.
//
// Both produce exactly min over spheres of clamp(|p-c| - r, +-max_dist)
// with voxels outside every sphere's reach left at +max_dist — matching
// models/surface.compute_distance_field's numpy path.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

void wrt_probe_field(const float* centers,  // [n, 3] xyz
                     int64_t n,
                     float sphere_r,        // common radius (incl. probe)
                     float max_dist,
                     float gx, float gy, float gz,
                     float res,
                     int64_t nx, int64_t ny, int64_t nz,
                     float* data)           // [nz*ny*nx], overwritten
{
    const int64_t total = nx * ny * nz;
    const float reach = sphere_r + max_dist;
    const float cap2 = reach * reach;
    std::vector<float> d2(total, cap2);
    const float inv_res = 1.0f / res;
    const int64_t box = (int64_t)std::ceil(reach * inv_res) + 1;
    std::vector<float> dx2(2 * box + 2);

    for (int64_t i = 0; i < n; ++i) {
        const float cx = centers[i * 3 + 0];
        const float cy = centers[i * 3 + 1];
        const float cz = centers[i * 3 + 2];
        int64_t ix0 = (int64_t)std::floor((cx - reach - gx) * inv_res);
        int64_t ix1 = (int64_t)std::ceil((cx + reach - gx) * inv_res);
        int64_t iy0 = (int64_t)std::floor((cy - reach - gy) * inv_res);
        int64_t iy1 = (int64_t)std::ceil((cy + reach - gy) * inv_res);
        int64_t iz0 = (int64_t)std::floor((cz - reach - gz) * inv_res);
        int64_t iz1 = (int64_t)std::ceil((cz + reach - gz) * inv_res);
        if (ix0 < 0) ix0 = 0;
        if (iy0 < 0) iy0 = 0;
        if (iz0 < 0) iz0 = 0;
        if (ix1 > nx - 1) ix1 = nx - 1;
        if (iy1 > ny - 1) iy1 = ny - 1;
        if (iz1 > nz - 1) iz1 = nz - 1;
        if (ix1 < ix0 || iy1 < iy0 || iz1 < iz0) continue;

        for (int64_t ix = ix0; ix <= ix1; ++ix) {
            const float dx = gx + ix * res - cx;
            dx2[ix - ix0] = dx * dx;
        }
        for (int64_t iz = iz0; iz <= iz1; ++iz) {
            const float dz = gz + iz * res - cz;
            const float dz2 = dz * dz;
            for (int64_t iy = iy0; iy <= iy1; ++iy) {
                const float dy = gy + iy * res - cy;
                const float base = dz2 + dy * dy;
                float* row = d2.data() + (iz * ny + iy) * nx + ix0;
                const float* dxp = dx2.data();
                const int64_t w = ix1 - ix0 + 1;
                for (int64_t k = 0; k < w; ++k) {
                    const float v = base + dxp[k];
                    if (v < row[k]) row[k] = v;
                }
            }
        }
    }

    for (int64_t v = 0; v < total; ++v) {
        float val = std::sqrt(d2[v]) - sphere_r;
        if (val > max_dist) val = max_dist;
        if (val < -max_dist) val = -max_dist;
        data[v] = val;
    }
}

void wrt_sphere_field(const float* centers,  // [n, 3]
                      const float* radii,    // [n] (incl. probe inflation)
                      int64_t n,
                      float max_dist,
                      float gx, float gy, float gz,
                      float res,
                      int64_t nx, int64_t ny, int64_t nz,
                      float* data)            // [nz*ny*nx], overwritten
{
    const int64_t total = nx * ny * nz;
    for (int64_t v = 0; v < total; ++v) data[v] = max_dist;
    const float inv_res = 1.0f / res;
    std::vector<float> dx2;

    for (int64_t i = 0; i < n; ++i) {
        const float cx = centers[i * 3 + 0];
        const float cy = centers[i * 3 + 1];
        const float cz = centers[i * 3 + 2];
        const float r = radii[i];
        const float reach = r + max_dist + res;
        int64_t ix0 = (int64_t)std::floor((cx - reach - gx) * inv_res);
        int64_t ix1 = (int64_t)std::ceil((cx + reach - gx) * inv_res);
        int64_t iy0 = (int64_t)std::floor((cy - reach - gy) * inv_res);
        int64_t iy1 = (int64_t)std::ceil((cy + reach - gy) * inv_res);
        int64_t iz0 = (int64_t)std::floor((cz - reach - gz) * inv_res);
        int64_t iz1 = (int64_t)std::ceil((cz + reach - gz) * inv_res);
        if (ix0 < 0) ix0 = 0;
        if (iy0 < 0) iy0 = 0;
        if (iz0 < 0) iz0 = 0;
        if (ix1 > nx - 1) ix1 = nx - 1;
        if (iy1 > ny - 1) iy1 = ny - 1;
        if (iz1 > nz - 1) iz1 = nz - 1;
        if (ix1 < ix0 || iy1 < iy0 || iz1 < iz0) continue;

        const int64_t w = ix1 - ix0 + 1;
        dx2.resize((size_t)w);
        for (int64_t ix = ix0; ix <= ix1; ++ix) {
            const float dx = gx + ix * res - cx;
            dx2[ix - ix0] = dx * dx;
        }
        for (int64_t iz = iz0; iz <= iz1; ++iz) {
            const float dz = gz + iz * res - cz;
            const float dz2 = dz * dz;
            for (int64_t iy = iy0; iy <= iy1; ++iy) {
                const float dy = gy + iy * res - cy;
                const float base = dz2 + dy * dy;
                float* row = data + (iz * ny + iy) * nx + ix0;
                for (int64_t k = 0; k < w; ++k) {
                    float val = std::sqrt(base + dx2[k]) - r;
                    if (val < -max_dist) val = -max_dist;
                    if (val < row[k]) row[k] = val;
                }
            }
        }
    }
}

}  // extern "C"
