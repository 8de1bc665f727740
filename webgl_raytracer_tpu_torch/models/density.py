"""Nitrogen Gaussian density volume builder.

The port's own copy of webgl_raytracer_tpu/models/density.py (the
reference viewer's volume.js): per-nitrogen Gaussian splats with sigma =
1.55 A (N van der Waals radius) * gaussian_scale, cut off at sigma *
cutoff_sigma, grid bounds padded by the cutoff, a 256^3 voxel guard and
the same validation errors. The splat is host numpy, one vectorised box
per atom; to_device_buffers puts the grid on the device for the march
(ops/volume.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .molecular import MolData

N_VDW_RADIUS = 1.55

VOLUME_DEFAULTS = dict(
    spacing=0.5,
    gaussian_scale=3.0,
    cutoff_sigma=3.0,
    max_voxels=256 ** 3,
)


@dataclass
class DensityVolume:
    """data is x-fastest: data[z, y, x] (the reference's flat
    x + y*nx + z*nx*ny layout, as ops/volume.py reads it)."""
    data: np.ndarray             # f32[nz, ny, nx]
    dims: tuple[int, int, int]   # (nx, ny, nz)
    origin: np.ndarray           # f32[3]
    spacing: np.ndarray          # f32[3]
    max_value: float
    nitrogen_count: int
    sigma: float
    cutoff: float
    bounds_min: np.ndarray       # f32[3] (grid min)
    bounds_max: np.ndarray       # f32[3] (last grid point)

    def to_device_buffers(self, device=None):
        """The grid and its bounds as ops/volume.VolumeBuffers on `device`
        (None: cuda:0, raising without a GPU)."""
        return volume_buffers_from_numpy(self.data, self.bounds_min, self.bounds_max,
                                         self.max_value, device)


def volume_buffers_from_numpy(data, vmin, vmax, max_value, device=None):
    """VolumeBuffers on `device` (None: cuda:0) from numpy values: the
    grid f32[nz, ny, nx], its bounds f32[3] and the density maximum (the
    JAX package's VolumeBuffers or DensityVolume fields as numpy arrays
    carry the same grid into the port)."""
    import torch

    from ..device import resolve_device
    from ..ops.volume import VolumeBuffers

    device = resolve_device(device)
    data = np.ascontiguousarray(data, np.float32)
    nz, ny, nx = data.shape

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return VolumeBuffers(data=torch.tensor(data, device=device),
                         vmin=t(vmin).reshape(3), vmax=t(vmax).reshape(3),
                         max_value=t(np.float32(max_value)).reshape(()),
                         nx=nx, ny=ny, nz=nz)


def _require_positive(value, label):
    value = float(value)
    if not np.isfinite(value):
        raise ValueError(f"{label} must be a finite number.")
    if value <= 0:
        raise ValueError(f"{label} must be > 0.")
    return value


def build_nitrogen_density_volume(
    mol: MolData,
    spacing: float = VOLUME_DEFAULTS["spacing"],
    gaussian_scale: float = VOLUME_DEFAULTS["gaussian_scale"],
    cutoff_sigma: float = VOLUME_DEFAULTS["cutoff_sigma"],
    max_voxels: int = VOLUME_DEFAULTS["max_voxels"],
) -> DensityVolume:
    """Sum of unit-height Gaussians centred on the nitrogen atoms."""
    spacing = _require_positive(spacing, "Volume spacing")
    gaussian_scale = _require_positive(gaussian_scale, "Gaussian scale")
    cutoff_sigma = _require_positive(cutoff_sigma, "Gaussian cutoff")
    if not np.isfinite(max_voxels) or max_voxels <= 0:
        raise ValueError("Volume max voxels must be > 0.")

    n_mask = np.array([e.upper() == "N" for e in mol.elements], bool)
    if not n_mask.any():
        raise ValueError("No nitrogen atoms found for volumetric density.")
    pos = mol.positions[n_mask].astype(np.float64)

    sigma = N_VDW_RADIUS * gaussian_scale
    cutoff = sigma * cutoff_sigma
    cutoff2 = cutoff * cutoff
    sigma2 = sigma * sigma

    lo = pos.min(axis=0) - cutoff
    hi = pos.max(axis=0) + cutoff
    dims = np.maximum(1, np.floor((hi - lo) / spacing).astype(int) + 1)
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    if nx * ny * nz > max_voxels:
        raise ValueError(
            f"Volume grid too large ({nx}x{ny}x{nz} = {nx * ny * nz} voxels). "
            f"Increase spacing or raise maxVoxels."
        )

    data = np.zeros((nz, ny, nx), np.float64)
    xs = lo[0] + spacing * np.arange(nx)
    ys = lo[1] + spacing * np.arange(ny)
    zs = lo[2] + spacing * np.arange(nz)

    inv_spacing = 1.0 / spacing
    r_grid = cutoff * inv_spacing
    for ax, ay, az in pos:
        cx = (ax - lo[0]) * inv_spacing
        cy = (ay - lo[1]) * inv_spacing
        cz = (az - lo[2]) * inv_spacing
        ix0 = max(0, int(np.floor(cx - r_grid)))
        ix1 = min(nx - 1, int(np.ceil(cx + r_grid)))
        iy0 = max(0, int(np.floor(cy - r_grid)))
        iy1 = min(ny - 1, int(np.ceil(cy + r_grid)))
        iz0 = max(0, int(np.floor(cz - r_grid)))
        iz1 = min(nz - 1, int(np.ceil(cz + r_grid)))
        dx2 = (xs[ix0:ix1 + 1] - ax) ** 2
        dy2 = (ys[iy0:iy1 + 1] - ay) ** 2
        dz2 = (zs[iz0:iz1 + 1] - az) ** 2
        r2 = dz2[:, None, None] + dy2[None, :, None] + dx2[None, None, :]
        splat = np.where(r2 <= cutoff2, np.exp(-0.5 * r2 / sigma2), 0.0)
        data[iz0:iz1 + 1, iy0:iy1 + 1, ix0:ix1 + 1] += splat

    max_value = float(data.max())
    if max_value <= 0:
        raise ValueError("Generated volume has no density values.")

    grid_max = lo + spacing * (dims - 1)
    return DensityVolume(
        data=data.astype(np.float32),
        dims=(nx, ny, nz),
        origin=lo.astype(np.float32),
        spacing=np.full(3, spacing, np.float32),
        max_value=max_value,
        nitrogen_count=int(n_mask.sum()),
        sigma=sigma,
        cutoff=cutoff,
        bounds_min=lo.astype(np.float32),
        bounds_max=grid_max.astype(np.float32),
    )
