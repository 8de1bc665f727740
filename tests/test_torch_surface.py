"""The port's SES surface against the JAX package.

* compute_distance_field (the native splat where g++ builds it, and the
  numpy / scipy path), the numpy marching_cubes and compute_ses (SES and
  SAS) equal to the JAX package's bit for bit.
* The device marching cubes (ops/marching.py) on CPU tensors against the
  numpy path as tests/test_surface_volume.py holds the JAX device path:
  vertex and triangle sets within 1e-3, triangle winding against the
  gradient normals; the port's also keeps the numpy path's order.
* load_molecule_scene with show_surface / volume_enabled on caffeine: the
  compiled scene, mesh, stats and volume equal to the JAX package's.
"""

import numpy as np
import pytest

import webgl_raytracer_tpu.native as JN
from webgl_raytracer_tpu.app import pipeline as JP
from webgl_raytracer_tpu.models import get_builtin_molecule as j_mol
from webgl_raytracer_tpu.models import surface as JS
from webgl_raytracer_tpu_torch.app import pipeline as PP
from webgl_raytracer_tpu_torch.models import get_builtin_molecule as p_mol
from webgl_raytracer_tpu_torch.models import surface as PS
from webgl_raytracer_tpu_torch.models.elements import element_radii_array
from webgl_raytracer_tpu_torch.ops.marching import marching_cubes_device
from webgl_raytracer_tpu_torch.scene import native as PN
from webgl_raytracer_tpu_torch.scene.compile import COUNT_FIELDS, TENSOR_FIELDS


def _atoms(seed=2, n=120, equal=False):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n, 3)) * 5
    radii = np.full(n, 1.5) if equal else rng.uniform(1.2, 1.9, n)
    return centers, radii


@pytest.fixture
def numpy_fields(monkeypatch):
    """Both packages' distance fields on their numpy / scipy path."""
    monkeypatch.setattr(PN, "load_distance_field", lambda: None)
    monkeypatch.setattr(JN, "_df_lib", None)
    monkeypatch.setattr(JN, "_df_failed", True)


def _same_grid(a, b):
    assert a.data.dtype == np.float32 and a.data.tobytes() == b.data.tobytes()
    assert a.grid_min.tobytes() == b.grid_min.tobytes()
    assert (a.resolution, a.max_dist, a.dims) == (b.resolution, b.max_dist, b.dims)


def _same(p, j):
    for a, b in zip(p, j):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("radii", ["mixed", "equal"])
def test_distance_field_matches_jax(path, radii, request):
    if path == "native":
        if PN.load_distance_field() is None or JN.load_distance_field() is None:
            pytest.skip("no g++: the native splat cannot be built")
    else:
        request.getfixturevalue("numpy_fields")
    centers, r = _atoms(equal=radii == "equal")
    args = (centers, r, centers.min(0) - 2, centers.max(0) + 2, 0.5, 1.4, 1.0)
    _same_grid(PS.compute_distance_field(*args), JS.compute_distance_field(*args))


def test_native_distance_field_equals_numpy_path(monkeypatch):
    """The port's native splat and its numpy path agree (the JAX test's
    1e-4 bound: the equal-radius numpy path is a KD-tree query)."""
    if PN.load_distance_field() is None:
        pytest.skip("no g++: the native splat cannot be built")
    for equal in (False, True):
        centers, r = _atoms(equal=equal)
        args = (centers, r, centers.min(0) - 2, centers.max(0) + 2, 0.5, 1.4, 1.0)
        native = PS.compute_distance_field(*args)
        monkeypatch.setattr(PN, "load_distance_field", lambda: None)
        numpy_ = PS.compute_distance_field(*args)
        monkeypatch.undo()
        assert np.abs(native.data - numpy_.data).max() < 1e-4


@pytest.mark.parametrize("smooth", [False, True], ids=["gradient", "smooth"])
def test_marching_cubes_matches_jax(smooth):
    centers, r = _atoms(seed=7, n=25)
    args = (centers * 0.6, r, centers.min(0) * 0.6 - 2, centers.max(0) * 0.6 + 2, 0.5,
            1.4, 1.0)
    grid = PS.compute_distance_field(*args)
    p = PS.marching_cubes(grid, 0.0, smooth, backend="numpy")
    j = JS.marching_cubes(JS.compute_distance_field(*args), 0.0, smooth, backend="numpy")
    _same(p, j)
    assert p[2].shape[0] > 1000
    empty = PS.compute_distance_field(np.zeros((0, 3)), np.zeros(0), [0, 0, 0], [1, 1, 1],
                                      0.5, 0.0, 1.0)
    assert all(a.shape[0] == 0 for a in PS.marching_cubes(empty, 0.0))


SES_CASES = {
    "caffeine 0.5 A": ("caffeine", 0.5, False, False),
    "caffeine 0.5 A smooth normals": ("caffeine", 0.5, False, True),
    "aspirin 0.6 A SAS": ("aspirin", 0.6, True, False),
    "two spheres 0.35 A": (None, 0.35, False, False),
}


@pytest.mark.parametrize("case", list(SES_CASES))
def test_compute_ses_matches_jax(case):
    name, res, sas, smooth = SES_CASES[case]
    if name is None:
        centers, radii = np.array([[0.0, 0, 0], [2.2, 0, 0]]), np.array([1.2, 1.2])
        probe = 1.0
    else:
        mol = p_mol(name)
        centers, radii, probe = mol.positions, element_radii_array(mol.elements), 1.4
    kw = dict(probe_radius=probe, resolution=res, sas=sas, smooth_normals=smooth)
    p = PS.compute_ses(centers, radii, **kw)
    _same(p, JS.compute_ses(centers, radii, **kw))
    assert p[2].shape[0] > 100
    mesh = PS.ses_to_mesh(*p)
    assert mesh.has_surface_flags() and mesh.tri_colors.shape == (p[2].shape[0], 3)


def _aligned(a, b):
    return a[np.lexsort(np.round(a, 3).T)], b[np.lexsort(np.round(b, 3).T)]


def _tri_set(v, i):
    return {tuple(sorted(map(tuple, t.tolist()))) for t in np.round(v[i], 2)}


def test_device_marching_cubes_matches_numpy():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(25, 3)) * 3
    radii = rng.uniform(1.2, 1.9, 25)
    grid = PS.compute_distance_field(centers, radii, centers.min(0) - 2, centers.max(0) + 2,
                                     0.5, 1.4, 1.0)
    v0, n0, i0 = PS.marching_cubes(grid, 0.0, backend="numpy")
    v1, n1, i1 = marching_cubes_device(grid.data, grid.grid_min, grid.resolution,
                                       grid.max_dist, device="cpu")
    assert v0.shape == v1.shape and i0.shape == i1.shape and i1.dtype == np.uint32
    a, b = _aligned(v0, v1)
    assert np.abs(a - b).max() < 1e-3
    assert _tri_set(v0, i0) == _tri_set(v1, i1)
    oa, ob = np.lexsort(np.round(v0, 3).T), np.lexsort(np.round(v1, 3).T)
    assert np.abs(n0[oa] - n1[ob]).max() < 1e-3
    # The port's device path keeps the numpy path's emission order.
    assert np.array_equal(i0, i1) and np.abs(v0 - v1).max() < 1e-3
    v2, n2, i2 = marching_cubes_device(grid.data, grid.grid_min, grid.resolution,
                                       grid.max_dist, verts_only=True, device="cpu")
    a, b = _aligned(v0, v2)
    assert np.abs(a - b).max() < 1e-3 and n2.shape == i2.shape == (0, 3)
    # Through models/surface: backend="device" and WRT_DEVICE_MC=1.
    v3, _, i3 = PS.marching_cubes(grid, 0.0, backend="device", device="cpu")
    assert np.array_equal(i3, i1) and np.array_equal(v3, v1)


@pytest.mark.parametrize("shape, center", [
    ((24, 20, 16), (4.0, 5.0, 6.0)),      # sizes descending
    ((16, 20, 24), (6.0, 5.0, 4.0)),      # the JAX path's odd axis permutation
    ((20, 16, 24), (6.0, 4.0, 5.0)),      # its even (cyclic) permutation
])
def test_device_marching_cubes_winding(shape, center):
    """tests/test_surface_volume.py's winding check: the project's
    convention emits cross(e1, e2) opposite the gradient vertex normals,
    on every grid shape."""
    nz, ny, nx = shape
    zz, yy, xx = np.meshgrid(np.arange(nz) * 0.5, np.arange(ny) * 0.5, np.arange(nx) * 0.5,
                             indexing="ij")
    d = np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2
                + (zz - center[2]) ** 2) - 2.0
    v, n, t = marching_cubes_device(d.astype(np.float32), np.zeros(3, np.float32), 0.5, 10.0,
                                    device="cpu")
    assert len(t) > 0
    geo = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    vn = n[t[:, 0]] + n[t[:, 1]] + n[t[:, 2]]
    assert (np.sum(geo * vn, axis=1) > 0).mean() < 0.01


PIPELINE_CASES = {
    "caffeine SES 0.5 A": dict(show_surface=True, surface_resolution=0.5),
    "caffeine SES 0.5 A, atoms too": dict(show_surface=True, surface_resolution=0.5,
                                          surface_atom_mode="all", smooth_normals=True),
    "caffeine stick + volume": dict(display_style="stick", volume_enabled=True,
                                    volume_options=dict(spacing=0.8)),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_load_molecule_scene_surface_and_volume_match_jax(case):
    kw = PIPELINE_CASES[case]
    p = PP.load_molecule_scene(p_mol("caffeine"), device="cpu", **kw)
    j = JP.load_molecule_scene(j_mol("caffeine"), **kw)
    for name in TENSOR_FIELDS:
        a, b = getattr(p.scene, name).numpy(), np.asarray(getattr(j.scene, name), np.float32)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    for name in COUNT_FIELDS:
        assert getattr(p.scene, name) == int(getattr(j.scene, name)), name
    for name in ("positions", "normals", "indices", "tri_colors", "tri_flags"):
        assert np.array_equal(getattr(p.mesh, name), getattr(j.mesh, name)), name
    assert p.stats == {k: v for k, v in j.stats.items() if k != "bvh_nodes"}
    if kw.get("volume_enabled"):
        assert p.volume.data.tobytes() == j.volume.data.tobytes()
        assert p.volume.dims == j.volume.dims and p.volume.max_value == j.volume.max_value
    else:
        assert p.volume is None and p.stats["ses_triangles"] > 1000


def test_device_marching_cubes_in_the_pipeline(monkeypatch):
    """WRT_DEVICE_MC=1 meshes the SES on the pipeline's device: the same
    compiled scene as the numpy path."""
    ref = PP.load_molecule_scene(p_mol("caffeine"), show_surface=True,
                                 surface_resolution=0.5, device="cpu")
    monkeypatch.setenv("WRT_DEVICE_MC", "1")
    seen = []
    real = marching_cubes_device

    def spy(*a, **k):
        seen.append(k.get("device"))
        return real(*a, **k)

    import webgl_raytracer_tpu_torch.ops.marching as PM

    monkeypatch.setattr(PM, "marching_cubes_device", spy)
    dev = PP.load_molecule_scene(p_mol("caffeine"), show_surface=True,
                                 surface_resolution=0.5, device="cpu")
    assert seen == ["cpu", "cpu"]
    for name in TENSOR_FIELDS:
        assert getattr(dev.scene, name).numpy().tobytes() == \
            getattr(ref.scene, name).numpy().tobytes(), name
