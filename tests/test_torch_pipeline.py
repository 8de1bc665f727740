"""The port's scene loaders against the JAX package's app/pipeline.py.

Each loader's compiled scene (scene/compile fields: cluster rows, colours,
boxes, attribute rows, triangle normals and flags, counts) must equal the
JAX package's compiled scene field by field, bit for bit (the SES surface
and the density volume: tests/test_torch_surface.py). The last test
imports the port's pipeline, oracle and parity tool with the JAX package
blocked.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from webgl_raytracer_tpu.app import pipeline as JP
from webgl_raytracer_tpu.models import get_builtin_molecule as j_mol
from webgl_raytracer_tpu.models import parse_auto_detect as j_parse
from webgl_raytracer_tpu_torch.app import pipeline as PP
from webgl_raytracer_tpu_torch.models import get_builtin_molecule as p_mol
from webgl_raytracer_tpu_torch.models import parse_auto_detect as p_parse
from webgl_raytracer_tpu_torch.scene.compile import COUNT_FIELDS, HOST_FIELDS, TENSOR_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "assets", "proteins", "TSTP.pdb"), encoding="utf-8") as _f:
    TSTP = _f.read()

# (name, molecule source, load_molecule_scene keywords)
MOLECULE_SCENES = [
    ("caffeine ball-and-stick", "caffeine", {}),
    ("aspirin stick", "aspirin", {"display_style": "stick"}),
    ("glucose vdw", "glucose", {"display_style": "vdw"}),
    ("ibuprofen ball-and-stick, atom scale 0.6", "ibuprofen", {"atom_scale": 0.6}),
    ("TSTP cartoon", "TSTP", {"display_style": "cartoon"}),
    ("TSTP cartoon + sheet H-bonds", "TSTP",
     {"display_style": "cartoon", "show_sheet_hbonds": True}),
    ("TSTP ball-and-stick", "TSTP", {}),
]


def _mols(source):
    if source == "TSTP":
        return p_parse(TSTP, "TSTP.pdb"), j_parse(TSTP, "TSTP.pdb")
    return p_mol(source), j_mol(source)


def _assert_same_scene(p_loaded, j_loaded):
    ps, js = p_loaded.scene, j_loaded.scene
    for name in TENSOR_FIELDS:
        a = getattr(ps, name).numpy()
        b = np.asarray(getattr(js, name), np.float32)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    for name in COUNT_FIELDS:
        assert getattr(ps, name) == int(getattr(js, name)), name
    for name, dtype in HOST_FIELDS.items():
        a, b = getattr(ps.pick_tables, name), np.asarray(getattr(js, name))
        assert a.dtype == b.dtype == dtype and np.array_equal(a, b), name
    for name in ("positions", "normals", "indices", "tri_colors", "tri_flags"):
        assert np.array_equal(getattr(p_loaded.mesh, name), getattr(j_loaded.mesh, name)), name
    stats = {k: v for k, v in j_loaded.stats.items() if k != "bvh_nodes"}
    assert p_loaded.stats == stats
    assert ps.pick_tables.node_count == j_loaded.stats.get("bvh_nodes", js.node_count)


@pytest.mark.parametrize("case", MOLECULE_SCENES, ids=[c[0] for c in MOLECULE_SCENES])
def test_load_molecule_scene_matches_jax(case):
    _, source, kw = case
    p_mol_, j_mol_ = _mols(source)
    p = PP.load_molecule_scene(p_mol_, device="cpu", **kw)
    j = JP.load_molecule_scene(j_mol_, **kw)
    _assert_same_scene(p, j)
    if kw.get("display_style") == "cartoon":
        ps = p.scene
        assert ps.tri_count > 10000 and ps.sphere_count == 10 and ps.cylinder_count > 0
        assert ps.num_clusters >= 64


def test_cartoon_scene_has_three_primitive_types():
    loaded = PP.load_molecule_scene(p_parse(TSTP, "TSTP.pdb"), display_style="cartoon",
                                    device="cpu")
    types = set(loaded.scene.cluster_prims[..., 11].flatten().tolist()) - {-1.0}
    assert types == {0.0, 1.0, 2.0}
    assert loaded.stats["triangles"] == loaded.stats["cartoon_triangles"] == 15512


@pytest.mark.parametrize("count", [1, 1000])
def test_load_random_spheres_matches_jax(count):
    _assert_same_scene(PP.load_random_spheres(count, device="cpu"),
                       JP.load_random_spheres(count))


def test_load_test_primitives_matches_jax():
    _assert_same_scene(PP.load_test_primitives(device="cpu"), JP.load_test_primitives())


def test_mulberry32_and_hsl_match_jax():
    p, j = PP.mulberry32(12345), JP.mulberry32(12345)
    assert [p() for _ in range(1000)] == [j() for _ in range(1000)]
    for hsl in ((0.0, 0.0, 0.5), (0.3, 0.7, 0.4), (0.9, 1.0, 0.7), (0.5, 0.6, 0.2)):
        assert PP._hsl_to_rgb(*hsl) == JP._hsl_to_rgb(*hsl)


@pytest.mark.parametrize("style", ["ball-and-stick", "vdw", "stick", "cartoon", "unknown"])
def test_display_options_match_jax(style):
    assert PP.get_display_options(style, 0.7, 0.2) == JP.get_display_options(style, 0.7, 0.2)


@pytest.mark.parametrize("option", ["show_surface", "volume_enabled"])
def test_unported_scene_options_raise(option):
    """Both options are ported: they load (SES triangles, a density grid)
    instead of raising."""
    loaded = PP.load_molecule_scene(p_mol("caffeine"), device="cpu",
                                    surface_resolution=0.6, **{option: True})
    if option == "show_surface":
        assert loaded.stats["ses_triangles"] == loaded.scene.tri_count > 0
        assert loaded.volume is None
    else:
        assert loaded.volume.nitrogen_count == 4 and loaded.scene.tri_count == 0


def test_loaders_default_to_the_card():
    """device None means cuda:0: without a GPU the loaders raise rather than
    compile on the CPU."""
    import torch

    if torch.cuda.is_available():
        assert PP.load_test_primitives().scene.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.load_test_primitives()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.load_random_spheres(10)


def test_pipeline_oracle_and_tool_import_without_jax():
    """With the JAX package blocked, the port loads TSTP as a cartoon,
    renders it on the CPU, runs its oracle on a few pixels, loads caffeine
    with its SES (the device marching cubes too) and with its density
    volume and renders the volume frame, renders a vis mode 2 frame, runs
    the cost profile tool with --device cpu, imports the parity tool,
    renders a frame on a mesh of two CPU shards (parallel/), and loads no
    module of JAX or of the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['webgl_raytracer_tpu'] = None\n"
        "from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene\n"
        "from webgl_raytracer_tpu_torch.models import parse_auto_detect\n"
        "from webgl_raytracer_tpu_torch.render import Renderer\n"
        "from webgl_raytracer_tpu_torch.render.reference_oracle import render_batch_oracle\n"
        "from webgl_raytracer_tpu_torch.tools import parity_rmse\n"
        "text = open('assets/proteins/TSTP.pdb').read()\n"
        "loaded = load_molecule_scene(parse_auto_detect(text, 'TSTP.pdb'),\n"
        "                             display_style='cartoon', device='cpu')\n"
        "r = Renderer(loaded.scene, width=8, height=8, device='cpu')\n"
        "assert r.render(1).shape == (8, 8, 3)\n"
        "flags, u, px, py = r.frame_inputs()\n"
        "c = render_batch_oracle(loaded.scene, None, flags, u, px[:4], py[:4], 0)\n"
        "assert c.shape == (4, 3) and len(parity_rmse.rows()) == 13\n"
        "from webgl_raytracer_tpu_torch.models import get_builtin_molecule\n"
        "import os\n"
        "ses = load_molecule_scene(get_builtin_molecule('caffeine'), show_surface=True,\n"
        "                          surface_resolution=0.6, device='cpu')\n"
        "assert ses.stats['ses_triangles'] > 0\n"
        "os.environ['WRT_DEVICE_MC'] = '1'\n"
        "dev = load_molecule_scene(get_builtin_molecule('caffeine'), show_surface=True,\n"
        "                          surface_resolution=0.6, device='cpu')\n"
        "assert dev.stats == ses.stats\n"
        "vol = load_molecule_scene(get_builtin_molecule('caffeine'), volume_enabled=True,\n"
        "                          volume_options=dict(spacing=0.8), device='cpu')\n"
        "r = Renderer(vol.scene, volume=vol.volume.to_device_buffers('cpu'), width=8,\n"
        "             height=8, device='cpu')\n"
        "r.settings.volume_enabled = True\n"
        "r.settings.volume_max_steps = 16\n"
        "assert r.render(1).mean() > 0 and r.frame_inputs()[0].volume_enabled\n"
        "r = Renderer(vol.scene, width=8, height=8, device='cpu')\n"
        "r.settings.vis_mode = 2\n"
        "assert r.render(1).mean() > 0 and r.frame_index == 1\n"
        "from webgl_raytracer_tpu_torch.tools import cost_profile\n"
        "assert cost_profile.main(['--scene', 'spheres600', '--width', '16', '--height',\n"
        "                          '16', '--perray', '--device', 'cpu']) == 0\n"
        "from webgl_raytracer_tpu_torch.parallel import make_mesh\n"
        "r = Renderer(vol.scene, width=8, height=8, mesh=make_mesh(['cpu', 'cpu']))\n"
        "assert r.render(1).mean() > 0 and len(r._shards) == 2\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
        "             or (m.split('.')[0] == 'webgl_raytracer_tpu' and sys.modules[m] is not None))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
