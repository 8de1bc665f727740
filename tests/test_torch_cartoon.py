"""The port's protein cartoon against the JAX package's, and a TSTP cartoon
frame against the JAX integrator.

The cartoon generators are the same host numpy in both packages, so the
mesh (vertices, vertex normals, indices, colours, flags) and the sheet
H-bond cylinders must be equal bit for bit. The frame: the port's CPU
frame of the TSTP cartoon (three primitive types, 185 clusters) against
the JAX package's render_batch_stats on the same scene, camera and
settings, under the tolerances of
tests/test_torch_render.py::test_frame_matches_jax. The JAX side runs
under jit here: eagerly it takes over a minute on this scene (its dense
trace dispatches op by op over 185 clusters), and its XLA fusions may
contract a*b+c into FMAs, which the tolerances' flipped-pixel allowance
absorbs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.app.pipeline import load_molecule_scene as j_load
from webgl_raytracer_tpu.models import cartoon as JC
from webgl_raytracer_tpu.models import mesh as JMesh
from webgl_raytracer_tpu.models import parse_auto_detect as j_parse
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import integrator as JI
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu_torch.models import cartoon as PC
from webgl_raytracer_tpu_torch.models import mesh as PMesh
from webgl_raytracer_tpu_torch.models import parse_auto_detect as p_parse
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.scene.compile import numpy_fields, scene_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "assets", "proteins", "TSTP.pdb"), encoding="utf-8") as _f:
    TSTP = _f.read()
# The same file without its HELIX/SHEET records: secondary structure from
# the DSSP-style H-bond assignment alone.
TSTP_DSSP = "\n".join(ln for ln in TSTP.split("\n")
                      if not ln.startswith(("HELIX", "SHEET")))
SOURCES = {"TSTP": TSTP, "TSTP without HELIX/SHEET": TSTP_DSSP}
MESH_FIELDS = ("positions", "normals", "indices", "tri_colors", "tri_flags")


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("source", list(SOURCES))
def test_backbone_cartoon_matches_jax_bit_for_bit(source):
    text = SOURCES[source]
    p = PC.build_backbone_cartoon(p_parse(text, "TSTP.pdb"))
    j = JC.build_backbone_cartoon(j_parse(text, "TSTP.pdb"))
    assert p.num_triangles > 10000
    for name in MESH_FIELDS:
        assert _same_bits(getattr(p, name), getattr(j, name)), name
    assert _same_bits(p.tri_verts(), j.tri_verts())
    assert _same_bits(p.tri_vertex_normals(), j.tri_vertex_normals())


@pytest.mark.parametrize("source", list(SOURCES))
def test_sheet_hbond_cylinders_match_jax_bit_for_bit(source):
    text = SOURCES[source]
    p = PC.build_sheet_hbond_cylinders(p_parse(text, "TSTP.pdb"))
    j = JC.build_sheet_hbond_cylinders(j_parse(text, "TSTP.pdb"))
    assert p[0].shape[0] > 0
    for a, b in zip(p, j):
        assert _same_bits(a, b)


@pytest.mark.parametrize("source", list(SOURCES))
def test_secondary_structure_matches_jax(source):
    """Residues, H-bonds and the per-residue assignment the ribbons are
    built from."""
    text = SOURCES[source]
    p = PC._prepare(p_parse(text, "TSTP.pdb"), PC.DEFAULT_OPTIONS)
    j = JC._prepare(j_parse(text, "TSTP.pdb"), JC.DEFAULT_OPTIONS)
    assert [r.index for r in p[0]] == [r.index for r in j[0]]
    assert p[1] == j[1] and p[2] == j[2]
    assert {"H", "E"} <= set(p[2])


def test_mesh_builder_and_merge_match_jax():
    rng = np.random.default_rng(3)
    meshes = []
    for M in (PMesh, JMesh):
        b = M.MeshBuilder()
        for k in range(3):
            base = b.add_vertices(rng.random((4, 3)), rng.random((4, 3)))
            b.add_triangles(np.array([[0, 1, 2], [1, 2, 3]]) + base, (0.1 * k, 0.5, 0.9))
        meshes.append(b.build())
        rng = np.random.default_rng(3)
    merged = [M.merge_meshes(m, m) for M, m in zip((PMesh, JMesh), meshes)]
    for name in MESH_FIELDS:
        assert _same_bits(getattr(meshes[0], name), getattr(meshes[1], name)), name
        assert _same_bits(getattr(merged[0], name), getattr(merged[1], name)), name
    assert merged[0].num_triangles == 12 and not merged[0].has_surface_flags()


def test_tstp_cartoon_frame_matches_jax():
    """24x16, frame 0, the camera 10 A from the centre of the HELIX
    record's atoms, so that ribbons cover a fifth of the frame or more
    (fitted to the whole protein they cover under 1%)."""
    w, h = 24, 16
    js = j_load(j_parse(TSTP, "TSTP.pdb"), display_style="cartoon").scene
    jr = JRenderer(js, width=w, height=h)
    pr = Renderer(scene_from_numpy(numpy_fields(js), device="cpu"), width=w, height=h,
                  device="cpu")
    mol = p_parse(TSTP, "TSTP.pdb")
    helix = mol.helices[0]
    on_helix = ((np.asarray(mol.chain_ids) == helix.chain_id)
                & (mol.res_seqs >= helix.start_seq) & (mol.res_seqs <= helix.end_seq))
    for r in (jr, pr):
        r.settings.material_mode = "matte"
        r.camera.target = mol.positions[on_helix].mean(axis=0).astype(np.float64)
        r.camera.distance = 10.0
    basis = jr.camera.basis()
    jf, ju = j_split(jr.settings, basis, j_lights(jr.settings.lights, basis),
                     has_env=False, has_volume=False, clip=None)
    jx, jy = jr._pixel_grids()
    pf, pu, px, py = pr.frame_inputs()
    jc, (jn, jo) = JI.render_batch_stats(jr.scene, None, None, jf, ju, jx, jy,
                                         jnp.uint32(0))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pc, (pn, po) = PI.render_batch_stats(pr.scene, pf, pu, px, py, 0)
    finally:
        torch.set_num_threads(prev)
    jc, pc = np.asarray(jc), pc.numpy()
    assert np.isfinite(pc).all()
    hit = int((pc.max(axis=1) > 0).sum())
    assert hit >= 0.2 * pc.shape[0], hit

    diff = np.abs(pc - jc).max(axis=1)
    flipped = np.nonzero(diff > 1e-4)[0]
    assert len(flipped) <= 0.01 * diff.size, f"flipped rays: {flipped.tolist()}"
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * jc[keep].mean()
    bounces = pf.max_bounces
    assert abs(int(pn) - int(jn)) <= bounces * len(flipped)
    assert abs(int(po) - int(jo)) <= 3 * bounces * len(flipped)
    assert jax.devices()[0].platform == "cpu"
