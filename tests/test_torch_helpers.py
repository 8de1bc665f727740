"""The port's small public helpers against the JAX package's, on the CPU:
the element lookups (models/elements.py), save_hdr (env/hdr.py) and
to_srgb_u8 (ops/tonemap.py). All are exact: the same table entries, the
same bytes, the same rounding (half to even) of the same f32 products.
"""

import numpy as np
import pytest
import torch

from webgl_raytracer_tpu import models as JM
from webgl_raytracer_tpu.env import hdr as JH
from webgl_raytracer_tpu.ops import tonemap as JT
from webgl_raytracer_tpu_torch import models as PM
from webgl_raytracer_tpu_torch.env import load_hdr, save_hdr
from webgl_raytracer_tpu_torch.models import elements as PE
from webgl_raytracer_tpu_torch.ops.tonemap import to_srgb_u8

SYMBOLS = sorted(set(PE.ELEMENT_COLORS) | set(PE.ELEMENT_RADII) | set(PE.COVALENT_RADII))


@pytest.mark.parametrize("name", ["element_color", "element_radius", "covalent_radius"])
def test_element_lookups_match_jax(name):
    port, ref = getattr(PM, name), getattr(JM, name)
    assert set(SYMBOLS) == (set(JM.ELEMENT_COLORS) | set(JM.ELEMENT_RADII)
                            | set(JM.COVALENT_RADII))
    for symbol in SYMBOLS + ["Xx", ""]:
        assert port(symbol) == ref(symbol), symbol
    assert port("Xx") == {"element_color": PE.DEFAULT_COLOR, "element_radius":
                          PE.DEFAULT_RADIUS, "covalent_radius":
                          PE.DEFAULT_COVALENT_RADIUS}[name]


def _hdr_image():
    """f32[9,300,3]: random radiance over six decades, rows of runs (RLE
    runs of 4 and more, and of 127 and more), zeros and tiny values (the
    RGBE zero exponent)."""
    rng = np.random.default_rng(7)
    img = (10.0 ** rng.uniform(-3, 3, (9, 300, 3))).astype(np.float32)
    img[1] = 0.0
    img[2, :150] = np.float32([0.25, 0.5, 1.0])
    img[3, ::2] = 1e-35
    img[4, 10:14] = np.float32(3.0)
    img[5] *= rng.integers(0, 2, (300, 1)).astype(np.float32)
    return img


def test_save_hdr_matches_jax_and_round_trips(tmp_path):
    img = _hdr_image()
    port_path, jax_path = tmp_path / "port.hdr", tmp_path / "jax.hdr"
    save_hdr(str(port_path), img)
    JH.save_hdr(str(jax_path), img)
    assert port_path.read_bytes() == jax_path.read_bytes()
    loaded = load_hdr(str(port_path))
    assert (loaded["width"], loaded["height"]) == (300, 9)
    assert np.array_equal(loaded["data"], JH.load_hdr(str(jax_path))["data"])
    back = loaded["data"][..., :3]
    # RGBE keeps 8 bits of mantissa under the pixel's largest channel, and
    # writes a pixel whose largest channel is below 1e-32 as zero.
    maxc = img.max(axis=-1, keepdims=True)
    tiny = np.broadcast_to(maxc < 1e-32, img.shape)
    assert tiny[3, ::2].all() and np.all(back[tiny] == 0.0) and np.all(back[1] == 0.0)
    assert np.all(np.abs(back - img)[~tiny] <= np.broadcast_to(maxc / 128.0, img.shape)[~tiny])


def _half_steps():
    """f32 values x whose f32 product x * 255 is exactly k + 0.5."""
    out = []
    for k in range(255):
        x = np.float32((k + 0.5) / 255.0)
        for cand in (x, np.nextafter(x, np.float32(0)), np.nextafter(x, np.float32(1))):
            if np.float32(cand) * np.float32(255.0) == np.float32(k + 0.5):
                out.append(cand)
    return np.array(out, np.float32)


def test_to_srgb_u8_matches_jax():
    halves = _half_steps()
    assert len(halves) > 100
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.float32([-1e9, -2.0, -1e-7, -0.0, 0.0, 1.0, 1.0 + 1e-7, 1.5, 255.0, 1e9]),
        rng.uniform(-1, 0, 64), rng.uniform(0, 1, 4096), rng.uniform(1, 3, 64),
        np.arange(256, dtype=np.float32) / np.float32(255.0), halves,
    ]).astype(np.float32)
    port = to_srgb_u8(torch.from_numpy(x.reshape(-1, 1).repeat(3, axis=1)))
    ref = np.asarray(JT.to_srgb_u8(x.reshape(-1, 1).repeat(3, axis=1)))
    assert port.dtype == torch.uint8 and ref.dtype == np.uint8
    assert np.array_equal(port.numpy(), ref)
    # Ties go to the even neighbour.
    got = to_srgb_u8(torch.from_numpy(halves)).numpy().astype(np.int64)
    assert np.all(got % 2 == 0)
