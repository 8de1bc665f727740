"""The port's orbit camera (scene/camera.py) against the JAX package's.

Host numpy f64 on both sides with the same operation order, so every
result must be equal bit for bit: seeded drag sequences through
apply_orbit_drag (steep pitches included, so that the pole clamp rejects
some), the first-drag axis lock, OrbitCamera.drag and .fly for each key
and their combinations, and camera_ray_from_pixel at the centre, the
corners and off the canvas.
"""

import itertools

import numpy as np
import pytest

from webgl_raytracer_tpu.scene import camera as JC
from webgl_raytracer_tpu_torch.scene import camera as PC


def _random_rotation(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


@pytest.mark.parametrize("seed", range(6))
def test_orbit_drag_sequences_equal(seed):
    """30 drags from the upright camera (even seeds) or a random rotation;
    dy up to 600 px (2.4 rad of pitch), so that from upright the pole
    clamp keeps the old pitch on some of them."""
    rng = np.random.default_rng(seed)
    upright = seed % 2 == 0
    jq = pq = np.array([0.0, 0.0, 0.0, 1.0]) if upright else _random_rotation(rng)
    clamped = 0
    for _ in range(30):
        dx, dy = rng.uniform(-300, 300), rng.uniform(-600, 600)
        kw = {}
        if rng.random() < 0.3:
            kw = dict(rotate_speed=float(rng.uniform(0.001, 0.01)),
                      pole_limit_y=float(rng.uniform(0.5, 1.0)))
        jn, pn = JC.apply_orbit_drag(jq, dx, dy, **kw), PC.apply_orbit_drag(pq, dx, dy, **kw)
        assert jn.tobytes() == pn.tobytes()
        yawed = PC.apply_orbit_drag(pq, dx, 0.0, **kw)
        clamped += int(np.array_equal(pn, yawed))
        jq, pq = jn, pn
    assert clamped > 0 or not upright, "no drag hit the pole clamp"


@pytest.mark.parametrize("seed", range(3))
def test_quaternion_helpers_equal(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        axis, angle = rng.normal(size=3), float(rng.uniform(-7, 7))
        a, b = rng.normal(size=4), rng.normal(size=4)
        v = rng.normal(size=3)
        pairs = ((JC.normalize_quat(a), PC.normalize_quat(a)),
                 (JC.quat_from_axis_angle(axis, angle), PC.quat_from_axis_angle(axis, angle)),
                 (JC.quat_multiply(a, b), PC.quat_multiply(a, b)),
                 (JC.quat_rotate_vec(a, v), PC.quat_rotate_vec(a, v)))
        for j, p in pairs:
            assert j.tobytes() == p.tobytes()
    assert PC.normalize_quat([0, 0, 0, 0]).tobytes() == JC.normalize_quat([0, 0, 0, 0]).tobytes()


LOCK_SEQUENCES = [
    [(0.5, 0.5), (1.9, -1.9), (2.0, 1.0), (0.0, 9.0)],     # resolves to yaw at the 3rd
    [(1.0, 3.0), (50.0, 0.0)],                             # pitch, then kept
    [(-2.0, 2.0), (0.0, -40.0)],                           # a tie goes to yaw
    [(0.0, 0.0), (0.1, -1.99), (0.0, -2.0)],               # pitch at the threshold
]


@pytest.mark.parametrize("seq", range(len(LOCK_SEQUENCES)))
def test_rotation_lock_state_machine_equal(seq):
    jl = pl = None
    states = []
    for dx, dy in LOCK_SEQUENCES[seq]:
        jl, pl = JC.resolve_rotation_lock(jl, dx, dy), PC.resolve_rotation_lock(pl, dx, dy)
        assert jl == pl
        states.append(pl)
    assert states[-1] in ("yaw", "pitch")
    for threshold in (0.5, 5.0):
        assert JC.resolve_rotation_lock(None, 3.0, -4.0, threshold) == \
            PC.resolve_rotation_lock(None, 3.0, -4.0, threshold)


def _cameras(seed, **kw):
    rng = np.random.default_rng(seed)
    state = dict(target=rng.normal(size=3), distance=float(rng.uniform(1, 30)),
                 rotation=_random_rotation(rng), width=64, height=48, **kw)
    return JC.OrbitCamera(**state), PC.OrbitCamera(**state)


def _same(jc, pc):
    for name in ("target", "rotation"):
        assert np.asarray(getattr(jc, name)).tobytes() == \
            np.asarray(getattr(pc, name)).tobytes(), name
    jb, pb = jc.basis(), pc.basis()
    for name in ("origin", "forward", "right", "up"):
        assert getattr(jb, name).tobytes() == getattr(pb, name).tobytes(), name


KEY_SETS = ([k] for k in "wasdqe")
KEY_SETS = [*KEY_SETS, ["w", "d"], ["s", "a", "q"], list("wasdqe"), ["x"], [], ["w", "x"]]


@pytest.mark.parametrize("keys", KEY_SETS, ids=["".join(k) or "none" for k in KEY_SETS])
def test_fly_equal(keys):
    jc, pc = _cameras(7)
    for dt in (0.016, 0.1, 1.5):
        assert jc.fly(keys, dt) == pc.fly(keys, dt)
        _same(jc, pc)


def test_orbit_camera_drag_equal():
    jc, pc = _cameras(8)
    rng = np.random.default_rng(9)
    for _ in range(25):
        dx, dy = rng.uniform(-200, 200, size=2)
        jc.drag(dx, dy)
        pc.drag(dx, dy)
        _same(jc, pc)


PIXELS = [(32.0, 24.0), (0.0, 0.0), (64.0, 0.0), (0.0, 48.0), (64.0, 48.0), (0.5, 47.5),
          (-20.0, 10.0), (100.0, -30.0), (31.7, 500.0)]


@pytest.mark.parametrize("seed", range(3))
def test_camera_ray_from_pixel_equal(seed):
    jc, pc = _cameras(20 + seed, fov=float(np.pi / (3 + seed)))
    jb, pb = jc.basis(), pc.basis()
    for x, y in PIXELS:
        assert JC.camera_ray_from_pixel(jb, x, y).tobytes() == \
            PC.camera_ray_from_pixel(pb, x, y).tobytes(), (x, y)
    degenerate = PC.CameraBasis(np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3), 4, 4)
    with pytest.raises(ValueError):
        PC.camera_ray_from_pixel(degenerate, 2, 2)


def test_fit_to_bounds_equal():
    for lo, hi in itertools.product(([-1.0, -2.0, -3.0], [0.0, 0.0, 0.0]),
                                    ([4.0, 5.0, 6.0], [1e-5, 0.0, 0.0])):
        jc, pc = _cameras(30)
        jc.fit_to_bounds(lo, hi)
        pc.fit_to_bounds(lo, hi)
        _same(jc, pc)
        assert jc.distance == pc.distance
