"""The window's arithmetic: frame time over the window, the nearest-rank
95th percentile, the turns, on synthetic frames with one stall."""

from benchmark.harness.window import percentile, run_window


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_percentile_nearest_rank():
    assert percentile([1, 2, 3, 4], 50) == 2
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([5.0], 95) == 5.0


def test_window_with_one_stall():
    clock = FakeClock()
    frame = 1 / 64                                 # exact in binary
    times = iter([frame] * 16 + [0.5] + [frame] * 30)
    turns = []

    def render():
        clock.now += next(times)
        return True

    w = run_window(render, lambda: turns.append(clock.now), frames_per_view=8,
                   seconds=1.0, clock=clock)
    # 16 frames of 1/64 s, the 500 ms stall, then 16 frames to one second.
    assert len(w.frame_s) == 33
    assert w.seconds == 1.0
    assert abs(w.frame_ms() - 1000.0 / 33) < 1e-9
    assert w.p95_ms() == 1000.0 * frame            # 1 stall in 33: below the 95th rank
    assert len(turns) == 4 and w.views == 5 and w.frames_in_view == 1
    assert w.failed == 0


def test_two_stalls_in_twenty_frames_reach_the_p95():
    clock = FakeClock()
    times = iter([0.01] * 9 + [0.3] + [0.01] * 8 + [0.3, 0.01])

    def render():
        clock.now += next(times)
        return True

    w = run_window(render, lambda: None, frames_per_view=100, seconds=10.0, max_frames=20,
                   clock=clock)
    assert len(w.frame_s) == 20
    assert abs(w.p95_ms() - 300.0) < 1e-6


def test_failed_frames_are_counted():
    clock = FakeClock()

    def render():
        clock.now += 0.1
        return False

    w = run_window(render, lambda: None, 100, seconds=0.25, clock=clock)
    assert w.failed == len(w.frame_s) == 3


def test_orbit_covers_the_whole_orbit_in_every_round():
    """Each round of views_per_round views takes one azimuth in each
    sector of the circle and one forward.y in each band, within the pole
    limit, at the fitted distance; another seed gives other views."""
    import numpy as np

    from benchmark.harness import traffic as TRAFFIC
    from benchmark.reference import camera as CAM

    k = 12
    traffic = {"views_per_round": k, "pole_limit_y": 0.995}
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    _, distance = CAM.fit_camera(lo, hi, 1.0)

    def forwards(seed):
        orbit = TRAFFIC.views(traffic, 1.0, lo, hi, seed)
        views = [next(orbit) for _ in range(2 * k)]
        assert all(v["distance"] == distance for v in views)
        return np.array([CAM.quat_rotate(v["rotation"], (0.0, 0.0, 1.0)) for v in views])

    for seed in (2**31 + 7, 3):
        f = forwards(seed)
        for r in range(2):
            rnd = f[r * k:(r + 1) * k]
            azimuth = np.degrees(np.arctan2(rnd[:, 0], rnd[:, 2])) % 360.0
            assert sorted((azimuth // (360.0 / k)).astype(int)) == list(range(k))
            band = np.floor((-rnd[:, 1] / 0.995 + 1.0) / 2.0 * k).astype(int)
            assert sorted(band) == list(range(k))
    assert not np.allclose(forwards(3), forwards(4))
