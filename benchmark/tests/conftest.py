"""The benchmark's own tests: python -m pytest benchmark/tests (from the
root of the repository). Tests that need a CUDA device carry the "cuda"
marker and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")
