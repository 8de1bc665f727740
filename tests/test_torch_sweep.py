"""The sweep probe's plain version (webgl_raytracer_tpu_torch.tools.sweep_sol)
against the TPU probe kernel it replaces (tools/vpu_sol.py make_kernel).

The kernel body runs eagerly, op by op, on array-backed refs (its
fori_loop given a concrete int32 index): then every f32 operation rounds
as the plain version's does and the rows must agree bit for bit. Through
pl.pallas_call in interpret mode XLA compiles the body and contracts
products and sums into FMAs, and the discriminant b*b - c cancels, so
there the rows agree within rtol 1e-2 (measured 3.8e-3) and at least half
of them exactly. In bf16 both round every operation to bf16 and agree bit
for bit either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools.vpu_sol import B, C, make_kernel
from webgl_raytracer_tpu_torch.tools import sweep_sol as SW

ITERS = [1, 3, 13, 16]   # 1 and 13: sweeps off the 8-sweep centre cycle
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


class _Ref:
    """A kernel ref over a JAX array: indexing with slices and pl.ds."""

    def __init__(self, x):
        self.x = x

    @staticmethod
    def _index(key):
        key = key if isinstance(key, tuple) else (key,)
        return tuple(slice(int(k.start), int(k.start) + k.size) if hasattr(k, "size")
                     and not isinstance(k, slice) else k for k in key)

    def __getitem__(self, key):
        return self.x[self._index(key)]

    def __setitem__(self, key, value):
        self.x = self.x.at[self._index(key)].set(value)


def _eager_kernel(iters, dtype, a, s, monkeypatch):
    def fori_loop(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(jnp.int32(i), carry)
        return carry

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    out = _Ref(jnp.zeros((B,), jnp.float32))
    with jax.disable_jit():
        make_kernel(iters, dtype)(_Ref(jnp.asarray(a)), _Ref(jnp.asarray(s)), out,
                                  _Ref(jnp.zeros((B, C), dtype)))
    return np.asarray(out.x)


def _pallas_interpret(iters, dtype, a, s):
    fn = pl.pallas_call(
        make_kernel(iters, dtype),
        out_shape=jax.ShapeDtypeStruct((B,), jnp.float32),
        in_specs=[pl.BlockSpec((B, 16), lambda: (0, 0)),
                  pl.BlockSpec((24, C), lambda: (0, 0))],
        out_specs=pl.BlockSpec((B,), lambda: (0,)),
        scratch_shapes=[pltpu.VMEM((B, C), dtype)], interpret=True)
    return np.asarray(fn(jnp.asarray(a), jnp.asarray(s)))


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_plain_matches_kernel_body_exactly(iters, jdt, tdt, monkeypatch):
    a, s = SW.probe_inputs("cpu")
    got = SW.sweep_plain(a, s, iters, tdt).numpy()
    want = _eager_kernel(iters, jdt, a.numpy(), s.numpy(), monkeypatch)
    assert (got < 1e19).sum() > B // 2
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_zero_iters_gives_no_hit_on_every_row(jdt, tdt, monkeypatch):
    """No sweep: every row keeps the initial 1e20 (rounded to the compute
    type), in the plain version and in the kernel body."""
    a, s = SW.probe_inputs("cpu")
    got = SW.sweep_plain(a, s, 0, tdt).numpy()
    want = _eager_kernel(0, jdt, a.numpy(), s.numpy(), monkeypatch)
    no_hit = np.float32(torch.tensor(1e20, dtype=tdt).float())
    assert got.shape == (B,)
    assert np.array_equal(got.view(np.uint32), np.full(B, no_hit).view(np.uint32))
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_plain_matches_pallas_interpret(jdt, tdt):
    a, s = SW.probe_inputs("cpu")
    got = SW.sweep_plain(a, s, 16, tdt).numpy()
    want = _pallas_interpret(16, jdt, a.numpy(), s.numpy())
    if jdt == jnp.bfloat16:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2)
        assert (got == want).mean() >= 0.5


def test_wrapper_takes_plain_version_on_cpu():
    a, s = SW.probe_inputs("cpu")
    before = SW.launches["sweep_sol"]
    assert torch.equal(SW.sweep_sol(a, s, 4), SW.sweep_plain(a, s, 4))
    assert SW.launches["sweep_sol"] == before
    with pytest.raises(ValueError):
        SW.sweep_sol(a, s, 4, dtype=torch.float16)
    assert SW.probe_ops(1) == 24 * B * C
