"""The tensor-core probe's plain version against the JAX package's K5 kernel.

``scripts/mxu_probe.py:make_bench`` builds the Pallas kernel
acc[M, N] = sum_{i < iters} a[(i % 8) M : (i % 8 + 1) M] @ b (bf16 operands,
float32 accumulation).  Here it runs in Pallas interpret mode
(``pallas_call`` patched with ``interpret=True``; the script is not edited),
and the port's ``mxu_probe_reference`` takes the same seeded bf16 inputs.
Measured gap: about 1.2e-7 of the output's largest entry (float32 sums in
another order); the tolerance is 1e-6 of it.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from navier_stokes_tpu_torch.scripts import mxu_probe as tp

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "mxu_probe.py"
ITERS = 11


@functools.lru_cache(maxsize=None)
def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_mxu_probe", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(M, seed=0):
    """Seeded bf16 operands, as torch tensors and as the exact float32
    values they hold."""
    rng = np.random.default_rng(seed + M)
    a = torch.as_tensor(rng.standard_normal((8 * M, tp.K)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((tp.K, tp.N)), dtype=torch.float32)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    return a, b, a.float().numpy(), b.float().numpy()


@pytest.mark.parametrize("M", [8, 16, 144])
def test_plain_matches_jax_kernel(M, monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    a, b, a32, b32 = _inputs(M)
    run = _jax_script().make_bench(M, tp.K, tp.N, ITERS)
    want = np.asarray(run(jnp.asarray(a32, jnp.bfloat16), jnp.asarray(b32, jnp.bfloat16)))
    got = tp.mxu_probe_reference(a, b, M, ITERS).numpy()
    assert got.shape == want.shape == (M, tp.N) and got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale, np.abs(got - want).max() / scale


def test_wrapper_on_cpu_takes_plain_version():
    """A CPU tensor goes to the plain version; no kernel launch is counted."""
    a, b, _, _ = _inputs(16, seed=1)
    before = tp.mxu_probe.launches
    got = tp.mxu_probe(a, b, 16, 5)
    assert tp.mxu_probe.launches == before
    assert torch.equal(got, tp.mxu_probe_reference(a, b, 16, 5))
