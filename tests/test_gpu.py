"""Checks that need an NVIDIA GPU (marker ``gpu``; they skip elsewhere).

Run them on a card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from proxsdp_tpu.ops.precision import full_f32

pytestmark = pytest.mark.gpu


def test_full_f32_matmul_on_gpu(gpu):
    """Under the precision policy an f32 matmul keeps f32 accuracy (a
    TF32 pass would leave ~1e-3 relative error)."""
    rng = np.random.RandomState(0)
    a = rng.randn(1024, 1024)
    b = rng.randn(1024, 1024)
    out = jax.jit(full_f32(lambda x, y: x @ y))(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)
    )
    ref = a.astype(np.float32).astype(np.float64) @ b.astype(
        np.float32
    ).astype(np.float64)
    err = np.linalg.norm(np.asarray(out, np.float64) - ref) / np.linalg.norm(ref)
    assert err < 1e-5, err


def test_projection_engines_on_gpu(gpu):
    for rec in cs.engine_records(250, reps=1):
        assert rec["ok"], rec


def test_maxcut_solve_on_gpu(gpu, tmp_path):
    rec = cs.phase_mcp(dict(card="", out=str(tmp_path)), side=60,
                       density=0.1, trace=False)
    assert rec["certified_gap"] <= cs.CERT_GAP
