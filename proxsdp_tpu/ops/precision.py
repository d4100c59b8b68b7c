"""The solver's one matmul-precision policy.

Every program that runs the PDHG iteration or a PSD projection is traced
under full-f32 matmul precision, so no f32 product runs in a reduced
format (TF32 on NVIDIA tensor cores, bfloat16 passes elsewhere).  A
reduced-precision pass keeps about 3 decimal digits: it floors the f32
race phase near 1e-3 residuals and makes the subspace acceptance test
reject every step.  f64 products are unaffected.

Apply it at the jit boundary (``jax.jit(full_f32(fn))``), not call by call.
Whether TF32 can pay anywhere in the f32 race is an open measurement.
"""

from __future__ import annotations

import functools

import jax


def full_f32(fn):
    """Wrap ``fn`` so that it traces with every matmul at full f32."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
