"""Tensor-parallel solve: shard one huge PSD block across devices.

The reference is single-process; for a single large block (side n in the
thousands) the scale-out is to lay the dense n x n projection work over a
mesh axis and let GSPMD insert the collectives (SURVEY.md §2.3 "TP" row).
We do this with ONE sharding constraint inside the PSD projection
(ops/cones.py consults `current_tp_mesh()`): the (n, n) matrix formed from
the packed triangle is constrained to PartitionSpec(tp, None), which makes
XLA shard the Lanczos matvecs / eigh workspace / rank-k reconstruction by
rows; dot products inside Lanczos become psum collectives (NCCL over
NVLink between GPUs).

Usage::

    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("tp",))
    res = solve_sharded(problem, mesh)
"""

from __future__ import annotations

import contextvars

import jax
import numpy as np

from ..options import Options
from ..result import Result

_TP_MESH: contextvars.ContextVar = contextvars.ContextVar("proxsdp_tp_mesh", default=None)
_TP_AXIS: contextvars.ContextVar = contextvars.ContextVar("proxsdp_tp_axis", default="tp")


def current_tp_mesh():
    """(mesh, axis_name) if a tensor-parallel solve is active, else None."""
    mesh = _TP_MESH.get()
    if mesh is None:
        return None
    return mesh, _TP_AXIS.get()


def solve_sharded(
    problem,
    mesh: jax.sharding.Mesh,
    options: Options | None = None,
    tp_axis: str = "tp",
    resume_from=None,
    **kwargs,
) -> Result:
    """Solve with the PSD-block work sharded over ``mesh[tp_axis]``."""
    from ..solver import solve

    opts = (options or Options()).replace(**kwargs)
    if tp_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {tp_axis!r}: {mesh.axis_names}")
    # tp_shards participates in the jit cache key so a sharded and an
    # unsharded solve of the same geometry compile separately
    opts = opts.replace(tp_shards=int(mesh.shape[tp_axis]))
    tok_m = _TP_MESH.set(mesh)
    tok_a = _TP_AXIS.set(tp_axis)
    try:
        # explicit NamedSharding in the constraint carries the mesh; no
        # ambient mesh context is needed under GSPMD auto mode
        return solve(problem, opts, resume_from=resume_from)
    finally:
        _TP_MESH.reset(tok_m)
        _TP_AXIS.reset(tok_a)
