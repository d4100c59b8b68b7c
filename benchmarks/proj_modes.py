"""Per-iteration cost of each PSD projection engine at a given side.

Answers the standing verdict ask: "a recorded subspace-vs-eigh ms/iter at
side >= 800" — i.e. where the low-rank thesis (reference
src/eigsolver.jl, arXiv:1810.05231) must beat the dense eigh.

For one SDPLIB instance, runs a fixed number of f32 AND f64 iterations
under each projection engine through the REAL chunk runner (so the
comparison includes the full PDHG step, not just the kernel):

  * eigh      — dense eigendecomposition every iteration
  * subspace  — persistent-basis Rayleigh-Ritz (rank bucketed)
  * polar     — Newton-Schulz matrix-sign (f32 only; inexact by design)
  * lanczos   — static-shape full-reorth Lanczos (reference's engine
                shape; forced via full_eig_max_side=0)

Writes benchmarks/results/proj_modes_<inst>.csv.

Usage: python benchmarks/proj_modes.py [instance] [iters]
"""
import csv
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import proxsdp_tpu as px
from proxsdp_tpu.models.sdplib import sdplib_problem
from proxsdp_tpu.problem import preprocess, to_square_form
from proxsdp_tpu.solver import (
    Operands,
    _cached_runner,
    init_state,
)
from proxsdp_tpu.ops.linop import build_linop

DATA_DIR = os.environ.get("SDPLIB_DIR", "/root/reference/test/data")


def time_mode(setup, layout, opts, dtype, iters):
    """Seconds/iteration of the chunk runner under `opts` (warm)."""
    M = build_linop(setup.A, setup.G, dtype)
    operands = Operands(
        M=M,
        b=jnp.asarray(setup.b, dtype),
        h=jnp.asarray(setup.h, dtype),
        c=jnp.asarray(setup.c, dtype),
        norm_b=jnp.asarray(setup.norm_b, dtype),
        norm_h=jnp.asarray(setup.norm_h, dtype),
        norm_c=jnp.asarray(setup.norm_c, dtype),
        chunk_end=jnp.asarray(0, jnp.int32),
        obj_scale=jnp.asarray(setup.obj_scale * setup.rhs_scale, dtype),
        row_unscale=jnp.asarray(1.0, dtype),
    )
    run_chunk, _, _ = _cached_runner(layout, opts)
    state = init_state(layout, opts, setup)
    state = jax.tree_util.tree_map(jnp.asarray, state)
    # tolerances at 0 so status never flips inside the window
    warm_iters = max(iters // 4, 8)
    state = run_chunk(
        state, operands._replace(chunk_end=jnp.asarray(warm_iters, jnp.int32))
    )
    jax.block_until_ready(state.x)
    t0 = time.time()
    state = run_chunk(
        state,
        operands._replace(chunk_end=jnp.asarray(warm_iters + iters, jnp.int32)),
    )
    jax.block_until_ready(state.x)
    dt = (time.time() - t0) / iters
    return dt, int(state.iter)


def main():
    inst = sys.argv[1] if len(sys.argv) > 1 else "maxG11"
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    path = os.path.join(DATA_DIR, f"{inst}.dat-s")
    base = px.Options(tol_gap=0.0, tol_feasibility=0.0, max_iter=10**9)
    problem, _ = sdplib_problem(path, base)
    setup = to_square_form(preprocess(problem))
    layout = setup.layout
    side = max(layout.sdp_sides)
    k_sub = 48 if side >= 96 else max(side // 4, 4)

    modes = [
        # (label, dtype, option overrides)
        ("eigh_f32", jnp.float32, dict(dtype="float32",
                                       hybrid_precision=False)),
        ("subspace_f32", jnp.float32, dict(dtype="float32",
                                           hybrid_precision=False,
                                           subspace_rank=k_sub,
                                           subspace_fallback="polar")),
        ("polar_f32", jnp.float32, dict(dtype="float32",
                                        hybrid_precision=False,
                                        projection="polar")),
        ("lanczos_f32", jnp.float32, dict(dtype="float32",
                                          hybrid_precision=False,
                                          full_eig_max_side=0,
                                          min_size_krylov_eigs=8)),
        ("eigh_f64", jnp.float64, dict(dtype="float64",
                                       hybrid_precision=False)),
        ("subspace_f64", jnp.float64, dict(dtype="float64",
                                           hybrid_precision=False,
                                           subspace_rank=k_sub)),
    ]
    try:
        commit = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(__file__)) or ".",
             "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        commit = "unknown"
    out = os.path.join(
        os.path.dirname(__file__), "results", f"proj_modes_{inst}.csv"
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    f = open(out, "w", newline="")
    w = csv.DictWriter(f, fieldnames=[
        "instance", "side", "mode", "ms_per_iter", "iters", "backend",
        "commit",
    ])
    w.writeheader()
    f.flush()
    for label, dtype, kw in modes:
        opts = base.replace(**kw)
        try:
            dt, it = time_mode(setup, layout, opts, dtype, iters)
        except Exception as e:
            print(f"{label}: FAIL {type(e).__name__}: {e}", flush=True)
            continue
        w.writerow(dict(instance=inst, side=side, mode=label,
                        ms_per_iter=round(dt * 1e3, 3), iters=it,
                        backend=jax.default_backend(), commit=commit))
        f.flush()
        print(f"{label}: {dt*1e3:.3f} ms/iter (side {side})", flush=True)
        jax.clear_caches()
    f.close()
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
