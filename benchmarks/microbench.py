"""Microbenchmark: per-op device cost of the PDHG iteration's pieces.

Times (on the default backend) the small dense linalg that bounds the
subspace projection's latency, plus one full compiled iteration in each
phase configuration for SDPLIB mcp250-1.  Used to direct optimization:
the iteration is latency-bound (FLOPs are trivial for side<=500), so the
question is always WHICH small op dominates.

Usage: python benchmarks/microbench.py [--side 250] [--k 25] [--reps 50]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timeit(fn, *args, reps=50):
    """Time fn with a DEPENDENT chain: each call's first arg is derived
    from the previous call's output (via a cheap normalized mix), so no
    backend-side memoization of identical (program, args) pairs and no
    deep pipelining can shortcut the measurement."""
    import jax
    import jax.numpy as jnp

    x0 = args[0]
    rest = args[1:]

    def mix(x, out):
        # fold the output back into the input, preserving pytree structure
        leaves = [v for v in jax.tree_util.tree_leaves(out)
                  if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating)]
        s = jnp.sum(jnp.abs(leaves[0])) if leaves else jnp.asarray(0.0)

        def bump(v):
            if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating):
                return v * (1.0 + 1e-12 * s.astype(v.dtype))
            return v

        return jax.tree_util.tree_map(bump, x)

    mix = jax.jit(mix)
    out = fn(x0, *rest)
    x = mix(x0, out)
    jax.block_until_ready(x)
    t0 = time.time()
    for _ in range(reps):
        out = fn(x, *rest)
        x = mix(x, out)
    jax.block_until_ready(x)
    return (time.time() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=250)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--backend", default="")
    args = ap.parse_args()

    import jax

    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    import jax.numpy as jnp

    import proxsdp_tpu  # noqa: F401  (x64 + compile cache config)
    from proxsdp_tpu.ops.precision import full_f32

    n, k = args.side, args.k
    rng = np.random.RandomState(0)
    A = rng.randn(n, n)
    A = (A + A.T) / 2
    Vk = np.linalg.qr(rng.randn(n, k))[0]
    Bk = Vk.T @ A @ Vk
    Bk = (Bk + Bk.T) / 2

    print(f"backend={jax.default_backend()} side={n} k={k}", file=sys.stderr)

    for dt, tag in ((jnp.float32, "f32"), (jnp.float64, "f64")):
        Ad = jnp.asarray(A, dt)
        Vd = jnp.asarray(Vk, dt)
        Bd = jnp.asarray(Bk, dt)

        r = {}
        r["eigh_full(n)"] = timeit(
            jax.jit(lambda X: jnp.linalg.eigh(X)[1]), Ad, reps=max(args.reps // 5, 5)
        )
        r["eigh_small(k)"] = timeit(
            jax.jit(lambda X: jnp.linalg.eigh(X)[1]), Bd, reps=args.reps
        )
        r["cholesky(k)"] = timeit(
            jax.jit(lambda X: jnp.linalg.cholesky(X + 2 * k * jnp.eye(k, dtype=dt))),
            Bd, reps=args.reps,
        )
        r["tri_solve(k,n)"] = timeit(
            jax.jit(
                lambda X, V: jax.scipy.linalg.solve_triangular(
                    jnp.linalg.cholesky(X + 2 * k * jnp.eye(k, dtype=dt)),
                    V.T, lower=True,
                )
            ),
            Bd, Vd, reps=args.reps,
        )
        # matmuls at the solver's precision policy (ops/precision.py)
        r["matmul(n,n)@(n,k)"] = timeit(
            jax.jit(full_f32(lambda X, V: X @ V)), Ad, Vd, reps=args.reps
        )
        r["rank_k(n,k)@(k,n)"] = timeit(
            jax.jit(full_f32(lambda V: V @ V.T)), Vd, reps=args.reps
        )
        r["qr(n,k)"] = timeit(
            jax.jit(lambda V: jnp.linalg.qr(V)[0]), Vd, reps=max(args.reps // 5, 5)
        )

        # the actual subspace projection body (one full call)
        from proxsdp_tpu.ops.cones import psd_projection_block
        from proxsdp_tpu.ops.tri import square_to_tri
        from proxsdp_tpu.options import Options

        opt = Options(dtype="float64" if dt == jnp.float64 else "float32",
                      subspace_rank=k)
        vtri = square_to_tri(Ad, n)
        proj = jax.jit(full_f32(
            lambda v, w: psd_projection_block(
                v, n, jnp.asarray(k, jnp.int32), w, opt=opt,
                allow_lanczos=False,
            ).block
        ))
        r["subspace_proj"] = timeit(proj, vtri, Vd, reps=args.reps)

        for name, v in r.items():
            print(f"  [{tag}] {name:<22} {v*1e3:9.3f} ms", file=sys.stderr)

    # one full compiled iteration on mcp250-1 state (both dtypes)
    from proxsdp_tpu.models.sdplib import sdplib_problem
    from proxsdp_tpu.options import Options
    from proxsdp_tpu.problem import preprocess
    from proxsdp_tpu.ops.linop import build_linop
    from proxsdp_tpu.solver import Operands, init_state, make_chunk_runner

    path = os.environ.get(
        "MB_INSTANCE", "/root/reference/test/data/mcp250-1.dat-s"
    )
    if os.path.exists(path):
        problem, _ = sdplib_problem(path)
        setup = preprocess(problem)
        layout = setup.layout
        for dtype, tag, sub in (
            (jnp.float32, "f32 eigh", 0),
            (jnp.float32, "f32 sub", args.k),
            (jnp.float64, "f64 eigh", 0),
            (jnp.float64, "f64 sub", args.k),
        ):
            opts = Options(
                dtype="float64" if dtype == jnp.float64 else "float32",
                subspace_rank=sub,
            )
            M = build_linop(setup.A, setup.G, dtype)
            o = Operands(
                M=M,
                b=jnp.asarray(setup.b, dtype),
                h=jnp.asarray(setup.h, dtype),
                c=jnp.asarray(setup.c, dtype),
                norm_b=jnp.asarray(setup.norm_b, dtype),
                norm_h=jnp.asarray(setup.norm_h, dtype),
                norm_c=jnp.asarray(setup.norm_c, dtype),
                chunk_end=jnp.asarray(10_000_000, jnp.int32),
                obj_scale=jnp.asarray(setup.obj_scale * setup.rhs_scale, dtype),
                row_unscale=jnp.asarray(1.0, dtype),
            )
            s = init_state(layout, opts, setup)
            if sub:
                # seed a (side, k) warm basis so the subspace path engages
                s = s._replace(
                    warm=tuple(
                        jnp.asarray(Vk[: sd, :], dtype)
                        for sd in layout.sdp_sides
                    )
                )
            run_chunk, iteration, _ = make_chunk_runner(layout, opts)
            it = jax.jit(iteration)
            dt_it = timeit(it, s, o, reps=max(args.reps // 5, 10))
            print(f"  [iter {tag:<9}] one iteration    {dt_it*1e3:9.3f} ms "
                  "(jit per-call, includes dispatch)", file=sys.stderr)
            # amortized: run a 200-iteration chunk; verify the loop actually
            # ran that many iterations (a nonzero status exits early)
            n_it = 200
            o2 = o._replace(chunk_end=jnp.asarray(n_it, jnp.int32))
            out = run_chunk(s._replace(), o2)
            jax.block_until_ready(out.x)
            k1 = int(out.iter)
            o3 = o._replace(chunk_end=jnp.asarray(k1 + n_it, jnp.int32))
            t0 = time.time()
            out = run_chunk(out, o3)
            jax.block_until_ready(out.x)
            dt_wall = time.time() - t0
            ran = int(out.iter) - k1
            dt_chunk = dt_wall / max(ran, 1)
            print(f"  [iter {tag:<9}] amortized/chunk  {dt_chunk*1e3:9.3f} ms "
                  f"(ran {ran}/{n_it} iters, status={int(out.status)})",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
