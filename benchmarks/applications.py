"""Application-suite benchmark — the reference runbench.jl's RANDSDP /
SENSORLOC / MIMO sections (test/runbench.jl:102-116).

Usage:
    python benchmarks/applications.py [--set mini|full] [--tol 1e-6]
                                      [--out applications.csv]

mini = the reference's precompile workload (run_mini_benchmark.jl:37-70):
RANDSDP 10x10 + SENSORLOC n=50.  full = runbench's sweep sizes, capped to
what a single chip/host finishes in minutes (SENSORLOC n in {100,200},
MIMO n in {100,500}; extend via --sensorloc-n/--mimo-n).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_mimo(seed, n, opts):
    from proxsdp_tpu.models.mimo import mimo_eval, mimo_problem
    from proxsdp_tpu.solver import solve

    problem, Xidx, s_true = mimo_problem(seed, n, opts)
    t0 = time.time()
    res = solve(problem, opts)
    dt = time.time() - t0
    _, decode_err, _ = mimo_eval(s_true, res.primal[Xidx])
    return res, dt, {"decode_err": round(float(decode_err), 6)}


def run_sensorloc(seed, n, opts):
    from proxsdp_tpu.models.sensorloc import sensorloc_problem
    from proxsdp_tpu.solver import solve

    problem = sensorloc_problem(seed, n, opts)[0]
    t0 = time.time()
    res = solve(problem, opts)
    return res, time.time() - t0, {}


def run_randsdp(seed, n, m, opts):
    from proxsdp_tpu.models.randsdp import randsdp_problem
    from proxsdp_tpu.solver import solve

    problem = randsdp_problem(seed, n, m, opts, varbounds=False)[0]
    t0 = time.time()
    res = solve(problem, opts)
    return res, time.time() - t0, {}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", default="mini", choices=["mini", "full"])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--time-limit", type=float, default=300.0)
    ap.add_argument("--out", default="applications.csv")
    ap.add_argument("--backend", default="",
                    help="force a jax platform (e.g. 'cpu')")
    ap.add_argument("--only", default="",
                    help="comma-separated family:n filters, e.g. "
                    "'sensorloc:300,sensorloc:400' (empty = whole set)")
    ap.add_argument("--opt", action="append", default=[],
                    metavar="KEY=VAL",
                    help="solver Options override, repeatable (typed by "
                    "the field's current default)")
    args = ap.parse_args()

    if args.backend:
        import jax as _jax

        _jax.config.update("jax_platforms", args.backend)

    import proxsdp_tpu as px

    # max_iter lifted to 10M: the wall-clock cap is the real budget here
    # (runbench.jl:39-44), and the degenerate-dual applications legitimately
    # take millions of cheap iterations (MIMO n=50: 654k to rank-1 optimal)
    opts = px.Options(
        tol_gap=args.tol, tol_feasibility=args.tol,
        time_limit=args.time_limit, max_iter=10_000_000,
    )
    if args.opt:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from parity import _parse_opts  # same KEY=VAL typing rules

        opts = opts.replace(**_parse_opts(args.opt, opts))

    # varbounds=False everywhere: the reference's mini benchmark solves
    # RANDSDP without the +-10 box bounds (run_mini_benchmark.jl:37-40),
    # and its CI disables the bounded variant as too hard for PDHG
    # (moitest.jl:110-114)
    if args.set == "mini":
        jobs = [("randsdp", dict(seed=0, n=10, m=10)),
                ("sensorloc", dict(seed=0, n=50))]
    else:
        # the reference's full runbench sweep (test/runbench.jl:102-116):
        # RANDSDP 5x5, SENSORLOC n in 100..400, MIMO n in {100,500,1000}
        jobs = (
            [("randsdp", dict(seed=s, n=5, m=5)) for s in range(1)]
            + [("sensorloc", dict(seed=0, n=n)) for n in (100, 200, 300, 400)]
            + [("mimo", dict(seed=0, n=n)) for n in (100, 500, 1000)]
        )

    if args.only:
        keep = set(args.only.split(","))
        jobs = [
            (fam, kw) for fam, kw in jobs
            if f"{fam}:{kw.get('n', '')}" in keep
        ]

    import subprocess

    import jax

    try:
        commit = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(__file__)) or ".",
             "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        commit = "unknown"

    rows = []
    for fam, kw in jobs:
        try:
            if fam == "mimo":
                res, dt, extra = run_mimo(kw["seed"], kw["n"], opts)
            elif fam == "sensorloc":
                res, dt, extra = run_sensorloc(kw["seed"], kw["n"], opts)
            else:
                res, dt, extra = run_randsdp(kw["seed"], kw["n"], kw["m"], opts)
        except Exception as e:  # device runtime faults: log and continue
            print(f"{fam} {kw}: CRASH {type(e).__name__}: {e}", flush=True)
            continue
        row = dict(
            family=fam, params=str(kw), status=res.status,
            time_s=round(dt, 2), obj=round(res.objval, 6),
            gap=f"{res.gap:.2e}", rank=res.final_rank, iters=res.iter,
            backend=jax.default_backend(), commit=commit,
            **extra,
        )
        rows.append(row)
        print(
            f"{fam} {kw}: st={res.status} t={dt:.1f}s obj={res.objval:.5f} "
            f"gap={res.gap:.1e} rank={res.final_rank} {extra}",
            flush=True,
        )
        import gc

        gc.collect()
        jax.clear_caches()

    keys = sorted({k for r in rows for k in r}, key=lambda s: s != "family")
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
