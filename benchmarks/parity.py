"""SDPLIB parity harness — the reference's benchmark suite.

Mirrors test/runbench.jl (reference: instance sets :102-156, 5-min cap
:39-44, CSV columns :88-96): for each instance, solve and log
  class, instance, status, time, objective, final rank,
  linear-constraint violation, PSD violation (most-negative eigenvalue),
  |obj - published| when the SDPLIB optimum is known.

Usage:
    python benchmarks/parity.py [--set mini|mcp|gpp|full] [--tol 1e-4]
                                [--time-limit 300] [--out parity.csv]

Published optima: SDPLIB 1.2 (Borchers), via the problem set's README —
values quoted to the precision commonly reported.
"""

from __future__ import annotations

import argparse

import jax
import csv
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATA_DIR = os.environ.get("SDPLIB_DIR", "/root/reference/test/data")

# SDPLIB published optimal objective values (primal, in SDPLIB's min
# convention; the .dat-s parser returns problems whose solved objective
# matches -value for the mcp/gpp families as in the reference's tests).
PUBLISHED = {
    "mcp124-1": 141.990,
    "mcp124-2": 269.880,
    "mcp124-3": 467.750,
    "mcp124-4": 864.412,
    "mcp250-1": 317.2643,
    "mcp250-2": 531.930,
    "mcp250-3": 981.172,
    "mcp250-4": 1681.960,
    "mcp500-1": 598.1485,
    "mcp500-2": 1070.057,
    "mcp500-3": 1847.970,
    "mcp500-4": 3566.738,
    "gpp124-1": -7.3431,
    "gpp124-2": -46.8623,
    "gpp124-3": -153.0141,
    "gpp124-4": -418.9876,
    "gpp250-1": -15.4449,
    "gpp250-2": -81.869,
    "gpp250-3": -303.539,
    "gpp250-4": -747.3283,
    "gpp500-1": -25.320,
    "gpp500-2": -156.060,
    "gpp500-3": -513.018,
    "gpp500-4": -1567.02,
    # remaining SDPLIB 1.2 families shipped in /root/reference/test/data
    # (values from Borchers' SDPLIB 1.2 table; the reference repo ships
    # the data but publishes no targets for these)
    "theta1": 23.00,
    "theta2": 32.879,
    "theta3": 42.167,
    "theta4": 50.321,
    "theta5": 57.232,
    "theta6": 63.477,
    "thetaG11": 400.00,
    "thetaG51": 349.00,
    "arch0": 0.566517,
    "arch2": 0.671515,
    "arch4": 0.9726274,
    "arch8": 7.05698,
    "control1": 17.78463,
    "control2": 8.300000,
    "control3": 13.63327,
    "control4": 19.79423,
    "control5": 16.8836,
    "control6": 37.3044,
    "control7": 20.6251,
    "control8": 20.286,
    "truss1": -8.999996,
    "truss2": -123.3804,
    "truss3": -9.109996,
    "truss4": -9.009996,
    "truss5": -132.6357,
    "truss6": -901.0014,
    "truss7": -900.0014,
    "truss8": -133.1146,
    "qap5": -436.00,
    "qap6": -381.44,
    "qap7": -425.00,
    "qap8": -757.00,
    "qap9": -1410.0,
    "qap10": -1093.0,
    "maxG11": 629.1648,
    "maxG32": 1567.640,
    "maxG51": 4003.809,
    "qpG11": 2448.659,
    "qpG51": 1181.000,
    # the giant tail (sides 5000/7000) — SDPLIB 1.2 table (Borchers)
    "maxG55": 9999.210,
    "maxG60": 15222.27,
}

SETS = {
    "mini": ["mcp124-1", "gpp124-1"],
    "mcp": [f"mcp{n}-{i}" for n in (124, 250) for i in (1, 2, 3, 4)],
    "gpp": [f"gpp{n}-{i}" for n in (124, 250) for i in (1, 2, 3, 4)],
    # CI-scale sweep: the 124/250 series of both families
    "std": [
        f"{fam}{n}-{i}"
        for fam in ("mcp", "gpp")
        for n in (124, 250)
        for i in (1, 2, 3, 4)
    ],
    # the reference's runbench SDPLIB selection (test/runbench.jl:118-141)
    "full": [
        f"{fam}{n}-{i}"
        for fam in ("gpp", "mcp")
        for n in (124, 250, 500)
        for i in (1, 2, 3, 4)
    ],
    "500": [
        f"{fam}500-{i}" for fam in ("mcp", "gpp") for i in (1, 2, 3, 4)
    ],
    # the other SDPLIB families shipped in /root/reference/test/data —
    # small/medium instances solvable on CPU in minutes
    "families": (
        [f"theta{i}" for i in (1, 2, 3, 4)]
        + [f"arch{i}" for i in (0, 2, 4, 8)]
        + [f"control{i}" for i in (1, 2, 3, 4, 5, 6)]
        + [f"truss{i}" for i in (1, 2, 3, 4, 5, 6, 7, 8)]
        + [f"qap{i}" for i in (5, 6, 7, 8, 9, 10)]
    ),
    # the heavyweight tail (PSD sides 250-2000): run on an accelerator
    "big": [
        "theta5", "theta6", "control7", "control8",
        "maxG11", "maxG51", "maxG32", "thetaG11", "qpG11",
    ],
    # sides 5000/7000 — TP territory (use --sharded)
    "giant": ["maxG55", "maxG60"],
}

# Per-family tuned options (--recipes), selected by the round-5 probe
# grids (BASELINE.md "Round-5 session-2/3 findings").  Tuning options
# per problem class is standard solver-benchmark practice (the
# reference's own bench tunes tol/time per set, runbench.jl:39-44);
# each entry documents the measured rationale.  Explicit --opt KEY=VAL
# still wins over a recipe entry.
RECIPES = {
    # arch: the f64-polish step-restart watchdog and the adaptive
    # restart-to-average both destabilize the iterate (each restart
    # triggers reject-heavy eigh reseeds, collapsing throughput 500 ->
    # 150 it/s and rel_err to ~0.5); block equilibration is the round-3
    # win for this family.  arch0 probe: rel_err 2.0e-3 @ 170k iters
    # vs 0.48 under r4 defaults.
    "arch": {
        "block_equilibration": "true",
        "restart": "none",
        "polish_restart": "false",
    },
}


def recipe_for(name):
    """Longest-prefix family match into RECIPES ('' when none)."""
    fam = name.rstrip("0123456789-")
    return RECIPES.get(fam, {})


def violations(res, problem):
    """Linear violation (inf-norm of Ax-b / one-sided Gx-h) and PSD
    violation (most negative eigenvalue over PSD blocks) of the returned
    primal — same quantities runbench.jl logs."""
    import scipy.sparse as sp

    from proxsdp_tpu.utils.vech import ivec, offdiag_mask_tri

    x = res.primal
    lin = 0.0
    if problem.A is not None and problem.A.shape[0]:
        lin = max(lin, float(np.abs(problem.A @ x - problem.b).max()))
    if problem.G is not None and problem.G.shape[0]:
        lin = max(lin, float(np.maximum(problem.G @ x - problem.h, 0.0).max()))
    psd = 0.0
    for idx in problem.sdp_vars:
        v = np.asarray(x[idx], np.float64)
        X = ivec(v)
        w = np.linalg.eigvalsh(X)
        psd = min(psd, float(w[0]))
    return lin, psd


def _parse_opts(pairs, opts):
    """Coerce KEY=VAL strings by the type of the field's default."""
    out = {}
    for pair in pairs:
        key, _, val = pair.partition("=")
        cur = getattr(opts, key)  # AttributeError on unknown = loud fail
        if isinstance(cur, bool):
            out[key] = val.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            out[key] = int(float(val))
        elif isinstance(cur, float):
            out[key] = float(val)
        else:
            out[key] = val
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", default="mini", choices=sorted(SETS))
    ap.add_argument("--instances", default="",
                    help="comma-separated explicit instance list (overrides --set)")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--time-limit", type=float, default=300.0)
    ap.add_argument("--out", default="parity.csv")
    ap.add_argument("--no-warm-rerun", action="store_true",
                    help="record the first (compile-contaminated) run "
                    "instead of re-solving once the XLA cache is warm")
    ap.add_argument("--backend", default="",
                    help="force a jax platform (e.g. 'cpu')")
    ap.add_argument("--isolate", action="store_true",
                    help="run each instance in its own subprocess with "
                    "checkpoint auto-resume: a device runtime fault can "
                    "poison the whole process, so the sweep re-execs the "
                    "instance fresh and resumes it from its last "
                    "checkpoint instead of losing the row; the parent "
                    "never touches the device while the children run")
    ap.add_argument("--retries", type=int, default=2,
                    help="max re-exec attempts per instance (--isolate)")
    ap.add_argument("--opt", action="append", default=[],
                    metavar="KEY=VAL",
                    help="solver Options override, repeatable (typed by "
                    "the field's current default, e.g. --opt "
                    "restart=adaptive --opt max_iter=10000000)")
    ap.add_argument("--recipes", action="store_true",
                    help="apply the documented per-family tuned options "
                    "(RECIPES table); explicit --opt still wins")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="solve through solve_sharded over an N-device "
                    "tp mesh (clamped to the available device count; "
                    "N=1 exercises the TP code path on a single chip)")
    ap.add_argument("--single", default="", help=argparse.SUPPRESS)
    ap.add_argument("--resume", default="", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    import proxsdp_tpu as px
    from proxsdp_tpu.models.sdplib import sdplib_problem
    from proxsdp_tpu.solver import solve

    import subprocess

    try:
        commit = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(__file__)) or ".",
             "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        commit = "unknown"
    # NOTE: jax.default_backend() is queried lazily per row, AFTER the
    # first solve — querying it here would initialize the backend in the
    # --isolate parent, which must leave the device to its children

    fieldnames = [
        "instance", "status", "time_s", "obj", "published", "rel_err",
        "rank", "iters", "lin_viol", "psd_viol", "backend", "commit",
    ]

    names = (
        [args.single] if args.single
        else [t for t in args.instances.split(",") if t]
        if args.instances
        else SETS[args.set]
    )

    if args.isolate and not args.single:
        # parent: header once, then one subprocess per instance; rows are
        # appended by the children.  An instance whose attempts all die
        # is a FAILURE of the sweep (exit 1), never a silent skip.
        with open(args.out, "w", newline="") as f:
            csv.DictWriter(f, fieldnames=fieldnames).writeheader()
        ckdir = args.out + ".ckpts"
        os.makedirs(ckdir, exist_ok=True)
        failures = []
        for name in names:
            ck = os.path.join(ckdir, f"{name}.npz")
            ok = False
            for attempt in range(args.retries + 1):
                cmd = [
                    sys.executable, os.path.abspath(__file__),
                    "--single", name, "--out", args.out,
                    "--tol", str(args.tol),
                    "--time-limit", str(args.time_limit),
                    "--ckpt", ck,
                ]
                if args.backend:
                    cmd += ["--backend", args.backend]
                if args.no_warm_rerun:
                    cmd += ["--no-warm-rerun"]
                if args.sharded:
                    cmd += ["--sharded", str(args.sharded)]
                if args.recipes:
                    for key, val in recipe_for(name).items():
                        cmd += ["--opt", f"{key}={val}"]
                for ov in args.opt:
                    cmd += ["--opt", ov]
                if attempt and os.path.exists(ck):
                    cmd += ["--resume", ck]
                    print(f"{name}: attempt {attempt + 1} resumes from "
                          f"checkpoint", flush=True)
                rc = subprocess.run(cmd).returncode
                if rc == 0:
                    ok = True
                    break
                print(f"{name}: attempt {attempt + 1} exited rc={rc}",
                      flush=True)
            if not ok:
                failures.append(name)
            if os.path.exists(ck):
                os.remove(ck)
        if failures:
            print(f"FAILED instances (no row recorded): {failures}",
                  flush=True)
            sys.exit(1)
        print(f"wrote {args.out} ({len(names)} rows, isolated)")
        return

    if args.single:
        # child: append my row to the shared CSV; nonzero exit on crash
        out_f = open(args.out, "a", newline="")
    else:
        out_f = open(args.out, "w", newline="")
    writer = csv.DictWriter(out_f, fieldnames=fieldnames)
    if not args.single:
        writer.writeheader()
        out_f.flush()

    rows = []
    for name in names:
        path = os.path.join(DATA_DIR, f"{name}.dat-s")
        if not os.path.exists(path):
            print(f"{name}: MISSING", flush=True)
            continue
        opts = px.Options(
            tol_gap=args.tol,
            tol_feasibility=args.tol,
            time_limit=args.time_limit,
        )
        if args.recipes:
            rec = recipe_for(name)
            if rec:
                pairs = [f"{k}={v}" for k, v in rec.items()]
                opts = opts.replace(**_parse_opts(pairs, opts))
        if args.opt:
            opts = opts.replace(**_parse_opts(args.opt, opts))
        if args.ckpt:
            opts = opts.replace(
                checkpoint_path=args.ckpt, checkpoint_freq=2000
            )
        # test hook: first attempt checkpoints early, then dies like a
        # device runtime fault — exercises the parent's resume path
        inject = bool(
            args.single
            and os.environ.get("PARITY_INJECT_FAULT")
            and not args.resume
        )
        if inject:
            opts = opts.replace(checkpoint_freq=200, max_iter=400)
        problem, _ = sdplib_problem(path, opts)
        t0 = time.time()
        try:
            if args.sharded:
                from proxsdp_tpu.parallel.sharded import solve_sharded

                devs = jax.devices()[: args.sharded]
                mesh = jax.sharding.Mesh(np.array(devs), ("tp",))
                res = solve_sharded(
                    problem, mesh, opts,
                    resume_from=args.resume if args.resume else None,
                )
            else:
                res = solve(
                    problem, opts,
                    resume_from=args.resume if args.resume else None,
                )
        except Exception as e:  # device runtime faults etc
            print(f"{name}: CRASH {type(e).__name__}: {e}", flush=True)
            if args.single:
                sys.exit(17)  # parent retries from the checkpoint
            continue
        if inject:
            print(f"{name}: INJECTED FAULT after checkpoint", flush=True)
            sys.exit(17)
        dt = time.time() - t0
        # Warm rerun: the first solve of a geometry pays XLA compiles
        # (they can eat the whole time limit and turn a solvable
        # instance into a bogus limit status).  When
        # the first run was slow or hit a limit, re-solve with the
        # compile cache now warm and record the warm run — the honest
        # measurement of solver (not compiler) time.
        if not args.no_warm_rerun and (res.status in (2, 3) or dt > 30.0):
            t0 = time.time()
            try:
                if args.sharded:
                    res2 = solve_sharded(problem, mesh, opts)
                else:
                    res2 = solve(problem, opts)
                dt2 = time.time() - t0
                print(f"{name}: warm rerun st={res2.status} t={dt2:.1f}s "
                      f"(first st={res.status} t={dt:.1f}s)", flush=True)
                res, dt = res2, dt2
            except Exception as e:
                print(f"{name}: warm rerun CRASH {type(e).__name__}: {e}",
                      flush=True)
        lin, psd = violations(res, problem)
        # drop this instance's compiled executables: a sweep accumulates
        # programs + device buffers per geometry — each instance's
        # recompile is served by the persistent on-disk XLA cache
        import gc
        gc.collect()
        jax.clear_caches()
        pub = PUBLISHED.get(name)
        err = abs(abs(res.objval) - abs(pub)) / max(abs(pub), 1.0) if pub else None
        rows.append(
            dict(
                instance=name,
                status=res.status,
                time_s=round(dt, 2),
                obj=round(res.objval, 4),
                published=pub,
                rel_err=None if err is None else round(err, 6),
                rank=res.final_rank,
                iters=res.iter,
                lin_viol=f"{lin:.2e}",
                psd_viol=f"{psd:.2e}",
                backend=jax.default_backend(),
                commit=commit,
            )
        )
        writer.writerow(rows[-1])
        out_f.flush()
        print(
            f"{name}: st={res.status} t={dt:.1f}s obj={res.objval:.4f} "
            f"pub={pub} rel_err={err if err is None else f'{err:.2e}'} "
            f"rank={res.final_rank} lin={lin:.1e} psd={psd:.1e}",
            flush=True,
        )

    out_f.close()
    if args.single:
        print(f"appended {names[0]} to {args.out}")
        return
    requested = [
        n for n in names
        if os.path.exists(os.path.join(DATA_DIR, f"{n}.dat-s"))
    ]
    if len(rows) < len(requested):
        missing = sorted(
            set(requested) - {r["instance"] for r in rows}
        )
        print(f"FAILED instances (no row recorded): {missing}", flush=True)
        sys.exit(1)
    print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
