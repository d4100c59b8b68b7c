"""Tensor-parallel scaling benchmark: one huge PSD block over a mesh.

SURVEY §2.3 TP row: shard a single large block's dense work
(PartitionSpec on the (n, n) operand) so the projection's matmuls/eigh
and the Lanczos matvecs ride the mesh.  This harness measures
solve_sharded against the unsharded solve on a synthetic single-block
max-cut SDP of configurable side.

NOTE on hardware: a TP speedup needs several real devices (e.g. four
NVLink-connected GPUs); the CPU "mesh" (--cpu-mesh) is virtual (XLA host
devices; correctness only, no perf signal).  The crossover is expected
where a single block's eigh/subspace work dominates (side >~ 2048, where
the (n,n) matmuls are ~8.6 GFLOP each); it is not yet measured.

Usage:
    python benchmarks/tp_scale.py --side 2048 --iters 200 [--cpu-mesh 8]

Prints one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--cpu-mesh", type=int, default=0,
                    help="force an N-device virtual CPU mesh (correctness mode)")
    args = ap.parse_args()

    if args.cpu_mesh and os.environ.get("_TP_SCALE_REEXEC") != "1":
        # device-count flags must be in the environment before JAX
        # initializes, so re-exec with them set
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_mesh}"
        )
        env["JAX_PLATFORMS"] = "cpu"
        env["_TP_SCALE_REEXEC"] = "1"
        os.execve(sys.executable, [sys.executable] + sys.argv, env)

    import jax
    import numpy as np
    import proxsdp_tpu as px
    from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu.parallel.sharded import solve_sharded
    from proxsdp_tpu.solver import solve

    prob, _ = maxcut_problem(random_graph_weights(0, args.side))
    opts = px.Options(max_iter=args.iters, time_limit=3600)

    t0 = time.time()
    r_ref = solve(prob, opts)
    t_ref = time.time() - t0

    devs = jax.devices()
    mesh = jax.sharding.Mesh(np.array(devs), ("tp",))
    t0 = time.time()
    r_tp = solve_sharded(prob, mesh, opts)
    t_tp = time.time() - t0

    out = {
        "side": args.side,
        "iters": args.iters,
        "devices": len(devs),
        "unsharded_s": round(t_ref, 2),
        "tp_s": round(t_tp, 2),
        "speedup": round(t_ref / max(t_tp, 1e-9), 3),
        "obj_rel_diff": abs(r_tp.objval - r_ref.objval)
        / (1.0 + abs(r_ref.objval)),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
