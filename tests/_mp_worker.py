"""Worker process for the jax.distributed multi-process test.

Usage: python _mp_worker.py <process_id> <num_processes> <coordinator>

Each process owns 4 virtual CPU devices; together they form one global
8-device mesh.  The worker builds the same batched max-cut workload on
every process (deterministic seeds), assembles GLOBAL arrays from
process-local shards, runs the jitted batched PDHG chunk runner over the
global dp mesh (cross-process collectives ride the distributed runtime —
the stand-in for the interconnect of a real multi-host mesh), and checks
convergence.

SURVEY.md §4: "multi-host tests runnable on CPU via jax.distributed +
XLA_FLAGS=--xla_force_host_platform_device_count".
"""

from __future__ import annotations

import os
import sys

proc_id, nprocs, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

jax.distributed.initialize(
    coordinator_address=coord, num_processes=nprocs, process_id=proc_id
)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights  # noqa: E402
from proxsdp_tpu.options import Options  # noqa: E402
from proxsdp_tpu.parallel.batch import (  # noqa: E402
    Operands,
    _cached_batch_runner,
    _stack_states,
)
from proxsdp_tpu.problem import preprocess  # noqa: E402
from proxsdp_tpu.ops.linop import build_linop  # noqa: E402
from proxsdp_tpu.solver import init_state  # noqa: E402

assert len(jax.devices()) == 4 * nprocs, jax.devices()

mesh = Mesh(np.array(jax.devices()), ("dp",))
B = len(jax.devices())  # one instance per global device

opts = Options(use_lanczos=False, certificate_search=False)
side = 8
problems = [maxcut_problem(random_graph_weights(s, side))[0] for s in range(B)]
setups = [preprocess(p) for p in problems]
layout = setups[0].layout
dtype = jnp.float64

M = build_linop(setups[0].A, setups[0].G, dtype, force="dense")
ops_host = Operands(
    M=M,
    b=np.stack([s.b for s in setups]),
    h=np.stack([s.h for s in setups]),
    c=np.stack([s.c for s in setups]),
    norm_b=np.asarray([s.norm_b for s in setups]),
    norm_h=np.asarray([s.norm_h for s in setups]),
    norm_c=np.asarray([s.norm_c for s in setups]),
    chunk_end=jnp.asarray(1, jnp.int32),
    obj_scale=np.asarray([s.obj_scale for s in setups]),
)
states_host = _stack_states([init_state(layout, opts, s) for s in setups])


def make_global(x):
    """Host array (identical on all processes) -> global dp-sharded array."""
    x = np.asarray(jnp.asarray(x))  # normalize dtype the way jnp would
    if x.ndim >= 1 and x.shape[0] == B:
        sharding = NamedSharding(mesh, P("dp"))
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: jnp.asarray(x[idx])
        )
    return jnp.asarray(x)


states = jax.tree_util.tree_map(make_global, states_host)
ops = jax.tree_util.tree_map(make_global, ops_host)
ops = ops._replace(chunk_end=jnp.asarray(1, jnp.int32))

run_chunk, fetch = _cached_batch_runner(layout, opts)
with mesh:
    out = states
    snaps = []
    for end in (64, 1024):
        out = run_chunk(
            out._replace(), ops._replace(chunk_end=jnp.asarray(end, jnp.int32))
        )
        jax.block_until_ready(out.x)
        # scalar table is dp-sharded; allgather to every host
        snaps.append(
            np.asarray(multihost_utils.process_allgather(fetch(out), tiled=True))
        )

sc = snaps[-1]
statuses, gaps = sc[:, 1].astype(int), sc[:, 2]
assert np.isfinite(gaps).all(), f"non-finite gaps: {gaps}"
ok = (statuses == 1) | (gaps < snaps[0][:, 2])
assert ok.all(), f"stalled instances: statuses={statuses} gaps={gaps}"
n_opt = int((statuses == 1).sum())
print(
    f"MP OK p{proc_id}/{nprocs}: {B} instances over "
    f"{nprocs}x4 devices, {n_opt}/{B} optimal after 1024 iters",
    flush=True,
)
jax.distributed.shutdown()
