"""Multi-process (multi-host stand-in) distributed test.

Launches 2 OS processes, each with 4 virtual CPU devices, joined via
``jax.distributed.initialize`` into one 8-device global mesh — the CPU
stand-in for a 2-host device mesh (SURVEY.md §4).  The batched PDHG
chunk runner executes over the global dp axis with cross-process
collectives handled by the jax distributed runtime.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(600)
def test_two_process_batched_solve():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    repo_root = os.path.dirname(os.path.dirname(_WORKER))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), "2", coord],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=os.path.dirname(os.path.dirname(_WORKER)),
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-4000:]}"
        assert f"MP OK p{i}/2" in out, f"proc {i} missing OK line:\n{out[-4000:]}"
