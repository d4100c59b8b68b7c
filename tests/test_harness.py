"""Benchmark-harness behavior tests: fault isolation + checkpoint resume.

The reference has no process-level fault tolerance (SURVEY.md §5); its
runbench.jl simply loses the instance when the solver dies.  Our parity
harness (benchmarks/parity.py --isolate) runs each instance in its own
subprocess, auto-resumes from the last checkpoint after a crash (a
device runtime fault can poison the whole process), and fails the sweep — instead of silently skipping — when an instance
records no row.
"""

from __future__ import annotations

import csv
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "benchmarks", "parity.py")
DATA = os.environ.get("SDPLIB_DIR", "/root/reference/test/data")


def _run(args, env_extra=None, timeout=600):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    if env_extra:
        env.update(env_extra)
    return subprocess.run(
        [sys.executable, PARITY, "--backend", "cpu", *args],
        capture_output=True, text=True, env=env, timeout=timeout,
    )


@pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mcp124-1.dat-s")),
    reason="SDPLIB data not available",
)
def test_isolate_injected_fault_resumes_from_checkpoint(tmp_path):
    """First attempt checkpoints then dies; the parent must retry with
    --resume and the sweep must finish rc=0 with the row recorded."""
    out = tmp_path / "parity.csv"
    p = _run(
        ["--instances", "mcp124-1", "--isolate", "--tol", "1e-3",
         "--time-limit", "120", "--out", str(out)],
        env_extra={"PARITY_INJECT_FAULT": "1"},
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "INJECTED FAULT" in p.stdout
    assert "resumes from checkpoint" in p.stdout
    rows = list(csv.DictReader(open(out)))
    assert len(rows) == 1 and rows[0]["instance"] == "mcp124-1"
    # the resumed run continued past the crashed attempt's 400-iteration
    # cap rather than starting over
    assert int(rows[0]["iters"]) >= 400


@pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "mcp124-1.dat-s")),
    reason="SDPLIB data not available",
)
def test_missing_row_fails_the_sweep(tmp_path):
    """A crash that persists past all retries must exit nonzero and name
    the instance — empty CSVs are a queue failure, not a silent skip."""
    out = tmp_path / "parity.csv"
    p = _run(
        ["--instances", "mcp124-1", "--isolate", "--retries", "0",
         "--tol", "1e-3", "--time-limit", "60", "--out", str(out)],
        env_extra={"PARITY_INJECT_FAULT": "1"},
    )
    assert p.returncode == 1, p.stdout + p.stderr
    assert "FAILED instances" in p.stdout and "mcp124-1" in p.stdout
    assert len(list(csv.DictReader(open(out)))) == 0


def test_recipes_table_applies_and_explicit_opt_wins():
    """--recipes maps families to documented tuned options; explicit
    --opt must still override a recipe entry (parity.py RECIPES)."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import parity

    import proxsdp_tpu as px

    rec = parity.recipe_for("arch0")
    assert rec == {
        "block_equilibration": "true",
        "restart": "none",
        "polish_restart": "false",
    }
    # families without an entry get no overrides
    assert parity.recipe_for("theta1") == {}
    assert parity.recipe_for("mcp250-1") == {}
    # typed application through the same path main() uses
    opts = px.Options()
    pairs = [f"{k}={v}" for k, v in rec.items()]
    opts = opts.replace(**parity._parse_opts(pairs, opts))
    assert opts.block_equilibration is True
    assert opts.restart == "none"
    assert opts.polish_restart is False
    # explicit --opt wins because it is parsed after the recipe pairs
    opts = opts.replace(**parity._parse_opts(["restart=adaptive"], opts))
    assert opts.restart == "adaptive"
