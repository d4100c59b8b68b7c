"""chip_smoke.py off the GPU: it refuses to run, and every phase function
works at toy sizes when called directly (the CPU rehearsal of the card run;
the --four phases run on the 8 virtual CPU devices)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, path], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    r = _run_script(str(script), cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def ctx(tmp_path):
    return dict(card="n/a", out=str(tmp_path))


def _run(name, fn, ctx, capsys):
    ok = cs.run_phase(name, fn, ctx, jax.devices())
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["phase"] == name and rec["ok"] is ok
    return ok, rec, lines


def test_setup_phase(ctx, capsys):
    ok, rec, _ = _run("setup", cs.phase_setup, ctx, capsys)
    assert ok and rec["platform"] == "cpu" and rec["x64"] is True
    assert rec["compile_cache"]


@pytest.mark.parametrize("side", [40, 120])
def test_engine_records_within_tolerance(side):
    recs = cs.engine_records(side, reps=1)
    assert {(r["engine"], r["dtype"]) for r in recs} == set(cs.ENGINE_TOL)
    for r in recs:
        assert r["ok"], r
    lz = {r["dtype"]: r for r in recs if r["engine"] == "lanczos"}
    if side >= 120:
        # f64 Lanczos converges on the planted spectrum and is accepted
        assert not lz["float64"]["used_full"]


def test_operator_records_and_auto_form():
    recs = cs.operator_records(30, 0.1, ("dense", "ell", "coo"), reps=1)
    assert len(recs) == 3 * 2 * 2
    for r in recs:
        assert r["ok"], r
        assert r["built"] == {"dense": "DenseOp", "ell": "EllOp",
                              "coo": "CooOp"}[r["form"]]


def test_engines_phase(ctx, capsys):
    ok, rec, lines = _run(
        "engines",
        lambda c: cs.phase_engines(
            c, sides=(40,), op_cases=[(30, 0.1, ("ell", "coo"))]
        ),
        ctx, capsys,
    )
    assert ok, rec
    assert len(lines) == 7 + 8 + 1


def test_mcp_phase_writes_trace(ctx, capsys):
    ok, rec, _ = _run(
        "mcp", lambda c: cs.phase_mcp(c, side=40, density=0.2), ctx, capsys
    )
    assert ok, rec
    assert rec["certified_gap"] <= cs.CERT_GAP
    assert "proj" in rec["proj_fallbacks"]
    assert os.path.isdir(os.path.join(rec["trace_dir"], "plugins"))


def test_giant_phase_takes_iterative_paths(ctx, capsys):
    # full_eig_max_side below the side: the Lanczos / polar-fallback /
    # subspace-polish route of the side-2000 phase
    ok, rec, _ = _run(
        "giant",
        lambda c: cs.phase_giant(
            c, side=160, edges=400, time_limit=120,
            solve_kwargs=dict(full_eig_max_side=100),
        ),
        ctx, capsys,
    )
    assert ok, rec


def test_batch_phase(ctx, capsys):
    ok, rec, _ = _run(
        "batch", lambda c: cs.phase_batch(c, count=6, side=8), ctx, capsys
    )
    assert ok, rec
    assert rec["optimal"] == 6 and rec["max_certified_gap"] <= cs.CERT_GAP


def test_cones_phase(ctx, capsys):
    ok, rec, _ = _run("cones", cs.phase_cones, ctx, capsys)
    assert ok, rec
    assert set(rec) >= {"soc", "psd_offdiag", "mixed_all_cones"}


def test_failed_phase_is_reported(ctx, capsys):
    def boom(c):
        cs.check(False, "planted failure")

    ok, rec, _ = _run("boom", boom, ctx, capsys)
    assert not ok and "planted failure" in rec["error"]


def test_four_tp_phase_on_virtual_devices(ctx, capsys):
    ok, rec, _ = _run(
        "four_tp",
        lambda c: cs.phase_four_tp(
            c, side=48, edges=200, time_limit=120,
            solve_kwargs=dict(tol_gap=1e-5, tol_feasibility=1e-5),
        ),
        ctx, capsys,
    )
    assert ok, rec
    assert rec["tp"] == 4 and len(rec["peak_bytes_per_device"]) == 4


def test_four_dp_phase_on_virtual_devices(ctx, capsys):
    ok, rec, _ = _run(
        "four_dp", lambda c: cs.phase_four_dp(c, count=8, side=8), ctx,
        capsys,
    )
    assert ok, rec
    assert rec["batch"] == 4


def test_planted_matrix_spectrum():
    X = cs.planted_matrix(50, 3)
    w = np.linalg.eigvalsh(X)
    assert np.allclose(X, X.T)
    assert np.sum(w > 0) == 10
    assert 1.0 <= w[-10] and w[-1] <= 10.0
    assert -1.0 <= w[0] and w[-11] <= -0.01
