"""Platform-independent policies: matmul precision at the jit boundary,
compile-cache placement, the operator choice, the native parser build, and
an import that leaves the device alone."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import proxsdp_tpu as px
from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
from proxsdp_tpu.ops.linop import CooOp, DenseOp, EllOp, build_linop
from proxsdp_tpu.problem import preprocess, to_square_form

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# precision: every dot in the lowered f32 programs is full f32
# ---------------------------------------------------------------------------

_DOT = re.compile(r"stablehlo\.dot_general[^\n]*")


def _assert_all_dots_highest(text: str) -> int:
    dots = _DOT.findall(text)
    assert dots, "no dot_general in the lowered program"
    for d in dots:
        assert "precision = [HIGHEST, HIGHEST]" in d, d
    return len(dots)


def _f32_setup(side, linop, **opt_kw):
    from proxsdp_tpu.solver import Operands, init_state

    opts = px.Options(dtype="float32", **opt_kw)
    problem, _ = maxcut_problem(random_graph_weights(0, side, density=0.3))
    setup = to_square_form(preprocess(problem))
    dt = jnp.float32
    M = build_linop(setup.A, setup.G, dt, force=linop)
    ops = Operands(
        M=M,
        b=jnp.asarray(setup.b, dt), h=jnp.asarray(setup.h, dt),
        c=jnp.asarray(setup.c, dt), norm_b=jnp.asarray(setup.norm_b, dt),
        norm_h=jnp.asarray(setup.norm_h, dt),
        norm_c=jnp.asarray(setup.norm_c, dt),
        chunk_end=jnp.asarray(1, jnp.int32),
        obj_scale=jnp.asarray(setup.obj_scale, dt),
    )
    state = init_state(setup.layout, opts, setup)
    return setup.layout, opts, state, ops


@pytest.mark.parametrize(
    "linop,opt_kw",
    [
        ("dense", {}),
        ("ell", {}),
        ("dense", dict(projection="polar", polar_min_side=4)),
        ("dense", dict(subspace_rank=4, subspace_fallback="polar")),
        ("dense", dict(full_eig_max_side=0, min_size_krylov_eigs=4)),
    ],
    ids=["eigh-dense", "eigh-ell", "polar", "subspace", "lanczos"],
)
def test_chunk_program_dots_are_full_f32(linop, opt_kw):
    from proxsdp_tpu.solver import make_chunk_runner

    layout, opts, state, ops = _f32_setup(12, linop, **opt_kw)
    run_chunk, _, _ = make_chunk_runner(layout, opts)
    _assert_all_dots_highest(run_chunk.lower(state, ops).as_text())


def test_batch_program_dots_are_full_f32():
    from proxsdp_tpu.parallel.batch import _cached_batch_runner, _stack_states

    layout, opts, state, ops = _f32_setup(8, "dense")
    states = _stack_states([state, state])
    bops = ops._replace(
        b=jnp.stack([ops.b, ops.b]), h=jnp.stack([ops.h, ops.h]),
        c=jnp.stack([ops.c, ops.c]), norm_b=jnp.stack([ops.norm_b] * 2),
        norm_h=jnp.stack([ops.norm_h] * 2), norm_c=jnp.stack([ops.norm_c] * 2),
        obj_scale=jnp.stack([ops.obj_scale] * 2),
    )
    run_chunk, _ = _cached_batch_runner(layout, opts.replace(use_lanczos=False))
    _assert_all_dots_highest(run_chunk.lower(states, bops).as_text())


def test_lanczos_dots_are_full_f32():
    from proxsdp_tpu.ops.lanczos import lanczos_topk

    X = jnp.eye(20, dtype=jnp.float32)
    v0 = jnp.ones((20,), jnp.float32)
    _assert_all_dots_highest(lanczos_topk.lower(X, v0, ncv=6).as_text())


def test_unwrapped_dot_is_default_precision():
    """The check above is meaningful: without the policy a dot lowers at
    DEFAULT precision."""
    a = jnp.ones((4, 4), jnp.float32)
    text = jax.jit(lambda x: x @ x).lower(a).as_text()
    assert "precision = [DEFAULT, DEFAULT]" in _DOT.findall(text)[0]


# ---------------------------------------------------------------------------
# compile cache placement
# ---------------------------------------------------------------------------

_PRINT_CACHE = (
    "import jax, proxsdp_tpu; print(repr(jax.config.jax_compilation_cache_dir))"
)


def _cache_dir_in_subprocess(env_extra, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _PRINT_CACHE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_cache_respects_jax_compilation_cache_dir(tmp_path):
    # JAX reads the variable itself; the package sets no directory
    got = _cache_dir_in_subprocess(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    )
    assert got in ("None", repr(str(tmp_path)))
    assert ".jax_cache" not in got


def test_cache_defaults_to_fixed_checkout_path():
    got = _cache_dir_in_subprocess(
        {}, drop=("JAX_COMPILATION_CACHE_DIR", "PROXSDP_TPU_NO_COMPILE_CACHE")
    )
    assert got == repr(os.path.join(ROOT, ".jax_cache"))
    assert got == repr(px.CHECKOUT_CACHE_DIR)


def test_cache_opt_out():
    got = _cache_dir_in_subprocess(
        {"PROXSDP_TPU_NO_COMPILE_CACHE": "1"},
        drop=("JAX_COMPILATION_CACHE_DIR",),
    )
    assert got == "None"


def test_import_initializes_no_backend():
    """Importing the package must not touch the device (a parent process
    that only imports it leaves the card to its children)."""
    code = (
        "import proxsdp_tpu, proxsdp_tpu.parallel.batch, "
        "proxsdp_tpu.parallel.sharded\n"
        "from jax._src import xla_bridge as xb\n"
        "print(len(xb._backends))"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == "0"


# ---------------------------------------------------------------------------
# operator choice does not depend on the backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cpu", "gpu", "cuda", "rocm"])
@pytest.mark.parametrize(
    "side,density,want",
    [(250, 0.02, EllOp), (30, 0.1, DenseOp), (2000, 0.002, EllOp)],
)
def test_auto_linop_ignores_backend(monkeypatch, backend, side, density, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if side == 2000:
        # the side-2000 square-form operator: 2000 x 4e6 with 2000 nnz
        import scipy.sparse as sp

        n = side * side
        A = sp.csr_matrix(
            (np.ones(side), (np.arange(side), np.arange(side) * (side + 1))),
            shape=(side, n),
        )
        G = sp.csr_matrix((0, n))
    else:
        problem, _ = maxcut_problem(random_graph_weights(0, side, density))
        setup = to_square_form(preprocess(problem))
        A, G = setup.A, setup.G
    for dt in (jnp.float32, jnp.float64):
        assert type(build_linop(A, G, dt)) is want


def test_forced_forms_still_available():
    problem, _ = maxcut_problem(random_graph_weights(0, 20, 0.2))
    setup = to_square_form(preprocess(problem))
    for force, cls in (("dense", DenseOp), ("ell", EllOp), ("coo", CooOp)):
        assert type(build_linop(setup.A, setup.G, jnp.float64, force=force)) is cls


# ---------------------------------------------------------------------------
# native parser build
# ---------------------------------------------------------------------------


def test_native_build_is_atomic(tmp_path, monkeypatch):
    import shutil

    from proxsdp_tpu.utils import native

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    target = tmp_path / "_native.so"
    monkeypatch.setattr(native, "_LIB_PATH", str(target))
    native._build()
    assert target.exists()
    assert [p.name for p in tmp_path.iterdir()] == ["_native.so"]


def test_native_build_failure_leaves_nothing(tmp_path, monkeypatch):
    from proxsdp_tpu.utils import native

    target = tmp_path / "_native.so"
    monkeypatch.setattr(native, "_LIB_PATH", str(target))

    def broken(cmd, **kw):
        # the compiler dies after writing part of its output
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"partial")
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(subprocess, "run", broken)
    with pytest.raises(subprocess.CalledProcessError):
        native._build()
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# trace reduction (benchmarks/trace_summary.py)
# ---------------------------------------------------------------------------


def _trace_summary():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        import trace_summary
    finally:
        sys.path.pop(0)
    return trace_summary


def test_trace_summary_interval_union():
    ts = _trace_summary()
    events = [
        (0, 10, "gemm.1"), (5, 10, "gemm.2"),  # overlap: busy 0..15
        (30, 5, "MemcpyD2H"), (40, 10, "fusion_3"),  # gaps 15..30, 35..40
    ]
    out = ts.summarize(events, top=2)
    assert out["window_ms"] == 50 / 1e6
    assert out["busy_ms"] == 30 / 1e6
    assert abs(out["idle_share"] - 0.4) < 1e-12
    assert out["d2h_copies"] == 1 and out["events"] == 4
    assert out["top"][0]["name"] == "gemm" and out["top"][0]["count"] == 2
    assert len(out["top"]) == 2


def test_trace_summary_needs_a_gpu_plane(tmp_path):
    ts = _trace_summary()
    jax.profiler.start_trace(str(tmp_path))
    jnp.ones((8, 8)).sum().block_until_ready()
    jax.profiler.stop_trace()
    with pytest.raises(ValueError, match="no GPU plane"):
        ts.device_events(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ts.device_events(str(tmp_path / "missing"))
