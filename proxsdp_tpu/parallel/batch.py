"""Batched-instance solver: many conic problems of one geometry at once.

The reference is strictly serial (SURVEY.md §2.3); this module is the
scale-out it never had.  The single-instance PDHG iteration
(solver.iteration — already a pure function of static shape) is ``vmap``-ed
over a leading instance axis and driven by one ``lax.while_loop`` whose
predicate is "any instance still running"; finished instances freeze
(masked updates), so one compiled program retires a whole sweep.

Sharding: the batch axis is laid out over a ``jax.sharding.Mesh`` data axis
with NamedSharding — instances never communicate, so the only collective
XLA inserts is the all-reduce behind ``jnp.any(active)`` in the loop
predicate (NVLink/NCCL between GPUs).  1024 max-cut instances on n
devices = 1024 / n instances per device, all batched eigh/matmuls.

Per-instance constraint matrices (round 2): instances may carry DIFFERENT
A/G — the operator is then batched (stacked dense, or shared-sparsity
ELLPACK with per-instance values) and vmapped alongside c/b/h, so batched
randsdp/sensorloc/MIMO sweeps solve each instance against its OWN
constraints.  When every instance shares one A/G (max-cut sweeps) the
operator stays unbatched and is broadcast by vmap — no extra HBM.

Limitations vs single-instance solve (documented):
* under vmap, ``lax.cond`` becomes ``select`` (both branches execute), so
  the Lanczos-vs-eigh gating would run both: batch mode forces the dense
  eigh projection path (one batched eigh for the small-to-medium blocks
  batching targets);
* wall-clock time limit is per-chunk granular.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.precision import full_f32
from ..options import Options
from ..problem import ConicProblem, SetupProblem, preprocess
from ..result import STATUS_STRINGS, Result
from ..solver import (
    Operands,
    State,
    _Budget,
    _cache_solution,
    init_state,
    make_chunk_runner,
)


class BatchPlan(NamedTuple):
    setups: list  # per-instance SetupProblem (for result recovery)
    layout: object
    options: Options


def _force_batch_options(opts: Options) -> Options:
    # vmapped cond == select: avoid tracing both Lanczos and eigh per block
    # (and the subspace path's eigh fallback, which under vmap would run
    # the dense path every iteration anyway)
    return opts.replace(
        use_lanczos=False, certificate_search=False, subspace_rank=0
    )


def _reseed_batch(states, layout, k: int, mask, c_np, opts):
    """Host-side basis reseed for accept-always batch subspace mode.

    For every instance i with mask[i]: eigh the PRE-projection matrix of
    each subspace block (x - tau (M'y + c) — the matrix the projection
    acts on; the projected iterate cannot reveal directions a too-small
    basis is missing) and write the exact top-k eigenbasis into the warm
    leaves; reset sub_worst.  Returns (states, r_max) with r_max the
    largest observed positive rank (for bucket escalation).
    """
    from ..ops.tri import _maps as _tri_maps
    from ..utils.vech import sympackedlen as _spl

    x_np = np.asarray(states.x, np.float64)
    mty_np = np.asarray(states.Mty, np.float64)
    tau_np = np.asarray(states.primal_step, np.float64)
    pre = x_np - tau_np[:, None] * (mty_np + c_np)
    old_warm = [np.asarray(w) for w in states.warm]
    mask = np.asarray(mask, bool).copy()
    r_max = 0
    B = x_np.shape[0]
    warm = []
    for bi, (off, side) in enumerate(
        zip(layout.sdp_offsets, layout.sdp_sides)
    ):
        k_sub = int(min(k, side))
        if not (0 < k_sub < side // 2):
            warm.append(old_warm[bi])
            continue
        want = (B, side, k_sub)
        if old_warm[bi].shape != want:
            # bucket escalation: every basis must be rebuilt at the new k
            mask[:] = True
            w_new = np.zeros(want)
        else:
            w_new = old_warm[bi].copy()
        tl = _spl(side)
        gidx, in_scale, _, _ = _tri_maps(side)
        for i in range(B):
            if not mask[i]:
                continue
            Xm = (pre[i, off : off + tl][gidx] * in_scale).reshape(side, side)
            w_, V = np.linalg.eigh(Xm)
            r_max = max(r_max, int(np.sum(w_ > opts.tol_psd)))
            w_new[i] = V[:, -k_sub:][:, ::-1]
        warm.append(w_new)
    new_warm = tuple(jnp.asarray(w, states.x.dtype) for w in warm)
    sub_worst = jnp.where(
        jnp.asarray(mask), jnp.zeros_like(states.sub_worst), states.sub_worst
    )
    return states._replace(warm=new_warm, sub_worst=sub_worst), r_max


@functools.lru_cache(maxsize=32)
def _cached_batch_runner_normalized(layout, opts: Options, m_kind: str):
    from ..ops.linop import DenseOp, EllOp

    _, iteration, _ = make_chunk_runner(layout, opts)

    # batch over state; batch b, h, c; share chunk_end.  The operator M is
    # shared (broadcast), batched-dense, or shared-pattern ELL with
    # per-instance values, per m_kind.
    if m_kind == "dense_batched":
        m_axes = DenseOp(0)
    elif m_kind == "ell_batched":
        m_axes = EllOp(None, 0, None, 0)
    else:
        m_axes = None
    op_axes = Operands(
        M=m_axes, b=0, h=0, c=0, norm_b=0, norm_h=0, norm_c=0,
        chunk_end=None, obj_scale=0, row_unscale=None,
    )
    viter = jax.vmap(iteration, in_axes=(0, op_axes))

    def run_chunk(states: State, ops: Operands) -> State:
        def cond(ss: State):
            return jnp.any((ss.status == 0) & (ss.iter < ops.chunk_end))

        def body(ss: State):
            new = viter(ss, ops)
            active = (ss.status == 0) & (ss.iter < ops.chunk_end)

            def freeze(n, o):
                mask = active.reshape((-1,) + (1,) * (n.ndim - 1))
                return jnp.where(mask, n, o)

            return jax.tree_util.tree_map(freeze, new, ss)

        return jax.lax.while_loop(cond, body, states)

    def fetch(ss: State):
        L = ss.buf_gap.shape[0]
        i = (ss.iter - 1) % L
        ft = ss.buf_gap.dtype
        take = jax.vmap(lambda buf, j: buf[j])
        return jnp.stack(
            [
                ss.iter.astype(ft),
                ss.status.astype(ft),
                take(ss.buf_gap, i),
                take(ss.buf_feas, i),
                take(ss.buf_prim_obj, i),
                take(ss.buf_dual_obj, i),
                ss.sub_worst.astype(ft),
            ],
            axis=-1,
        )

    # same precision policy as the single-instance chunk program
    return jax.jit(full_f32(run_chunk), donate_argnums=(0,)), jax.jit(fetch)


def _cached_batch_runner(layout, opts: Options, m_kind: str = "shared"):
    from ..solver import _runner_key_options

    return _cached_batch_runner_normalized(
        layout, _runner_key_options(opts), m_kind
    )


def _stack_states(states: Sequence[State]) -> State:
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *states)


def _index_state(states: State, i: int) -> State:
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[i], states)


def _same_constraints(s0, s1) -> bool:
    """True iff s1 carries the exact same stacked [A; G] as s0."""
    try:
        import scipy.sparse as sp
    except Exception:  # pragma: no cover
        sp = None
    for X, Y in ((s0.A, s1.A), (s0.G, s1.G)):
        if sp is not None and (sp.issparse(X) or sp.issparse(Y)):
            if not (sp.issparse(X) and sp.issparse(Y)):
                return False
            if X.shape != Y.shape:
                return False
            D = (sp.csr_matrix(X) - sp.csr_matrix(Y))
            if D.nnz and np.abs(D.data).max() != 0.0:
                return False
        else:
            if np.asarray(X).shape != np.asarray(Y).shape:
                return False
            if not np.array_equal(np.asarray(X), np.asarray(Y)):
                return False
    return True


def _batch_operands(setups, dt, force_linop=None):
    """Build the (possibly batched) device operands for the sweep.

    Returns (Operands, m_kind).  m_kind selects the vmap in_axes for M:
    "shared" (all instances have identical A/G — broadcast one operator),
    "ell_batched" (same sparsity pattern, per-instance values), or
    "dense_batched" (stacked dense (B, p+m, n) — batched matmul).
    """
    from ..ops.linop import DenseOp, EllOp, build_linop

    shared = all(_same_constraints(setups[0], s) for s in setups[1:])
    if shared:
        M = build_linop(setups[0].A, setups[0].G, dt, force=force_linop)
        m_kind = "shared"
    else:
        ops0 = [build_linop(s.A, s.G, dt, force=force_linop) for s in setups]
        if all(isinstance(o, EllOp) for o in ops0) and all(
            o.row_cols.shape == ops0[0].row_cols.shape
            and bool(jnp.all(o.row_cols == ops0[0].row_cols))
            and bool(jnp.all(o.col_rows == ops0[0].col_rows))
            for o in ops0[1:]
        ):
            M = EllOp(
                ops0[0].row_cols,
                jnp.stack([o.row_vals for o in ops0]),
                ops0[0].col_rows,
                jnp.stack([o.col_vals for o in ops0]),
            )
            m_kind = "ell_batched"
        else:
            dense = [
                np.asarray(
                    build_linop(s.A, s.G, dt, force="dense").mat
                )
                for s in setups
            ]
            M = DenseOp(jnp.asarray(np.stack(dense), dt))
            m_kind = "dense_batched"
    ops = Operands(
        M=M,
        b=jnp.asarray(np.stack([s.b for s in setups]), dt),
        h=jnp.asarray(np.stack([s.h for s in setups]), dt),
        c=jnp.asarray(np.stack([s.c for s in setups]), dt),
        norm_b=jnp.asarray(np.array([s.norm_b for s in setups]), dt),
        norm_h=jnp.asarray(np.array([s.norm_h for s in setups]), dt),
        norm_c=jnp.asarray(np.array([s.norm_c for s in setups]), dt),
        obj_scale=jnp.asarray(
            np.array([s.obj_scale * s.rhs_scale for s in setups]), dt
        ),
        chunk_end=jnp.asarray(0, jnp.int32),
    )
    return ops, m_kind


def _cast_states_batch(states: State, dtype) -> State:
    """Batched hybrid hand-over: cast float leaves, clear ALL statuses so
    the f64 program re-judges every instance from live residuals (same
    rule as the single-instance driver: f32 decisions are never final)."""

    def cast(x):
        x = jnp.asarray(x)
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    states = jax.tree_util.tree_map(cast, states)
    return states._replace(status=jnp.zeros_like(states.status))


def solve_batch(
    problems: Sequence[ConicProblem],
    options: Options | None = None,
    mesh: jax.sharding.Mesh | None = None,
    batch_axis: str = "batch",
    projection: str = "auto",
    **kwargs,
) -> list[Result]:
    """Solve a batch of same-geometry problems; optionally sharded over a
    mesh data axis. Returns one Result per instance.

    With the default ``dtype="float64", hybrid_precision=True`` the sweep
    races in f32 until every instance has either converged to
    ``hybrid_switch_factor * tol``, terminated, or hit its f32 noise floor
    (no 1.2x best-metric improvement over 3 consecutive chunks), then the
    whole batch is cast to f64 and finished by the f64 program — the
    batched version of the single-instance hybrid driver in solver.solve.
    """
    cert_opts = (options or Options()).replace(**kwargs)
    opts = _force_batch_options(cert_opts)
    t0 = time.time()

    setups = [
        preprocess(
            p,
            scale_objective=opts.scale_objective,
            scale_rhs=opts.scale_rhs,
        )
        for p in problems
    ]
    layout = setups[0].layout
    for s in setups[1:]:
        if s.layout != layout:
            raise ValueError("all batched problems must share one geometry")

    B = len(setups)
    hybrid = opts.dtype == "float64" and opts.hybrid_precision
    phase_opts = opts.replace(dtype="float32") if hybrid else opts
    phase_dt = jnp.float32 if phase_opts.dtype == "float32" else jnp.float64

    # ---- batch subspace mode ("projection"): replace the vmapped eigh
    # with the accept-always subspace step + host-side basis reseeds
    # between chunks, so the per-iteration cost is matmuls instead of a
    # vmapped eigh; "auto" enables subspace for large sweeps with a
    # subspace-eligible block.  Its crossover is not yet measured on the
    # H100.
    from ..solver import _sub_bucket

    sub_k = 0
    if projection not in ("auto", "eigh", "subspace"):
        raise ValueError(f"unknown projection mode {projection!r}")
    want_sub = projection == "subspace" or (projection == "auto" and B > 32)
    if want_sub and any(16 < side // 2 for side in layout.sdp_sides):
        sub_k = 16  # starting bucket; reseeds escalate it as ranks appear
        phase_opts = phase_opts.replace(
            subspace_rank=sub_k, subspace_accept_always=True
        )

    ops, m_kind = _batch_operands(setups, phase_dt)
    states = _stack_states([init_state(layout, phase_opts, s) for s in setups])
    tau0 = np.asarray(states.primal_step, np.float64).copy()

    def shard_tree(states, ops):
        if mesh is None:
            return states, ops
        from jax.sharding import NamedSharding, PartitionSpec as P

        def shard(x):
            if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == B:
                return jax.device_put(
                    jnp.asarray(x), NamedSharding(mesh, P(batch_axis))
                )
            return x

        states = jax.tree_util.tree_map(shard, states)
        ops = ops._replace(
            b=shard(ops.b), h=shard(ops.h), c=shard(ops.c),
            norm_b=shard(ops.norm_b), norm_h=shard(ops.norm_h),
            norm_c=shard(ops.norm_c),
            obj_scale=shard(ops.obj_scale),
        )
        if m_kind != "shared":
            # batched operator: shard its per-instance leaves too
            ops = ops._replace(M=jax.tree_util.tree_map(shard, ops.M))
        return states, ops

    states, ops = shard_tree(states, ops)
    run_chunk, fetch = _cached_batch_runner(layout, phase_opts, m_kind)
    budget = _Budget(opts, bool(layout.sdp_sides or layout.soc_lens))

    def maybe_reseed(states, sc, running, base_opts):
        """Host basis maintenance for subspace mode; returns (states,
        runner_or_None).  A non-None runner means the bucket escalated and
        the caller must switch programs."""
        nonlocal sub_k
        if not sub_k:
            return states, None
        worst = sc[:, 6]
        need = running & (worst > max(10 * opts.subspace_tol, 1e-7))
        if not need.any():
            return states, None
        c_np = np.stack([st.c for st in setups])
        states, r_max = _reseed_batch(
            states, layout, sub_k, need, c_np, opts
        )
        k2 = _sub_bucket(r_max + opts.polish_subspace_guard)
        if k2 != sub_k:
            if k2 == 0 or not any(
                k2 < side // 2 for side in layout.sdp_sides
            ):
                # rank outgrew every bucket: fall back to the eigh program
                sub_k = 0
                new_opts = base_opts.replace(
                    subspace_rank=0, subspace_accept_always=False
                )
                states = states._replace(
                    warm=tuple(
                        jnp.asarray(np.asarray(w)[..., 0], states.x.dtype)
                        if np.asarray(w).ndim == 3
                        else w
                        for w in states.warm
                    )
                )
            else:
                sub_k = k2
                new_opts = base_opts.replace(subspace_rank=k2)
                c_np = np.stack([st.c for st in setups])
                states, _ = _reseed_batch(
                    states, layout, sub_k, np.ones(B, bool), c_np, opts
                )
            return states, _cached_batch_runner(layout, new_opts, m_kind)
        return states, None
    # on-device convergence logic -> large chunks are semantics-preserving
    chunk = opts.chunk_iters or (
        max(min(opts.log_freq, 1024), opts.convergence_check)
        if opts.log_verbose
        else 1024
    )

    # subspace mode starts on random bases (the cold-start pre-projection
    # matrix is identically zero, so there is nothing to eigh): keep the
    # first chunk of each phase short so the first host reseed arrives
    # before the junk bases can do damage
    first_chunk = {"todo": bool(sub_k)}

    def step_of(chunk):
        if first_chunk["todo"]:
            first_chunk["todo"] = False
            return min(chunk, 128)
        return chunk

    # ---- phase 1 (hybrid only): f32 race with per-instance stall tracking
    if hybrid:
        F = opts.hybrid_switch_factor
        best = np.full(B, np.inf)
        stall = np.zeros(B, np.int64)
        ready = np.zeros(B, bool)
        while True:
            iters_now = np.asarray(states.iter)
            run_mask = ~ready
            k0 = int(iters_now[run_mask].min()) if run_mask.any() else int(
                iters_now.min()
            )
            target = min(k0 + step_of(chunk), budget.max_iter)
            ops = ops._replace(chunk_end=jnp.asarray(target, jnp.int32))
            states = run_chunk(states, ops)
            sc = np.asarray(fetch(states))
            iters = sc[:, 0].astype(int)
            status = sc[:, 1].astype(int)
            states, new_runner = maybe_reseed(states, sc, ~ready, phase_opts)
            if new_runner is not None:
                run_chunk, fetch = new_runner
            gap, feas = sc[:, 2], sc[:, 3]
            metric = np.maximum(gap, feas)
            improved = metric < best / 1.2
            best = np.where(improved, metric, best)
            stall = np.where(improved, 0, stall + 1)
            near = (gap <= F * opts.tol_gap) & (feas <= F * opts.tol_feasibility)
            ready |= (status != 0) | near | (stall >= 3) | (
                iters >= budget.max_iter
            )
            elapsed = time.time() - t0
            if opts.log_verbose:
                print(
                    f"  [batch/f32] iter>={iters.min()} ready={int(ready.sum())}"
                    f"/{B} max_gap={np.nanmax(gap):.2e} t={elapsed:.1f}s"
                )
            if ready.all() or elapsed >= budget.time_limit:
                break

        # hand over: cast to f64, clear statuses; restart the adaptive-step
        # machinery of stalled/NaN instances (batched form of the
        # single-instance stalled/blew_up handling)
        sc = np.asarray(fetch(states))
        near_now = (sc[:, 2] <= F * opts.tol_gap) & (
            sc[:, 3] <= F * opts.tol_feasibility
        )
        bad = ((stall >= 3) & ~near_now) | ~np.isfinite(sc[:, 2:6]).all(axis=1)
        states = _cast_states_batch(states, jnp.float64)
        if bad.any():
            nan_rows = ~np.isfinite(
                np.asarray(states.x, np.float64).reshape(B, -1)
            ).all(axis=1)
            if nan_rows.any():
                fresh = _stack_states(
                    [init_state(layout, opts, s) for s in setups]
                )

                def splice(cur, fr):
                    cur = np.asarray(cur)
                    mask = nan_rows.reshape((-1,) + (1,) * (cur.ndim - 1))
                    return jnp.asarray(np.where(mask, np.asarray(fr), cur))

                it_keep = states.iter
                states = jax.tree_util.tree_map(splice, states, fresh)
                states = states._replace(iter=it_keep)
            badm = jnp.asarray(bad)

            def rs(val, new):
                return jnp.where(badm, jnp.asarray(new, jnp.float64), val)

            states = states._replace(
                primal_step=rs(states.primal_step, tau0),
                primal_step_old=rs(states.primal_step_old, tau0),
                dual_step=rs(states.dual_step, tau0),
                theta=rs(states.theta, opts.initial_theta),
                beta=rs(states.beta, opts.initial_beta),
                adapt_level=rs(states.adapt_level, opts.initial_adapt_level),
                ada_count=jnp.where(
                    badm, jnp.zeros_like(states.ada_count), states.ada_count
                ),
            )
        ops, m_kind = _batch_operands(setups, jnp.float64)
        states, ops = shard_tree(states, ops)
        phase_opts = opts
        if sub_k:
            # f64 phase in subspace mode: re-estimate the bucket from the
            # current iterates and seed exact bases before the first chunk
            c_np = np.stack([st.c for st in setups])
            states, r_max = _reseed_batch(
                states, layout, sub_k, np.ones(B, bool), c_np, opts
            )
            from ..solver import _sub_bucket as _sb

            k2 = _sb(r_max + opts.polish_subspace_guard)
            if k2 and k2 != sub_k and any(
                k2 < side // 2 for side in layout.sdp_sides
            ):
                sub_k = k2
                states, _ = _reseed_batch(
                    states, layout, sub_k, np.ones(B, bool), c_np, opts
                )
            phase_opts = opts.replace(
                subspace_rank=sub_k, subspace_accept_always=True
            )
        run_chunk, fetch = _cached_batch_runner(layout, phase_opts, m_kind)

    # ---- final phase: run in the target dtype until every instance stops
    if not hybrid:
        first_chunk["todo"] = bool(sub_k)
    while True:
        iters_now = np.asarray(states.iter)
        status_now = np.asarray(states.status)
        running_mask = status_now == 0
        k0 = int(iters_now[running_mask].min()) if running_mask.any() else int(
            iters_now.min()
        )
        target = min(k0 + step_of(chunk), budget.max_iter)
        ops = ops._replace(chunk_end=jnp.asarray(target, jnp.int32))
        states = run_chunk(states, ops)
        sc = np.asarray(fetch(states))
        status = sc[:, 1].astype(int)
        iters = sc[:, 0].astype(int)
        elapsed = time.time() - t0
        running = status == 0
        states, new_runner = maybe_reseed(states, sc, running, phase_opts)
        if new_runner is not None:
            run_chunk, fetch = new_runner
        if opts.log_verbose:
            print(
                f"  [batch] iter>={iters.min()} done={int((~running).sum())}/{B} "
                f"max_gap={sc[running, 2].max() if running.any() else 0:.2e} "
                f"t={elapsed:.1f}s"
            )
        if not running.any():
            break
        if iters[running].min() >= budget.max_iter or elapsed >= budget.time_limit:
            break

    # finalize per instance (host-side, one transfer per array via numpy)
    states_np = jax.tree_util.tree_map(np.asarray, states)
    results = []
    for i in range(B):
        st = int(states_np.status[i])
        if st == 0:
            st = 3 if int(states_np.iter[i]) >= budget.max_iter else 2
        res = _cache_solution(
            _index_state(states_np, i),
            setups[i],
            opts,
            t0,
            status=st,
            status_string=STATUS_STRINGS[st],
        )
        if st in (5, 6) and cert_opts.certificate_search:
            # batched certificate search: the reference always follows an
            # infeasible/unbounded declaration with a ray search
            # (pdhg.jl:639-676).  Declarations are rare, so rather than
            # carrying zeroed-operand variants through the vmapped program,
            # re-enter the single-instance driver warm-started from the
            # batch iterate — it re-declares within a few chunks and then
            # runs the standard certificate loop (ray checks, budgets,
            # snapshot-on-failure semantics identical to solver.solve).
            from ..solver import solve as _solve_single

            res = _solve_single(
                problems[i], cert_opts, warm_start=res
            )
        results.append(res)
    return results
