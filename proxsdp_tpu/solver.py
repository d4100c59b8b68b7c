"""PDHG (Chambolle-Pock) solver core.

Re-design of the reference's chambolle_pock loop (src/pdhg.jl:1-530) as a
pure ``state -> state`` function compiled once per problem geometry:

* the fixed-point iteration runs inside ``jax.lax.while_loop`` in CHUNKS —
  the device iterates flat-out for ``chunk_iters`` iterations (or until a
  status is set), and only then does the host sync a handful of scalars to
  handle wall-clock limits, logging, and certificate-search re-entry
  (reference does these every iteration from Julia; here they cost one
  device round-trip per chunk);
* all data-dependent control (Malitsky-Pock linesearch backtracking,
  adaptive beta, adaptive target-rank, stall/divergence detection) is
  branch-free scalar arithmetic carried in the state;
* the PSD projection uses a static-shape Lanczos with masked adaptive rank
  and a ``lax.cond`` fallback to dense eigh (ops/cones.py, ops/lanczos.py);
* the rolling stall-detection windows (reference CircularVector,
  src/structs.jl:2-30) are fixed-size arrays with modular indexing.

Certificate search (reference src/pdhg.jl:639-676): handled by the host
driver — it snapshots the solution, swaps the (same-shape) operands for the
zeroed-out versions, extends budgets, and re-enters the SAME compiled loop.
"""

from __future__ import annotations

import functools
import os
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .options import Options
from .problem import ConeLayout, ConicProblem, SetupProblem, preprocess
from .result import STATUS_STRINGS, Result
from .ops.cones import (
    box_projection,
    psd_projection_block,
    psd_projection_small_batch,
    soc_projection_block,
)
from .ops.linop import build_linop
from .ops.precision import full_f32
from .equilibration import equilibrate_host
from .utils.vech import offdiag_mask_tri, sympackedlen


class Operands(NamedTuple):
    """Device-side problem data (pytree; values can change without re-jit)."""

    M: object  # DenseOp | CooOp for [A; G]
    b: jax.Array
    h: jax.Array
    c: jax.Array
    norm_b: jax.Array
    norm_h: jax.Array
    norm_c: jax.Array
    chunk_end: jax.Array  # i32: run while iter < chunk_end
    # objective normalization factor (SetupProblem.obj_scale): the device
    # solves min <c/s, x>, but objectives/gap must be judged in USER units
    # (a gap computed on scaled objectives is ~s x looser wherever
    # |po|+|do| << s, which silently relaxes convergence)
    obj_scale: jax.Array = 1.0
    # row unscaling 1/E for the feasibility residual ((p+m,) under
    # equilibration, scalar 1.0 otherwise): feasibility must be measured
    # in USER units — an equilibrated row scaled down by 1e2 would
    # otherwise report a 1e2-smaller violation and let the solver declare
    # optimal at user-space lin_viol ~0.1 (observed on SDPLIB arch2)
    row_unscale: object = 1.0


class State(NamedTuple):
    # primal/dual iterates (reference PrimalDual + AuxiliaryData)
    x: jax.Array
    x_old: jax.Array
    y: jax.Array
    y_old: jax.Array
    Mx: jax.Array
    Mx_old: jax.Array
    Mty: jax.Array
    Mty_old: jax.Array
    # step/control scalars (reference Params)
    primal_step: jax.Array
    primal_step_old: jax.Array
    dual_step: jax.Array
    theta: jax.Array
    beta: jax.Array
    adapt_level: jax.Array
    iter: jax.Array  # i32, number of completed iterations
    status: jax.Array  # i32, 0 = running
    rank_update: jax.Array
    update_cont: jax.Array
    ada_count: jax.Array
    target_rank: jax.Array  # i32[nblocks]
    current_rank: jax.Array  # i32[nblocks]
    min_eig: jax.Array  # f[nblocks]
    # rolling windows, length 2*convergence_window (CircularVector analog)
    buf_gap: jax.Array
    buf_prim_obj: jax.Array
    buf_dual_obj: jax.Array
    buf_feas: jax.Array
    buf_pres: jax.Array
    buf_dres: jax.Array
    buf_comb: jax.Array
    equa_feas: jax.Array
    ineq_feas: jax.Array
    max_soc_gap: jax.Array
    # Lanczos warm-start vectors, one per PSD block (tuple of (side,) arrays)
    warm: tuple
    # certificate-search flags (host sets these between chunks):
    # cert_kind = 0 none, 6 = infeasibility (dual ray), 5 = unboundedness
    # (primal ray).  The kind rides the state so the PRIMAL-ray check can
    # run on-device at iteration granularity (status 7) — the unbounded
    # iterate grows geometrically and overflows within one chunk, so a
    # chunk-granular host check misses the certificate window.
    cert_kind: jax.Array  # i32
    cert_wait_until: jax.Array  # i32
    # suppress the STALL-BASED infeasibility/unboundedness heuristics until
    # this iteration (set by the host after a failed certificate search:
    # an unproven declaration must not immediately re-fire)
    infeas_block_until: jax.Array  # i32
    # host veto of an optimality declaration (check_dual_feas): suppress
    # re-declaring optimal until this iteration, so chunks keep amortizing
    # instead of degrading to one host dual_feas eigh per iteration
    # (cadence mirrors the reference's check_dual_feas_freq)
    opt_block_until: jax.Array  # i32
    # adaptive restart-to-average (restart="adaptive"): step-weighted
    # running sums of the iterates and their operator images (averaging
    # Mx/Mty is exact — M is linear — so a restart costs no matvec).
    # Zero-length arrays when the feature is off.
    avg_x: jax.Array
    avg_y: jax.Array
    avg_Mx: jax.Array
    avg_Mty: jax.Array
    avg_w: jax.Array
    last_restart_iter: jax.Array  # i32
    last_restart_gap: jax.Array
    # observability: count of iterations whose PSD projection ran the
    # dense eigh (gated, rejected-subspace fallback, or forced reseed) —
    # the subspace/Lanczos acceptance rate is 1 - proj_fallbacks/iter
    proj_fallbacks: jax.Array  # i32
    # latest subspace-projection diagnostics of PSD block 0
    # [rnmax/scale, min_theta, npos]; zeros outside subspace mode (they
    # ride the state so the chunk-boundary scalar fetch carries them)
    sub_stats: jax.Array  # solve dtype, (3,)
    # worst relative subspace residual over all blocks since the host
    # last reset it (drives host-side basis reseeds in accept-always /
    # batch mode, where there is no in-program eigh fallback)
    sub_worst: jax.Array  # solve dtype scalar


def _nblocks(layout: ConeLayout) -> int:
    return max(len(layout.sdp_sides), 1)


def init_state(
    layout: ConeLayout,
    opts: Options,
    setup: SetupProblem,
    warm: tuple | None = None,
) -> State:
    """Initial solver state (reference pdhg.jl:97-142).

    Built entirely with NumPy on the host — zero device round-trips; the
    first jitted chunk call transfers everything at once.

    warm: optional (x0, y0) in SOLVER space (permuted, sqrt2-scaled) —
    warm starting closes the reference's roadmap gap (README.md:145-148;
    its WarmStart struct is dead code, structs.jl:94-98).
    """
    dtype = np.float64 if opts.dtype == "float64" else np.float32
    n, pm = layout.n, layout.p + layout.m
    nb = _nblocks(layout)
    L = 2 * opts.convergence_window
    z = lambda *s: np.zeros(s, dtype)

    from .ops.linop import stack_vertical

    M_host = stack_vertical(setup.A, setup.G)

    # step sizes: tau = 1 / ||M|| (pdhg.jl:108-133)
    if opts.approx_norm:
        if hasattr(M_host, "multiply"):  # scipy sparse
            sn = float(np.sqrt(M_host.multiply(M_host).sum()))
        else:
            sn = float(np.linalg.norm(M_host))
    else:
        sn = _power_norm_host(M_host, n, opts.power_iters)
    if sn < 1e-10:
        sn = 1.0
    step = 1.0 / sn

    if warm is not None:
        x0 = np.asarray(warm[0], dtype=dtype)
        y0 = np.asarray(warm[1], dtype=dtype)
    else:
        x0 = (step * setup.c).astype(dtype) if opts.advanced_initialization else z(n)
        y0 = z(pm)
    Mx0 = np.asarray(M_host @ x0, dtype=dtype).ravel() if pm else z(pm)
    Mty0 = (
        np.asarray(M_host.T @ y0, dtype=dtype).ravel()
        if (warm is not None and pm)
        else z(n)
    )

    cold = warm is None
    rng = np.random.RandomState(opts.eigsolver_resid_seed)
    warm_vecs = []
    for side in layout.sdp_sides:
        k_sub = int(min(opts.subspace_rank, side))
        if k_sub > 0 and k_sub < side // 2:
            # subspace-projection mode: orthonormal (side, k) start basis
            V = rng.randn(side, k_sub)
            Q, _ = np.linalg.qr(V)
            warm_vecs.append(Q.astype(dtype))
        else:
            v = rng.randn(side)
            v /= max(np.linalg.norm(v), 1e-12)
            warm_vecs.append(v.astype(dtype))
    if not layout.sdp_sides:
        warm_vecs.append(z(1))

    # cold start: x_old / Mx_old stay ZERO like the reference's PrimalDual
    # (pdhg.jl:138-142 — advanced initialization sets x only); warm start
    # seeds the old iterates with the supplied point so the first
    # extrapolation is a fixed point of the warm solution.
    return State(
        x=x0,
        x_old=z(n) if cold else x0.copy(),
        y=y0,
        y_old=y0.copy(),
        Mx=Mx0,
        Mx_old=z(pm) if cold else Mx0.copy(),
        Mty=Mty0,
        Mty_old=Mty0.copy(),
        primal_step=dtype(step),
        primal_step_old=dtype(step),
        dual_step=dtype(step),
        theta=dtype(opts.initial_theta),
        beta=dtype(opts.initial_beta),
        adapt_level=dtype(opts.initial_adapt_level),
        iter=np.int32(0),
        status=np.int32(0),
        rank_update=np.int32(0),
        update_cont=np.int32(0),
        ada_count=np.int32(0),
        target_rank=np.full((nb,), 2, np.int32),
        current_rank=np.full((nb,), 2, np.int32),
        min_eig=z(nb),
        buf_gap=z(L),
        buf_prim_obj=z(L),
        buf_dual_obj=z(L),
        buf_feas=z(L),
        buf_pres=z(L),
        buf_dres=z(L),
        buf_comb=z(L),
        equa_feas=dtype(0.0),
        ineq_feas=dtype(0.0),
        max_soc_gap=dtype(-np.inf),
        warm=tuple(warm_vecs),
        cert_kind=np.int32(0),
        cert_wait_until=np.int32(0),
        infeas_block_until=np.int32(0),
        opt_block_until=np.int32(0),
        avg_x=z(n) if opts.restart == "adaptive" else z(0),
        avg_y=z(pm) if opts.restart == "adaptive" else z(0),
        avg_Mx=z(pm) if opts.restart == "adaptive" else z(0),
        avg_Mty=z(n) if opts.restart == "adaptive" else z(0),
        avg_w=dtype(0.0),
        last_restart_iter=np.int32(0),
        last_restart_gap=dtype(np.inf),
        proj_fallbacks=np.int32(0),
        sub_stats=np.zeros(3, dtype),
        sub_worst=dtype(0.0),
    )


def _power_norm_host(M, n, iters):
    """Spectral norm via host-side power iteration on M'M (deterministic)."""
    v = np.ones(n) / np.sqrt(n)
    for _ in range(iters):
        w = M.T @ (M @ v)
        nw = np.linalg.norm(w)
        if nw < 1e-30:
            return 0.0
        v = np.asarray(w).ravel() / nw
    return float(np.linalg.norm(M @ v))


def _norm_inf(v):
    return jnp.max(jnp.abs(v)) if v.shape[0] else jnp.asarray(0.0, v.dtype)


def _norm2(v):
    return jnp.sqrt(jnp.sum(v * v))


def _max_abs_cyclic_diff(buf):
    """max_i |v[i] - v[i-1]| over the cyclic buffer (structs.jl:14-20)."""
    return jnp.max(jnp.abs(buf - jnp.roll(buf, 1)))


def _primal_step(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """x <- proj_K(x - tau*(M'y + c)); Mx <- Mx (pdhg.jl:611-637)."""
    x = s.x - s.primal_step * (s.Mty + o.c)

    min_eig = s.min_eig
    current_rank = s.current_rank
    warm = list(s.warm)
    max_soc_gap = jnp.asarray(-jnp.inf, x.dtype)

    # relative-inexactness budget for the subspace projection: scale with
    # the latest combined PPA residual (clamped), so projection error
    # tracks outer-loop progress; before the first residual is available
    # (iter < 1) the buffer holds zeros -> falls back to subspace_tol
    accept_tol = None
    if opts.subspace_rank > 0 and opts.subspace_rel_accept > 0:
        L = s.buf_comb.shape[0]
        comb_prev = jnp.abs(s.buf_comb[(s.iter - 1) % L])
        accept_tol = jnp.minimum(
            opts.subspace_rel_accept * comb_prev, opts.subspace_accept_cap
        )

    # periodic forced dense-eigh pulse: reference full_eig_freq/full_eig_len
    # (prox_operators.jl:49) + the subspace-mode reseed (ADVICE r1: an
    # accepted subspace can hide a positive direction outside the basis)
    force_full = None
    if layout.sdp_sides:
        pulses = []
        if 0 < opts.full_eig_freq and opts.full_eig_len > 0:
            pulses.append((s.iter % opts.full_eig_freq) < opts.full_eig_len)
        if opts.subspace_rank > 0 and opts.subspace_reseed_freq > 0:
            pulses.append(
                (s.iter % opts.subspace_reseed_freq)
                == (opts.subspace_reseed_freq - 1)
            )
        for p in pulses:
            force_full = p if force_full is None else (force_full | p)

    # ---- group same-side SMALL blocks into one batched eigh (multi-block
    # parallelism, SURVEY §2.3): SDPLIB truss carries 100+ side-3 blocks;
    # a per-block loop serializes 100+ tiny eighs per iteration, a vmapped
    # (B, s, s) eigh is one batched kernel.  Grouping is only valid when
    # the gating statically guarantees the dense full path for that side.
    def _grouped(side: int) -> bool:
        k_sub = int(min(opts.subspace_rank, side))
        sub_on = 0 < k_sub < side // 2
        return (
            side <= opts.min_size_krylov_eigs
            and side <= opts.full_eig_max_side
            and not sub_on
        )

    by_side: dict = {}
    singles = []
    for bi, (off, side) in enumerate(zip(layout.sdp_offsets, layout.sdp_sides)):
        if _grouped(side):
            by_side.setdefault(side, []).append((bi, off))
        else:
            singles.append((bi, off, side))
    # groups of one gain nothing; keep them on the scalar path
    for side in [sd for sd, blks in by_side.items() if len(blks) < 2]:
        for bi, off in by_side.pop(side):
            singles.append((bi, off, side))
    singles.sort()

    any_full = None
    sub_stats = s.sub_stats
    sub_worst = s.sub_worst
    for side, blks in sorted(by_side.items()):
        tl = side * side if layout.square_form else sympackedlen(side)
        stacked = jnp.stack(
            [jax.lax.dynamic_slice(x, (off,), (tl,)) for _, off in blks]
        )
        blocks, me_b, cur_b, warm_b = psd_projection_small_batch(
            stacked, side, opt=opts
        )
        for gi, (bi, off) in enumerate(blks):
            x = jax.lax.dynamic_update_slice(x, blocks[gi], (off,))
            warm[bi] = warm_b[gi]
        idx = jnp.asarray([bi for bi, _ in blks], jnp.int32)
        min_eig = min_eig.at[idx].set(me_b.astype(min_eig.dtype))
        current_rank = current_rank.at[idx].set(cur_b)
        # full-path semantics: the dense eigh ran (matches the per-block
        # full path's used_full=True)
        any_full = (
            jnp.asarray(True) if any_full is None else any_full
        )

    for bi, off, side in singles:
        tl = side * side if layout.square_form else sympackedlen(side)
        res = psd_projection_block(
            jax.lax.dynamic_slice(x, (off,), (tl,)),
            side,
            s.target_rank[bi],
            s.warm[bi],
            opt=opts,
            allow_lanczos=True,
            accept_tol=accept_tol,
            force_full=force_full,
        )
        x = jax.lax.dynamic_update_slice(x, res.block, (off,))
        min_eig = min_eig.at[bi].set(res.min_eig.astype(min_eig.dtype))
        current_rank = current_rank.at[bi].set(res.current_rank)
        warm[bi] = res.warm
        any_full = res.used_full if any_full is None else (any_full | res.used_full)
        sub_worst = jnp.maximum(sub_worst, res.sub_stats[0])
        if bi == 0:
            sub_stats = res.sub_stats

    for off, ln in zip(layout.soc_offsets, layout.soc_lens):
        blk = jax.lax.dynamic_slice(x, (off,), (ln,))
        proj = soc_projection_block(blk)
        x = jax.lax.dynamic_update_slice(x, proj, (off,))
        gap = _norm2(proj[1:]) - proj[0]  # residuals.jl:83-86 on projected x
        max_soc_gap = jnp.maximum(max_soc_gap, gap)

    Mx = o.M.matvec(x)
    return s._replace(
        x=x,
        Mx=Mx,
        min_eig=min_eig,
        current_rank=current_rank,
        warm=tuple(warm),
        max_soc_gap=max_soc_gap,
        proj_fallbacks=s.proj_fallbacks
        + (any_full.astype(jnp.int32) if any_full is not None else 0),
        sub_stats=sub_stats,
        sub_worst=sub_worst,
    )


def _linesearch(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """Malitsky-Pock backtracking dual step (pdhg.jl:532-582)."""
    p_, m_ = layout.p, layout.m
    ps0 = s.primal_step * jnp.sqrt(1.0 + s.theta)

    class Carry(NamedTuple):
        ps: jax.Array
        theta: jax.Array
        y_temp: jax.Array
        Mty: jax.Array
        done: jax.Array
        i: jax.Array

    def cond(c: Carry):
        return (~c.done) & (c.i < opts.max_linsearch_steps)

    def body(c: Carry):
        theta = c.ps / s.primal_step_old
        bp = s.beta * c.ps
        y_half = s.y + bp * ((1.0 + theta) * s.Mx - theta * s.Mx_old)
        y_proj = box_projection(y_half, o.b, o.h, bp, p_, m_)
        y_temp = y_half - bp * y_proj
        Mty = o.M.rmatvec(y_temp)
        ok = jnp.sqrt(s.beta) * c.ps * _norm2(Mty - s.Mty_old) <= (
            opts.delta * _norm2(y_temp - s.y_old)
        )
        ps_next = jnp.where(ok, c.ps, c.ps * opts.linsearch_decay)
        return Carry(ps=ps_next, theta=theta, y_temp=y_temp, Mty=Mty, done=ok, i=c.i + 1)

    c0 = Carry(
        ps=ps0,
        theta=s.theta,
        y_temp=jnp.zeros_like(s.y),
        Mty=jnp.zeros_like(s.Mty),
        done=jnp.asarray(False),
        i=jnp.asarray(0, jnp.int32),
    )
    c = jax.lax.while_loop(cond, body, c0)
    return s._replace(
        y=c.y_temp,
        Mty=c.Mty,
        theta=c.theta,
        primal_step=c.ps,
        primal_step_old=c.ps,
        dual_step=s.beta * c.ps,
    )


def _dual_step(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """Fixed-step dual update (pdhg.jl:584-609)."""
    y_half = s.y + s.dual_step * (2.0 * s.Mx - s.Mx_old)
    y_proj = box_projection(y_half, o.b, o.h, s.dual_step, layout.p, layout.m)
    y_temp = y_half - s.dual_step * y_proj
    Mty = o.M.rmatvec(y_temp)
    return s._replace(y=y_temp, Mty=Mty, primal_step_old=s.primal_step)


def _residuals_and_gap(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """compute_residual! + compute_gap! (residuals.jl:2-71).

    All convergence-critical REDUCTIONS are accumulated in f64 even when
    the iterate dtype is f32: an f32 dot over 10^4-10^5 elements carries
    ~1e-4 relative noise, which would put a false floor exactly at the
    solver's default tolerance.  The f64 elementwise cast + reduce is
    vector-scale work — negligible next to the matvecs.
    """
    n, p_, m_ = layout.n, layout.p, layout.m
    L = s.buf_gap.shape[0]
    k = s.iter + 1
    idx = (k - 1) % L
    dtype = s.x.dtype
    rd = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def hi(v):
        return v.astype(rd)

    # f32 programs keep the vector work in f32 where that is exact:
    # * max-type reductions (inf-norms, feasibility) carry no
    #   accumulation error in f32 — run them natively and cast the scalar.
    # * dots use a two-stage sum: f32 products summed in 128-wide chunks
    #   (error ~64*eps_f32 ~ 8e-6 relative), then an exact f64 sum of the
    #   ~n/128 partials.  That is ~10x below the solver's 1e-4 tolerance,
    #   and the f64 phase re-judges every decision anyway.
    two_stage = dtype == jnp.float32 and jax.config.jax_enable_x64

    def me(v):
        """Elementwise precision for max-type reductions."""
        return v if two_stage else v.astype(rd)

    def f64_dot(a, b):
        if not two_stage:
            return jnp.dot(hi(a), hi(b))
        prod = a * b
        ch = 128
        pad = (-prod.shape[0]) % ch
        if pad:
            prod = jnp.concatenate(
                [prod, jnp.zeros((pad,), prod.dtype)]
            )
        part = jnp.sum(prod.reshape(-1, ch), axis=1)
        return jnp.sum(part.astype(rd))

    # Under the square-form layout the off-diagonal coordinates hold X_ij
    # (each twice) where the reference's scaled-tri coordinate is
    # sqrt(2)*X_ij: weight the x-space INF-norms by sqrt(2) on off-diagonal
    # square positions so pres matches the reference's norm exactly
    # (2-norms and dots are already exact — the embed is an isometry).
    # The weight is a trace-time constant folded into the adjacent fusion.
    xw = None
    if layout.square_form and layout.sdp_sides:
        w_host = np.ones(n)
        for off_b, side_b in zip(layout.sdp_offsets, layout.sdp_sides):
            Ib, Jb = np.meshgrid(
                np.arange(side_b), np.arange(side_b), indexing="ij"
            )
            offd = (Ib != Jb).reshape(-1)
            w_host[off_b : off_b + side_b * side_b][offd] = np.sqrt(2.0)
        xw = jnp.asarray(w_host, dtype)

    def xnorm_inf(v):
        return hi(_norm_inf(me(v) if xw is None else me(v * xw)))

    # primal PPA residual (sqrt(n) uses the tri-equivalent coordinate
    # count for parity with the reference's scaling, residuals.jl:46-55)
    Px_old = s.x_old - s.primal_step * s.Mty_old
    Px = s.x - s.primal_step * s.Mty
    pres = (
        jnp.sqrt(float(layout.n_tri))
        * xnorm_inf(Px - Px_old)
        / jnp.maximum(
            jnp.maximum(xnorm_inf(Px_old), jnp.maximum(hi(o.norm_b), hi(o.norm_h))), 1.0
        )
    )
    # dual PPA residual
    Py_old = s.y_old - s.dual_step * s.Mx_old
    Py = s.y - s.dual_step * s.Mx
    dres = (
        jnp.sqrt(float(p_ + m_))
        * hi(_norm_inf(me(Py - Py_old)))
        / jnp.maximum(
            jnp.maximum(hi(_norm_inf(me(Py_old))), hi(o.norm_c)), 1.0
        )
    )
    comb = jnp.maximum(pres, dres)

    # feasibility (one-sided for inequalities; residuals.jl:4-19),
    # measured in USER units: under equilibration the device rows are
    # E-scaled, so the raw residual hides violations on downscaled rows
    ru = jnp.asarray(o.row_unscale)
    ru_eq = me(ru[:p_]) if ru.ndim else me(ru)
    ru_in = me(ru[p_:]) if ru.ndim else me(ru)
    equa = (
        hi(_norm_inf((me(s.Mx[:p_]) - me(o.b)) * ru_eq)) / (1.0 + hi(o.norm_b))
        if p_
        else hi(s.equa_feas)
    )
    ineq = (
        hi(jnp.max((me(s.Mx[p_:]) - me(o.h)) * ru_in)) / (1.0 + hi(o.norm_h))
        if m_
        else hi(s.ineq_feas)
    )
    feas = jnp.maximum(equa if p_ else jnp.asarray(0.0, rd),
                       ineq if m_ else jnp.asarray(0.0, rd))

    prim_obj = f64_dot(o.c, s.x)
    dual_obj = jnp.asarray(0.0, rd)
    if p_:
        dual_obj = dual_obj - f64_dot(o.b, s.y[:p_])
    if m_:
        dual_obj = dual_obj - f64_dot(o.h, s.y[p_:])
    # user-unit objectives: undo the objective normalization so the gap,
    # the buffers, and the infeasibility heuristics all see the same
    # magnitudes the reference would (residuals.jl:56-60)
    prim_obj = prim_obj * hi(o.obj_scale)
    dual_obj = dual_obj * hi(o.obj_scale)
    gap = jnp.abs(prim_obj - dual_obj) / (1.0 + jnp.abs(prim_obj) + jnp.abs(dual_obj))
    pres = pres.astype(dtype)
    dres = dres.astype(dtype)
    comb = comb.astype(dtype)
    equa = equa.astype(dtype)
    ineq = ineq.astype(dtype)
    feas = feas.astype(dtype)
    prim_obj = prim_obj.astype(dtype)
    dual_obj = dual_obj.astype(dtype)
    gap = gap.astype(dtype)

    return s._replace(
        x_old=s.x,
        y_old=s.y,
        Mty_old=s.Mty,
        Mx_old=s.Mx,
        buf_pres=s.buf_pres.at[idx].set(pres),
        buf_dres=s.buf_dres.at[idx].set(dres),
        buf_comb=s.buf_comb.at[idx].set(comb),
        buf_feas=s.buf_feas.at[idx].set(feas),
        buf_gap=s.buf_gap.at[idx].set(gap),
        buf_prim_obj=s.buf_prim_obj.at[idx].set(prim_obj),
        buf_dual_obj=s.buf_dual_obj.at[idx].set(dual_obj),
        equa_feas=equa if p_ else s.equa_feas,
        ineq_feas=ineq if m_ else s.ineq_feas,
    )


def _bump_ranks(target, current, min_eig, sides_arr, opts: Options):
    """Adaptive target-rank increment (pdhg.jl:270-280, 289-303)."""
    eligible = ((current + opts.rank_slack) >= target) & (
        min_eig > opts.tol_psd
    )
    if opts.rank_increment == 0:
        new = target * opts.rank_increment_factor
    else:
        new = target + opts.rank_increment_factor
    new = jnp.minimum(new, sides_arr)
    return jnp.where(eligible, new, target)


def _control(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """Convergence / rank-update / divergence / adaptive-step branching +
    in-loop infeasibility detection (pdhg.jl:246-332, 390-483)."""
    k = s.iter + 1
    L = s.buf_gap.shape[0]
    idx = (k - 1) % L
    w = opts.convergence_window
    nb = _nblocks(layout)
    sides_arr = jnp.asarray(
        list(layout.sdp_sides) if layout.sdp_sides else [1], jnp.int32
    )

    gap_k = s.buf_gap[idx]
    feas_k = s.buf_feas[idx]
    pres_k = s.buf_pres[idx]
    dres_k = s.buf_dres[idx]
    comb_k = s.buf_comb[idx]
    prim_k = s.buf_prim_obj[idx]
    dual_k = s.buf_dual_obj[idx]
    comb_back = s.buf_comb[(k - w - 1) % L]

    # in certificate mode nothing below runs until the wait expires
    active = ~((s.cert_kind != 0) & (k < s.cert_wait_until))

    rank_update = s.rank_update + jnp.where(active, 1, 0)

    # --- rank convergence (residuals.jl:88-101) on the CURRENT projection
    if layout.sdp_sides:
        blk_conv = (
            (sides_arr < opts.min_size_krylov_eigs)
            | (s.target_rank > opts.max_target_rank_krylov_eigs)
            | (s.min_eig < opts.tol_psd)
        )
        rank_conv = jnp.all(blk_conv)
    else:
        rank_conv = jnp.asarray(True)
    soc_conv = (
        s.max_soc_gap < opts.tol_soc if layout.soc_lens else jnp.asarray(True)
    )

    conv = (gap_k <= opts.tol_gap) & (feas_k <= opts.tol_feasibility)
    opt_ok = conv & rank_conv & soc_conv & (k > opts.min_iter)

    status = jnp.where(
        active & opt_ok & (s.status == 0) & (k >= s.opt_block_until),
        1,
        s.status,
    )

    # --- branch 1b: converged gap/feas but rank not settled -> bump ranks
    b1 = active & conv & ~opt_ok & (rank_update > w)
    # --- branch 2: divergence (comb residual increasing over the window)
    b2 = active & ~conv & (k > w) & (comb_back < comb_k) & (rank_update > w)
    update_cont = s.update_cont + jnp.where(b1 | b2, 1, 0)
    do_bump1 = b1  # update_cont > 0 always holds right after increment
    do_bump2 = b2 & (update_cont > opts.divergence_min_update)

    new_target = _bump_ranks(s.target_rank, s.current_rank, s.min_eig, sides_arr, opts)
    target_rank = jnp.where(do_bump1 | do_bump2, new_target, s.target_rank)

    any_not_full = (
        jnp.any(s.target_rank < sides_arr) if layout.sdp_sides else jnp.asarray(False)
    )
    reset = do_bump1 | (do_bump2 & any_not_full)
    rank_update = jnp.where(reset, 0, rank_update)
    update_cont = jnp.where(reset, 0, update_cont)

    # --- branches 3/4: adaptive step-size balance (pdhg.jl:306-332).
    # "reference" fires on the absolute tolerance gates; "ratio"
    # (PDLP-style primal-weight balancing, an extension) fires
    # whenever one PPA residual exceeds the other by step_balance_ratio —
    # the absolute gates deadlock when both residuals sit just above
    # their tolerances at a skewed ratio (gpp500: pres/dres ~ 20x,
    # dres ~ 1.4e-4 > tol_dual, so the reference rule never rebalances).
    if opts.step_balance == "ratio":
        r_ = opts.step_balance_ratio
        b3 = active & ~conv & ~b2 & (pres_k > r_ * dres_k) & (k > w)
        b4 = active & ~conv & ~b2 & ~b3 & (dres_k > r_ * pres_k) & (k > w)
    else:
        b3 = active & ~conv & ~b2 & (pres_k > opts.tol_primal) & (dres_k < opts.tol_dual) & (k > w)
        b4 = (
            active & ~conv & ~b2 & ~b3
            & (pres_k < opts.tol_primal) & (dres_k > opts.tol_dual) & (k > w)
        )
    ada_count = s.ada_count + jnp.where(b3 | b4, 1, 0)
    fire3 = b3 & (ada_count > opts.adapt_window)
    fire4 = b4 & (ada_count > opts.adapt_window)
    ada_count = jnp.where(fire3 | fire4, 0, ada_count)
    al = s.adapt_level
    if opts.line_search_flag:
        beta = jnp.where(fire3, s.beta * (1.0 - al), s.beta)
        beta = jnp.where(fire4, beta / (1.0 - al), beta)
        primal_step = jnp.where(fire3, s.primal_step / jnp.sqrt(1.0 - al), s.primal_step)
        primal_step = jnp.where(fire4, primal_step * jnp.sqrt(1.0 - al), primal_step)
        dual_step = s.dual_step
    else:
        beta = s.beta
        primal_step = jnp.where(fire3, s.primal_step / (1.0 - al), s.primal_step)
        primal_step = jnp.where(fire4, primal_step * (1.0 - al), primal_step)
        dual_step = jnp.where(fire3, s.dual_step * (1.0 - al), s.dual_step)
        dual_step = jnp.where(fire4, dual_step / (1.0 - al), dual_step)
    adapt_level = jnp.where(fire3 | fire4, al * opts.adapt_decay, al)

    # --- in-loop infeasibility/unboundedness detection (not in cert mode)
    det = active & (s.cert_kind == 0) & (status == 0)
    isnan = jnp.isnan
    after_min = k > opts.min_iter_max_obj
    c_inf1 = (after_min & (dual_k > opts.max_obj)) | isnan(dual_k)
    c_unb1 = (after_min & (prim_k < -opts.max_obj)) | isnan(prim_k)
    stalled_feas = (
        after_min
        & (gap_k > opts.infeas_limit_gap_tol)
        & (feas_k > opts.infeas_feasibility_tol)
        & (_max_abs_cyclic_diff(s.buf_feas) < opts.infeas_stable_feasibility_tol)
    )
    stall100 = (
        after_min
        & (gap_k > 1.0 - opts.infeas_gap_tol)
        & (_max_abs_cyclic_diff(s.buf_gap) < opts.infeas_stable_gap_tol)
    )
    c_inf3 = stall100 & (jnp.abs(dual_k) > jnp.abs(prim_k)) & (
        feas_k > opts.infeas_feasibility_tol
    )
    c_unb2 = stall100 & (jnp.abs(prim_k) > jnp.abs(dual_k)) & (
        feas_k <= opts.tol_feasibility
    )
    # apply in reference order; first hit wins.  The objective-blowup
    # branches (c_inf1/c_unb1) are strong signals and always fire; the
    # stall-based heuristics are gated by infeas_block_until (a failed
    # certificate search suppresses re-declaration for a window)
    det_stall = det & (k >= s.infeas_block_until)
    status = jnp.where(det & c_inf1, 6, status)
    status = jnp.where(det & (status == 0) & c_unb1, 5, status)
    status = jnp.where(det_stall & (status == 0) & stalled_feas, 6, status)
    status = jnp.where(det_stall & (status == 0) & c_inf3, 6, status)
    status = jnp.where(det_stall & (status == 0) & c_unb2, 5, status)

    # --- in-search PRIMAL-ray detection (unboundedness certificate,
    # reference pdhg.jl:208-226).  Runs per-iteration on-device: along a
    # primal ray the objective grows geometrically (linesearch keeps
    # extending tau), so a chunk-granular host check overflows to NaN
    # before it ever sees the window.  Scale-invariant form: the
    # feasibility violation is measured per unit of objective magnitude.
    # Status 7 is internal — the host maps it to "[Primal ray found]".
    # NOT gated by the wait: the scale-invariant condition is
    # self-validating (||Ax|| small per unit of |c'x| with x in the cone
    # IS a recession direction), and on objective-blowup declarations the
    # ray is already present at search entry — waiting lets it overflow.
    ray5 = (
        (s.cert_kind == 5)
        & (status == 0)
        & (prim_k < -opts.certificate_obj_tol)
        & (feas_k < opts.tol_feasibility * jnp.maximum(jnp.abs(prim_k), 1.0))
    )
    status = jnp.where(ray5, 7, status)

    # --- adaptive restart-to-average (PDLP-style extension, no reference
    # counterpart).  Every restart_window iterations the gap
    # is compared against the last epoch: if it failed to shrink by
    # restart_decay while still above tolerance, the iterates jump to the
    # step-weighted running average (whose last-iterate 1/k tail is the
    # thing being cut) and the averages reset.  All branch-free.
    restart_updates = {}
    if opts.restart == "adaptive":
        p_, m_ = layout.p, layout.m
        ps = s.primal_step.astype(s.x.dtype)
        avg_x = s.avg_x + ps * s.x
        avg_y = s.avg_y + ps * s.y
        avg_Mx = s.avg_Mx + ps * s.Mx
        avg_Mty = s.avg_Mty + ps * s.Mty
        avg_w = s.avg_w + ps
        epoch = (
            active
            & (status == 0)
            & (s.cert_kind == 0)
            & ((k - s.last_restart_iter) >= opts.restart_window)
        )
        # Stall criterion for the epoch test (restart_trigger): "kkt"
        # uses max(gap, feasibility) (PDLP restart rule) — solves
        # control1 where the gap-only trigger under-fires; "gap" (the
        # default) uses the duality gap alone — on arch0/arch4 the kkt
        # trigger restarts into false INFEASIBLE declarations (measured,
        # r5 triage).  Adoption is gated on the full KKT metric either
        # way (metric_avg < 0.9 * metric_now below).
        if opts.restart_trigger == "kkt":
            metric_k = jnp.maximum(gap_k, feas_k)
        else:
            metric_k = gap_k
        stalled = (
            epoch
            & (metric_k > jnp.minimum(opts.tol_gap, opts.tol_feasibility))
            & (metric_k > opts.restart_decay * s.last_restart_gap)
            & jnp.isfinite(metric_k)
        )
        wsum = jnp.maximum(avg_w, jnp.asarray(1e-30, avg_w.dtype))
        # candidate quality: gap + feasibility of the AVERAGE, computed
        # from the carried operator images (no matvec).  The jump happens
        # only when the average measurably beats the current iterate —
        # a bad average is never adopted (PDLP's candidate-selection
        # principle), which prevents restart cascades.
        xa_ = avg_x / wsum
        ya_ = avg_y / wsum
        Mxa_ = avg_Mx / wsum
        po_a = jnp.dot(o.c, xa_) * o.obj_scale
        do_a = jnp.asarray(0.0, po_a.dtype)
        if p_:
            do_a = do_a - jnp.dot(o.b, ya_[:p_])
        if m_:
            do_a = do_a - jnp.dot(o.h, ya_[p_:])
        do_a = do_a * o.obj_scale
        gap_a = jnp.abs(po_a - do_a) / (1.0 + jnp.abs(po_a) + jnp.abs(do_a))
        feas_a = jnp.asarray(0.0, gap_a.dtype)
        if p_:
            feas_a = jnp.maximum(
                feas_a, _norm_inf(Mxa_[:p_] - o.b) / (1.0 + o.norm_b)
            )
        if m_:
            feas_a = jnp.maximum(
                feas_a, jnp.max(Mxa_[p_:] - o.h) / (1.0 + o.norm_h)
            )
        metric_now = jnp.maximum(gap_k, feas_k)
        metric_avg = jnp.maximum(gap_a, feas_a)
        stalled = stalled & (metric_avg < 0.9 * metric_now)

        def mix(avg, cur):
            return jnp.where(stalled, avg, cur)

        xa = mix(xa_, s.x)
        ya = mix(ya_, s.y)
        Mxa = mix(Mxa_, s.Mx)
        Mtya = mix(avg_Mty / wsum, s.Mty)
        keep = jnp.where(stalled, 0.0, 1.0).astype(avg_w.dtype)
        restart_updates = dict(
            x=xa, x_old=xa, y=ya, y_old=ya,
            Mx=Mxa, Mx_old=Mxa, Mty=Mtya, Mty_old=Mtya,
            avg_x=avg_x * keep, avg_y=avg_y * keep,
            avg_Mx=avg_Mx * keep, avg_Mty=avg_Mty * keep,
            avg_w=avg_w * keep,
            last_restart_iter=jnp.where(
                epoch, k, s.last_restart_iter
            ).astype(jnp.int32),
            last_restart_gap=jnp.where(
                epoch, metric_k, s.last_restart_gap
            ).astype(s.last_restart_gap.dtype),
        )

    return s._replace(
        status=status,
        rank_update=rank_update,
        update_cont=update_cont,
        ada_count=ada_count,
        target_rank=target_rank,
        beta=beta,
        primal_step=primal_step,
        dual_step=dual_step,
        adapt_level=adapt_level,
        iter=k,
        **restart_updates,
    )


def make_chunk_runner(layout: ConeLayout, opts: Options):
    """Build the jitted chunk executor for a given problem geometry.

    The chunk program traces under full-f32 matmul precision
    (ops/precision.full_f32): no f32 product in the PDHG iteration runs
    in a reduced format.  Callers that trace ``iteration`` into their own
    program (parallel/batch.py) apply the same policy at their jit.
    """

    def iteration(s: State, o: Operands) -> State:
        s = _primal_step(s, o, layout, opts)
        if opts.line_search_flag:
            s = _linesearch(s, o, layout, opts)
        else:
            s = _dual_step(s, o, layout, opts)
        s = _residuals_and_gap(s, o, layout, opts)
        s = _control(s, o, layout, opts)
        return s

    def run_chunk(s: State, o: Operands) -> State:
        def cond(s: State):
            return (s.status == 0) & (s.iter < o.chunk_end)

        def body(s: State):
            return iteration(s, o)

        return jax.lax.while_loop(cond, body, s)

    # donate the state: the loop carry is rewritten in place on device
    run_chunk_jit = jax.jit(full_f32(run_chunk), donate_argnums=(0,))

    def fetch(s: State):
        """All host-monitored scalars in ONE device->host transfer."""
        L = s.buf_gap.shape[0]
        i = (s.iter - 1) % L
        ft = s.buf_gap.dtype
        return jnp.stack(
            [
                s.iter.astype(ft),
                s.status.astype(ft),
                s.buf_gap[i],
                s.buf_feas[i],
                s.buf_prim_obj[i],
                s.buf_dual_obj[i],
                s.buf_pres[i],
                s.buf_dres[i],
                s.buf_comb[i],
                jnp.sum(s.target_rank).astype(ft),
                s.proj_fallbacks.astype(ft),
                s.sub_stats[0].astype(ft),
                s.sub_stats[1].astype(ft),
                s.sub_stats[2].astype(ft),
            ]
        )

    return run_chunk_jit, iteration, jax.jit(fetch)


# Options fields that do NOT affect the traced program (host-driver only).
# Normalizing them before keying the jit cache prevents gratuitous
# recompiles.
_DRIVER_ONLY_DEFAULTS = dict(
    log_verbose=False,
    log_freq=1000,
    timer_verbose=False,
    timer_file=False,
    disable_julia_logger=True,
    warn_on_limit=False,
    extended_log=False,
    extended_log2=False,
    log_repeat_header=False,
    time_limit=360000.0,
    max_iter=0,
    max_iter_lp=10_000_000,
    max_iter_conic=1_000_000,
    chunk_iters=0,
    certificate_search=True,
    certificate_obj_tol=1e-1,
    certificate_fail_tol=1e-8,
    eigsolver_resid_seed=1234,
    approx_norm=True,
    power_iters=50,
    hybrid_precision=True,
    hybrid_switch_factor=10.0,
    checkpoint_path="",
    checkpoint_freq=0,
    polish_subspace=True,
    polish_subspace_guard=8,
    race_subspace=True,
    race_subspace_warmup=100,
    linop="auto",
    check_dual_feas=False,
    check_dual_feas_freq=1000,
    square_form=True,
)


def _runner_key_options(opts: Options) -> Options:
    return opts.replace(**_DRIVER_ONLY_DEFAULTS)


@functools.lru_cache(maxsize=64)
def _cached_runner_normalized(layout: ConeLayout, opts: Options):
    return make_chunk_runner(layout, opts)


def _cached_runner(layout: ConeLayout, opts: Options):
    return _cached_runner_normalized(layout, _runner_key_options(opts))


# Measured per-iteration wall rate of each compiled chunk program, kept
# across solves (same key as the runner cache).  A warm re-solve sizes its
# FIRST chunk from the previous solve's measured rate instead of the
# conservative cold-start guess, collapsing a short solve to one chunk —
# each avoided chunk boundary saves a dispatch + scalar fetch round-trip.
_RATE_CACHE: dict = {}


def _rate_key(layout: ConeLayout, opts: Options):
    return (layout, _runner_key_options(opts))


def _sub_bucket(k: int) -> int:
    """Round a polish-subspace width up to a bounded set of buckets (each
    bucket is a separate compiled program). 0 = rank too large, use dense
    eigh.

    The 192/256 buckets only engage at sides > 384/512 (the caller
    requires k < side/2) — the sides where falling back to the dense
    program means a large f64 eigh per iteration (gpp500-2 hands over at
    observed rank 126, which overflowed an earlier 128 cap)."""
    for b in (16, 24, 32, 48, 64, 96, 128, 192, 256):
        if k <= b:
            return b
    return 0


def _estimate_subspace(
    state: State, layout: ConeLayout, opts: Options, c_host=None
):
    """Host-side per-block eigh: RELATIVE-threshold rank estimate (the
    device's current_rank counts every eigenvalue above the absolute
    tol_psd — hugely inflated mid-convergence) and the exact top-k basis so
    a subspace phase starts with zero fallback iterations.

    Returns (k_bucket, r_obs, specs) with specs = [(side, V, r_blk)];
    k_bucket == 0 means the observed rank is too large for subspace mode.
    """
    from .ops.tri import _maps as _tri_maps

    # rank and basis of the PRE-projection matrix x - tau*(M'y + c): that
    # is the matrix the PSD projection acts on, so its positive eigenspace
    # is what the warm basis must cover.  The POST-projection iterate
    # under-counts whenever the current subspace is too small (the iterate
    # converges to the restricted-face optimum at exactly the basis rank,
    # so estimating from x can never see the missing directions).
    if c_host is not None:
        # ONE batched device->host pull of x, Mty and tau
        x_d, mty_d, tau_d = jax.device_get(
            [state.x, state.Mty, state.primal_step]
        )
        x_host = np.asarray(x_d, np.float64) - float(tau_d) * (
            np.asarray(mty_d, np.float64) + np.asarray(c_host, np.float64)
        )
    else:
        x_host = np.asarray(jax.device_get(state.x), np.float64)
    specs = []
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        if layout.square_form:
            Xm = x_host[off : off + side * side].reshape(side, side)
            Xm = 0.5 * (Xm + Xm.T)
        else:
            tl = sympackedlen(side)
            gidx, in_scale, _, _ = _tri_maps(side)
            Xm = (x_host[off : off + tl][gidx] * in_scale).reshape(side, side)
        w, V = np.linalg.eigh(Xm)
        lam_max = max(float(w[-1]), 0.0)
        r_blk = int(np.sum(w > max(opts.tol_psd, 1e-4 * max(lam_max, 1e-12))))
        specs.append((side, V, r_blk))
    if not specs:
        return 0, 0, specs
    r_obs = max(r for _, _, r in specs)
    k = _sub_bucket(r_obs + opts.polish_subspace_guard)
    if not (k and any(k < side // 2 for side in layout.sdp_sides)):
        return 0, r_obs, specs
    return k, r_obs, specs


def _seed_subspace_warm(state: State, specs, k: int, dtype) -> State:
    """Replace the warm pytree leaves with exact top-k bases (from
    _estimate_subspace) for blocks that run in subspace mode."""
    new_warm = []
    for bi, (side, V, _r) in enumerate(specs):
        k_sub = int(min(k, side))
        if 0 < k_sub < side // 2:
            Vk = V[:, -k_sub:][:, ::-1].copy()
            new_warm.append(jnp.asarray(Vk, dtype))
        else:
            new_warm.append(jnp.asarray(state.warm[bi], dtype))
    return state._replace(warm=tuple(new_warm))


def _cast_state(s: State, dtype) -> State:
    """Cast the float leaves of the state to ``dtype`` (hybrid-precision
    hand-over) and clear the status so the target-precision program
    re-judges convergence from live residuals."""

    def cast(x):
        x = jnp.asarray(x)
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    s = jax.tree_util.tree_map(cast, s)
    return s._replace(status=jnp.asarray(0, jnp.int32))


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def _fix_diag_scaling(x: np.ndarray, layout: ConeLayout, num: float) -> np.ndarray:
    """Divide off-diagonal triangle entries by ``num`` (pdhg.jl:734-743)."""
    x = x.copy()
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        tl = sympackedlen(side)
        mask = offdiag_mask_tri(side)
        x[off : off + tl][mask] /= num
    return x


def _cone_feas(v: np.ndarray, layout: ConeLayout) -> float:
    """Max violation of v against K (reference cone_feas, pdhg.jl:678-699)."""
    from .utils.vech import ivec

    viol = 0.0
    sq2 = np.sqrt(2.0)
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        tl = sympackedlen(side)
        blk = v[off : off + tl].copy()
        mask = offdiag_mask_tri(side)
        blk[mask] /= sq2
        if side == 1:
            viol = max(viol, -min(0.0, blk[0]))
        elif not np.all(np.isfinite(blk)):
            viol = np.inf
        else:
            try:
                w = np.linalg.eigvalsh(ivec(blk))
                viol = max(viol, -min(0.0, w.min()))
            except np.linalg.LinAlgError:
                viol = np.inf
    for off, ln in zip(layout.soc_offsets, layout.soc_lens):
        sblk = v[off : off + ln]
        viol = max(viol, -min(0.0, sblk[0] - np.linalg.norm(sblk[1:])))
    return viol


def _dual_feas_host(
    y: np.ndarray, setup: SetupProblem, c_used: np.ndarray
) -> float:
    """Dual feasibility violation (reference dual_feas, pdhg.jl:712-732)."""
    layout = setup.layout
    p_ = layout.p
    dual_eq = y[:p_]
    dual_in = y[p_:]
    dual_cone = c_used + _TA(setup.A_orig, dual_eq, layout.n) + _TA(
        setup.G_orig, dual_in, layout.n
    )
    dual_cone = _fix_diag_scaling(dual_cone, layout, 2.0)

    ineq_viol = -min(0.0, dual_in.min()) if dual_in.size else 0.0
    cone_viol = _cone_feas(dual_cone, layout)
    tail = dual_cone[layout.cone_dim :]
    zero_viol = np.abs(tail).max() if tail.size else 0.0
    return max(cone_viol, ineq_viol, zero_viol)


def _TA(M, y, n):
    if y.size == 0:
        return np.zeros(n)
    return np.asarray(M.T @ y).ravel()


class _Budget:
    """Mutable iteration/time budgets (reference opt.max_iter_local +
    certificate_parameters, pdhg.jl:670-676)."""

    def __init__(self, opts: Options, has_cones: bool):
        if opts.max_iter <= 0:
            self.max_iter = opts.max_iter_conic if has_cones else opts.max_iter_lp
        else:
            self.max_iter = opts.max_iter
        self.hard_cap = 2 * self.max_iter
        self.time_limit = opts.time_limit


def solve(
    problem,
    options: Options | None = None,
    warm_start=None,
    resume_from: str | None = None,
    **kwargs,
) -> Result:
    """Solve a ConicProblem (or pre-built SetupProblem). Main entry point.

    warm_start: a previous Result for the same problem geometry, or a
    tuple (x, dual_eq, dual_in) in user variable order.  (The reference
    lists warm starting as roadmap future work, README.md:145-148.)

    resume_from: path to a checkpoint written via the checkpoint_path /
    checkpoint_freq options — continues the PDHG loop from the saved
    state (same problem + geometry required).
    """
    opts = options or Options()
    if kwargs:
        opts = opts.replace(**kwargs)

    t0 = time.time()
    setup = (
        preprocess(
            problem,
            scale_objective=opts.scale_objective,
            scale_rhs=opts.scale_rhs,
        )
        if isinstance(problem, ConicProblem)
        else problem
    )
    layout = setup.layout
    dtype = jnp.float64 if opts.dtype == "float64" else jnp.float32

    if opts.log_verbose:
        _print_header(layout, opts)

    # block_equilibration="auto": race both preconditioners for a short
    # probe and continue with the winner (see Options for the rationale —
    # a static spread gate mispredicts within a single SDPLIB family)
    if (
        opts.block_equilibration == "auto"
        and opts.block_equilibration_probe_spread > 0
        and warm_start is None
        and resume_from is None
        and isinstance(problem, ConicProblem)
        and _row_norm_spread(setup) > opts.block_equilibration_probe_spread
    ):
        return _solve_with_beq_probe(problem, opts, t0)

    # optional diagonal preconditioning (reference pdhg.jl:64-92); mutates
    # setup.A/G/b/h/c before the operator and step sizes are built
    equil = None
    beq = opts.block_equilibration
    if isinstance(beq, str) and beq != "auto":
        # option-string coercion ("True"/"false"/"on"/"0" via --opt etc);
        # any unrecognized string must not silently enable the preconditioner
        beq = beq.lower() in ("1", "true", "yes", "on")
    if beq == "auto":
        beq = _row_norm_spread(setup) > opts.block_equilibration_spread
    if beq:
        from .equilibration import block_equilibrate_host

        equil = block_equilibrate_host(setup, opts)
    elif opts.equilibration or opts.equilibration_force:
        equil = equilibrate_host(setup, opts)

    # Square-form device coordinates (ConeLayout.square_form): fold the
    # tri<->square isometry into A/G/c once on the host so the jitted loop
    # never runs the packed-triangle index maps (gathers over the whole
    # PSD segment every iteration).  setup_h keeps the tri-space data
    # for solution recovery, dual-feasibility checks and certificates.
    setup_h = setup
    if opts.square_form and layout.sdp_sides:
        from .problem import to_square_form

        setup = to_square_form(setup)
        layout = setup.layout

    def make_operands(dt):
        force = None if opts.linop == "auto" else opts.linop
        M = build_linop(setup.A, setup.G, dt, force=force)
        if opts.tp_shards > 0:
            from .ops.linop import shard_linop
            from .parallel.sharded import current_tp_mesh

            ctx = current_tp_mesh()
            if ctx is not None:
                M = shard_linop(M, *ctx)
        return Operands(
            M=M,
            b=jnp.asarray(setup.b, dt),
            h=jnp.asarray(setup.h, dt),
            c=jnp.asarray(setup.c, dt),
            norm_b=jnp.asarray(setup.norm_b, dt),
            norm_h=jnp.asarray(setup.norm_h, dt),
            norm_c=jnp.asarray(setup.norm_c, dt),
            chunk_end=jnp.asarray(0, jnp.int32),
            obj_scale=jnp.asarray(setup.obj_scale * setup.rhs_scale, dt),
            row_unscale=(
                jnp.asarray(1.0 / equil.E, dt)
                if equil is not None
                else jnp.asarray(1.0, dt)
            ),
        )

    operands = make_operands(dtype)
    run_chunk, _, fetch = _cached_runner(layout, opts)
    prog_opts = opts  # options of the ACTIVE f64 chunk program

    warm = None
    if warm_start is not None:
        # user space -> solver space: inverse of cache_solution's
        # unscale/unpermute chain (pdhg.jl:745-787)
        if isinstance(warm_start, Result):
            x_u = warm_start.primal
            y_s = np.concatenate([warm_start.dual_eq, warm_start.dual_in])
        else:
            x_u, y_eq, y_in = warm_start
            y_s = np.concatenate(
                [np.asarray(y_eq, np.float64), np.asarray(y_in, np.float64)]
            )
        ord_ = np.argsort(setup_h.var_ordering)
        x_s = np.asarray(x_u, np.float64)[ord_]
        if equil is not None:
            x_s = x_s / equil.D
            y_s = y_s / equil.E
        x_s = _fix_diag_scaling(x_s, setup_h.layout, 1.0 / np.sqrt(2.0))
        x_s = x_s / setup_h.rhs_scale  # user primal -> rhs-scaled primal
        y_s = y_s / setup_h.obj_scale  # user duals -> scaled-obj duals
        if layout.square_form:
            from .problem import square_embed_matrix

            x_s = square_embed_matrix(setup_h.layout) @ x_s
        warm = (x_s, y_s)

    # Hybrid precision: race in f32, confirm/finish in f64 (the optimality
    # decision is only ever made by the f64 program).
    hybrid = opts.dtype == "float64" and opts.hybrid_precision
    if hybrid:
        opts32 = opts.replace(dtype="float32")
        if opts.projection == "auto":
            # race phase: matmul-only polar projection — deterministic
            # latency vs eigh's data-dependent 0.45..322ms (cones.py);
            # subspace-mode rejections also reseed via the sign projector
            opts32 = opts32.replace(
                projection="polar", subspace_fallback="polar"
            )
        operands32 = make_operands(jnp.float32)
        run_chunk32, _, fetch32 = _cached_runner(layout, opts32)
        prog_opts32 = opts32  # options of the ACTIVE f32 chunk program
        state = init_state(layout, opts32, setup, warm=warm)
        phase32 = True
    else:
        state = init_state(layout, opts, setup, warm=warm)
        phase32 = False

    sub32 = {
        # f32 race phase subspace-entry state: retry while the observed
        # rank is still too large (bounded; each try is one host eigh)
        "entered": False,
        "tries": 0,
        "retry_at": opts.race_subspace_warmup,
    }
    polish_ctx = {
        # f64 polish watchdog: a subspace whose rank is too small admits a
        # WRONG fixed point (the restricted-face optimum: PPA residuals
        # vanish, gap stalls above tol).  Track gap improvement (in
        # iterations — chunk sizes adapt) and on stall restart the steps
        # and re-estimate the rank from the pre-projection matrix,
        # escalating the bucket or dropping to the dense-eigh program.
        "k_sub": 0,
        "best": float("inf"),
        "since": None,
        # exponential backoff on the restart window: on oscillating
        # problems (SDPLIB truss6) a fixed window fires a restart every
        # couple of chunks, and each reset kicks the iterate — a restart
        # CASCADE that prevents convergence entirely.  Double the window
        # per restart (capped); a 1.2x metric improvement resets it.
        "window_mult": 1,
        # pre-restart snapshot for the guarded-restart rollback:
        # (host state, metric, iter, (phase32, k_sub)) or None
        "guard": None,
    }

    # Dense f64 eigh fallbacks cost O(side^3) per rejected iteration and
    # dominate the polish at large sides.  Above this threshold the f64
    # subspace programs use the f32-COMPUTE polar reseed as their
    # rejection fallback: projection inexactness ~1e-5 relative while
    # gap/feasibility decisions stay f64 on the iterate — an order of
    # magnitude inside the 1e-4 default tolerance.  The threshold is not
    # yet measured on the H100.
    big_side = (
        max(layout.sdp_sides)
        > min(opts.full_eig_max_side, opts.polar_fallback_min_side)
        if layout.sdp_sides
        else False
    )
    polish_fb = {"subspace_fallback": "polar"} if big_side else {}

    if resume_from:
        from .utils.checkpoint import load_checkpoint

        state, saved_phase32 = load_checkpoint(
            resume_from, expect_square_form=layout.square_form
        )
        if hybrid and saved_phase32:
            phase32 = True
            if (
                layout.sdp_sides
                and np.asarray(state.warm[0]).ndim == 2
                and opts.subspace_rank == 0
            ):
                # checkpoint was taken in the f32 subspace race phase
                k_saved = int(np.asarray(state.warm[0]).shape[1])
                prog_opts32 = opts32.replace(subspace_rank=k_saved)
                run_chunk32, _, fetch32 = _cached_runner(
                    layout, prog_opts32
                )
                sub32["entered"] = True
        else:
            phase32 = False
            if jnp.asarray(state.x).dtype != dtype:
                state = _cast_state(state, dtype)
            if (
                layout.sdp_sides
                and np.asarray(state.warm[0]).ndim == 2
                and opts.subspace_rank == 0
            ):
                # checkpoint was taken in the subspace-polish phase:
                # rebuild the matching runner
                k_saved = int(np.asarray(state.warm[0]).shape[1])
                prog_opts = opts.replace(
                    subspace_rank=k_saved, **polish_fb
                )
                run_chunk, _, fetch = _cached_runner(layout, prog_opts)

    budget = _Budget(opts, bool(layout.sdp_sides or layout.soc_lens))
    # Convergence/divergence/adaptive logic runs ON DEVICE every iteration;
    # the chunk boundary only gates wall-clock checks, logging and
    # certificate-search entry, so large chunks are safe and amortize the
    # per-chunk dispatch and scalar-fetch cost.
    if opts.chunk_iters:
        chunk = chunk_cap = opts.chunk_iters
    elif opts.log_verbose:
        chunk = chunk_cap = max(
            min(opts.log_freq, 1024), opts.convergence_check
        )
    else:
        # non-verbose: let measured-rate chunks grow well past the first
        # guess — the device loop exits the chunk the moment status
        # flips, so oversized chunks cost nothing, while each chunk
        # boundary costs a host sync
        chunk = 1024
        chunk_cap = 8192
    # adaptive chunk controller: a single XLA execution that runs for
    # minutes starves the wall-clock checks (time_limit, logging,
    # checkpoints).  Target ~15 s per execution, measured from the second
    # chunk of each program (the first includes compile time).  chunk_end
    # is a traced operand, so resizing is free.
    chunk_max = chunk_cap
    chunk_target_s = 15.0
    chunk_meas = {"per_iter": None, "skip_next": True, "key": None}

    def _size_chunk(rate: float) -> int:
        # 100-iteration dispatch-amortization floor, lowered to 20 for
        # programs slow enough (> 0.15 s/iter) that a floored chunk would
        # hold the host for many times the 15 s target
        floor_it = 100 if rate <= 0.15 else 20
        return int(min(max(chunk_target_s / rate, floor_it), chunk_max))

    def _set_rate_key(po: Options) -> None:
        """Point the chunk controller at the active program's rate-cache
        entry and, when a prior solve measured this program, size the next
        chunk from that rate directly."""
        nonlocal chunk
        chunk_meas["key"] = _rate_key(layout, po)
        cached = _RATE_CACHE.get(chunk_meas["key"])
        if cached:
            chunk = _size_chunk(cached)
    # cold-start chunk: bound the first executions by a crude per-iteration
    # cost model (the eigh work sum(side^3) dominates) so huge blocks don't
    # hold the host for minutes before the first rate measurement exists
    est_iter_s = 3e-10 * sum(sd**3 for sd in layout.sdp_sides) + 1e-5
    chunk0 = int(min(max(chunk_target_s / est_iter_s, 20), 256))
    # f64 programs can hit data-dependent dense-eigh iterations ~10x the
    # cost model: size their COLD chunks so even a 10x-slow chunk stays
    # near the target.  Once a real rate is measured the adaptive
    # controller takes over.  None of these constants is yet measured on
    # the H100.
    chunk0_cons = int(min(max(chunk_target_s / (10 * est_iter_s), 20), 256))
    chunk = min(chunk, chunk0 if (opts.dtype == "float32" or
                                  (opts.hybrid_precision and
                                   opts.dtype == "float64"))
                else chunk0_cons)
    log_next = opts.log_freq
    ckpt_next = opts.checkpoint_freq
    _set_rate_key(prog_opts32 if phase32 else prog_opts)

    cert_ctx = {
        "snapshot": None,  # Result cached when declaring 5/6
        "mode": 0,  # 0 none, 5/6 = the status being certified
        "found": False,
        "fail_reason": "",
        "resume_state": None,  # host copy of the pre-certificate state
        "entries": 0,  # searches started (capped: _MAX_CERT_SEARCHES)
    }
    # stall windows are measured in ITERATIONS (chunk sizes adapt, so a
    # chunk count would make stall declarations chunk-size dependent —
    # measured: gpp500's f32 race was cut at gap 1.4e-1 with 100-iter
    # chunks where 400-iter chunks let it reach 7.6e-4)
    stall_window = max(3 * opts.convergence_window, 1500)
    hybrid_best = {"value": float("inf"), "since": 0}
    # best iterate seen across the whole solve, scored by
    # max(rel gap, user-unit feasibility) at chunk boundaries.  PDHG is
    # non-monotone, so at a limit/demoted status the final iterate (or the
    # declaration-time snapshot of a failed certificate search) can be far
    # worse than the best point the trajectory passed through — observed on
    # truss6, where the declaration snapshot was the near-zero cold start.
    # The reference returns its cached solution at limits
    # (pdhg.jl:335-382); keeping the best-scored one is the same idea with
    # a better cache policy.  Only the fields _cache_solution reads are
    # copied (x/y + the residual ring buffers), not the whole state.
    # "snap" holds the fields _cache_solution reads; "full" is the whole
    # host-copied state (for resuming a failed certificate search from the
    # best point instead of the declaration-time one), valid only while
    # the compiled program that produced it is still current ("tag").
    # "t" starts at t0: best-iterate snapshots only matter for limit
    # returns of LONG solves, so the first blocking D2H copy is deferred
    # until the solve is at least one rate-limit interval old (a sub-2s
    # warm solve pays zero snapshot cost; the final iterate is always
    # compared at return time regardless)
    best_ctx = {"score": float("inf"), "snap": None, "full": None,
                "tag": None, "t": t0}
    _SNAP_FIELDS = (
        "x", "y", "iter", "current_rank", "buf_gap", "buf_prim_obj",
        "buf_dual_obj", "buf_feas", "buf_pres", "buf_dres",
    )
    tau0 = float(state.primal_step)

    # --- observability (reference: TimerOutputs spans, SURVEY.md §5).
    # Host-side phase timers always collected; timer_verbose prints the
    # report, timer_file writes time.log; an XLA profiler trace can be
    # captured with PROXSDP_TPU_TRACE_DIR (a failure to start it raises).
    timers = {"setup": time.time() - t0, "f32 loop": 0.0, "f64 loop": 0.0,
              "host sync": 0.0, "snapshot": 0.0, "finalize": 0.0}
    chunk_counts = {"f32": 0, "f64": 0}
    # fallback attribution: projection fallbacks counted during the f32
    # race are matmul-only polar reseeds when the race program's
    # subspace_fallback is "polar" — NOT dense eighs; record the counter
    # at the phase hand-over so the report can split them honestly
    fb_ctx = {
        "f32": 0,
        "f32_is_polar": bool(
            hybrid
            and getattr(opts32, "subspace_fallback", "eigh") == "polar"
        ),
    }
    trace_dir = os.environ.get("PROXSDP_TPU_TRACE_DIR")
    if trace_dir:
        jax.profiler.start_trace(trace_dir)

    def fetch_scalars(s):
        f = fetch32 if phase32 else fetch
        v = np.asarray(f(s))  # one device->host transfer
        return {
            "iter": int(v[0]),
            "status": int(v[1]),
            "gap": float(v[2]),
            "feas": float(v[3]),
            "prim_obj": float(v[4]),
            "dual_obj": float(v[5]),
            "pres": float(v[6]),
            "dres": float(v[7]),
            "comb": float(v[8]),
            "sum_target_rank": int(v[9]),
            "proj_fallbacks": int(v[10]),
            "sub_rel_resid": float(v[11]),
            "sub_min_theta": float(v[12]),
            "sub_npos": int(v[13]),
        }

    final_status = None
    status_string = None

    while True:
        k0 = int(state.iter)
        cap = budget.hard_cap if cert_ctx["mode"] != 0 else budget.max_iter
        # if the clock already ran out, run a single iteration so the limit
        # handler sees fresh residuals (reference checks time every iter)
        step_n = 1 if (time.time() - t0) >= budget.time_limit else chunk
        target = min(k0 + step_n, cap)
        if target <= k0 and k0 > 0:
            # already at the iteration cap (e.g. hybrid hand-over at the
            # limit): don't run more iterations, judge the latest residuals
            pass
        else:
            target = max(target, k0 + 1)
            ce = jnp.asarray(target, jnp.int32)
            t_chunk = time.time()
            try:
                if phase32:
                    operands32 = operands32._replace(chunk_end=ce)
                    state = run_chunk32(state, operands32)
                    jax.block_until_ready(state.x)
                    timers["f32 loop"] += time.time() - t_chunk
                    chunk_counts["f32"] += 1
                else:
                    operands = operands._replace(chunk_end=ce)
                    state = run_chunk(state, operands)
                    jax.block_until_ready(state.x)
                    timers["f64 loop"] += time.time() - t_chunk
                    chunk_counts["f64"] += 1
            except jax.errors.JaxRuntimeError as e:
                e.add_note(
                    f"proxsdp: chunk from iter {k0} to {target} "
                    f"(phase={'f32' if phase32 else 'f64'})"
                )
                raise
            dt_chunk = time.time() - t_chunk
            ran = target - k0
            if chunk_meas["skip_next"]:
                # first execution of a (possibly fresh) program: compile
                # time pollutes the measurement; size the next chunk from
                # a prior solve's measured rate when one exists
                cached_rate = _RATE_CACHE.get(chunk_meas["key"])
                if cached_rate:
                    chunk = _size_chunk(cached_rate)
                else:
                    chunk = min(chunk, chunk0_cons)
                chunk_meas["skip_next"] = False
            elif ran > 0 and dt_chunk > 0.05:
                per = dt_chunk / ran
                old = chunk_meas["per_iter"]
                chunk_meas["per_iter"] = per if old is None else (
                    0.5 * old + 0.5 * per
                )
                if chunk_meas["key"] is not None:
                    _RATE_CACHE[chunk_meas["key"]] = chunk_meas["per_iter"]
                chunk = _size_chunk(chunk_meas["per_iter"])
        t_sync = time.time()
        sc = fetch_scalars(state)
        timers["host sync"] += time.time() - t_sync
        k, st = sc["iter"], sc["status"]
        elapsed = time.time() - t0

        def take_snapshot(score):
            """Copy the current iterate as the best-scored snapshot (one
            batched device_get of every leaf, a single barrier, instead of
            one blocking np.asarray per leaf)."""
            t_snap = time.time()
            best_ctx["t"] = t_snap
            best_ctx["score"] = score
            leaves, treedef = jax.tree_util.tree_flatten(state)
            best_ctx["full"] = jax.tree_util.tree_unflatten(
                treedef, jax.device_get(leaves)
            )
            best_ctx["tag"] = (phase32, polish_ctx["k_sub"])
            best_ctx["snap"] = {
                f: getattr(best_ctx["full"], f) for f in _SNAP_FIELDS
            }
            timers["snapshot"] += time.time() - t_snap

        if cert_ctx["mode"] == 0 and k > 0:
            # track the best-scored iterate (see best_ctx above); a 5%
            # improvement gate bounds the device->host copies to
            # O(log(initial/final score)), and a 2 s rate limit bounds
            # their wall share (each is a blocking device->host copy of
            # the whole state) — a limit return loses at most the last 2 s of
            # improvements, and the FINAL iterate is separately compared
            # at return time
            score = max(sc["gap"], sc["feas"])
            if (
                np.isfinite(score)
                and score < 0.95 * best_ctx["score"]
                and time.time() - best_ctx["t"] >= 2.0
            ):
                take_snapshot(score)

        if opts.log_verbose and k >= log_next:
            dfeas = None
            if opts.extended_log2:
                y_log = np.asarray(state.y, np.float64)
                if equil is not None:
                    y_log = equil.E * y_log
                y_log = y_log * setup.obj_scale
                dfeas = _dual_feas_host(y_log, setup_h, setup_h.c_orig)
            _log_progress(sc, elapsed, opts, dfeas)
            log_next += opts.log_freq

        if (
            opts.checkpoint_path
            and opts.checkpoint_freq > 0
            and cert_ctx["mode"] == 0
            and k >= ckpt_next
        ):
            from .utils.checkpoint import save_checkpoint

            save_checkpoint(
                opts.checkpoint_path, state, phase32,
                square_form=layout.square_form,
            )
            ckpt_next = k + opts.checkpoint_freq

        if phase32:
            # hand over to f64 once close to tolerance, on any status, at a
            # budget boundary, or when f32 progress stalls (noise floor);
            # f64 re-judges everything from live residuals, so f32-phase
            # decisions are never final
            F = opts.hybrid_switch_factor
            metric = max(sc["gap"], sc["feas"])
            if metric < hybrid_best["value"] / 1.2:
                hybrid_best["value"] = metric
                hybrid_best["since"] = k
            # Hand over when the f32 program itself flips status (it runs
            # at the full tolerance, so st=1 means "f32 believes optimal"),
            # on a stall, or at a budget boundary.  Being NEAR tolerance
            # (metric <= F*tol) alone is NOT a reason: f32 iterations are
            # cheaper than f64 ones, so an early hand-over at 10x tol moves
            # the remaining descent onto the slower program — it only pays
            # when f32 has ALSO stopped improving (its noise floor), judged
            # on a quarter-length stall window.
            near = (
                sc["gap"] <= F * opts.tol_gap
                and sc["feas"] <= F * opts.tol_feasibility
            )
            no_improve = k - hybrid_best["since"]
            switch = (
                st != 0
                or (near and no_improve >= max(
                    stall_window // 4, 2 * opts.convergence_check
                ))
                or no_improve >= stall_window
                or k >= budget.max_iter
                or elapsed >= budget.time_limit
            )
            if switch:
                stalled = (
                    (k - hybrid_best["since"]) >= stall_window and st == 0
                )
                blew_up = not (
                    np.isfinite(sc["comb"])
                    and np.isfinite(sc["prim_obj"])
                    and np.isfinite(sc["dual_obj"])
                )
                if opts.log_verbose:
                    print(f"  [hybrid] f32 -> f64 at iter {k} "
                          f"(st={st}, stalled={stalled}, nan={blew_up})")
                fb_ctx["f32"] = sc["proj_fallbacks"]
                if blew_up:
                    # f32 phase diverged to NaN/Inf: restart clean in f64
                    # rather than polluting the f64 phase with NaN state
                    fresh = init_state(layout, opts, setup, warm=warm)
                    fresh = jax.tree_util.tree_map(jnp.asarray, fresh)
                    state = fresh._replace(iter=state.iter)
                    phase32 = False
                    continue
                state = _cast_state(state, jnp.float64)
                chunk_meas["skip_next"] = True
                chunk_meas["per_iter"] = None  # f64 rate differs from f32
                chunk = min(chunk, chunk0_cons)
                _set_rate_key(prog_opts)
                # f64 polish program: persistent-subspace projection sized
                # from the rank the f32 phase observed (bucketed to bound
                # the number of compiled variants).  Above full_eig_max_side
                # the rejection fallback is not the dense eigh (O(side^3)
                # per rejected iteration in f64) but the f32-compute polar
                # reseed (inexactness ~1e-5 relative; the gap/feasibility
                # decisions stay f64 on the iterate).
                entered_polish = False
                if (
                    opts.polish_subspace
                    and opts.subspace_rank == 0
                    and layout.sdp_sides
                ):
                    k_sub, r_obs, specs = _estimate_subspace(
                        state, layout, opts, c_host=setup.c
                    )
                    if k_sub:
                        opts_polish = opts.replace(
                            subspace_rank=k_sub, **polish_fb
                        )
                        run_chunk, _, fetch = _cached_runner(
                            layout, opts_polish
                        )
                        chunk_meas["skip_next"] = True
                        chunk_meas["per_iter"] = None
                        chunk = min(chunk, chunk0_cons)
                        prog_opts = opts_polish
                        _set_rate_key(prog_opts)
                        state = _seed_subspace_warm(
                            state, specs, k_sub, jnp.float64
                        )
                        entered_polish = True
                        polish_ctx["k_sub"] = k_sub
                        if opts.log_verbose:
                            print(
                                f"  [hybrid] f64 polish: subspace rank "
                                f"{k_sub} (observed {r_obs})"
                            )
                if (
                    not entered_polish
                    and layout.sdp_sides
                    and opts.subspace_rank == 0
                    and np.asarray(state.warm[0]).ndim == 2
                ):
                    # the f32 race ran in subspace mode but the f64 program
                    # will not: collapse each warm basis to its dominant
                    # column (the Lanczos start vector shape)
                    state = state._replace(
                        warm=tuple(
                            jnp.asarray(np.asarray(w)[:, 0], jnp.float64)
                            if np.asarray(w).ndim == 2
                            else w
                            for w in state.warm
                        )
                    )
                if stalled:
                    # the f32 phase wedged its adaptive step machinery
                    # (beta blow-up): restart steps at the f64 hand-over,
                    # keeping the iterates (standard PDHG restart)
                    f64 = jnp.float64
                    state = state._replace(
                        primal_step=jnp.asarray(tau0, f64),
                        primal_step_old=jnp.asarray(tau0, f64),
                        dual_step=jnp.asarray(tau0, f64),
                        theta=jnp.asarray(opts.initial_theta, f64),
                        beta=jnp.asarray(opts.initial_beta, f64),
                        adapt_level=jnp.asarray(opts.initial_adapt_level, f64),
                        ada_count=jnp.asarray(0, jnp.int32),
                    )
                phase32 = False
            elif (
                opts.race_subspace
                and not sub32["entered"]
                and sub32["tries"] < 5
                and opts.subspace_rank == 0
                and layout.sdp_sides
                and k >= sub32["retry_at"]
            ):
                # f32 race phase: once past the eigh cold start, size a
                # subspace program from the observed rank and seed it with
                # the exact top-k basis (eigh dominates the f32 iteration
                # cost; the subspace step is all-matmul)
                sub32["tries"] += 1
                k_sub, r_obs, specs = _estimate_subspace(
                    state, layout, opts, c_host=setup.c
                )
                if not k_sub:
                    # observed rank still too large for subspace mode —
                    # retry later (the rank shrinks as the iterate
                    # approaches the low-rank solution; a one-shot gate
                    # here would be chunk-size dependent)
                    sub32["retry_at"] = k + max(
                        opts.race_subspace_warmup, opts.convergence_check
                    )
                else:
                    sub32["entered"] = True
                    run_chunk32, _, fetch32 = _cached_runner(
                        layout, opts32.replace(subspace_rank=k_sub)
                    )
                    state = _seed_subspace_warm(
                        state, specs, k_sub, jnp.float32
                    )
                    if opts.log_verbose:
                        print(
                            f"  [hybrid] f32 race: subspace rank {k_sub} "
                            f"(observed {r_obs})"
                        )
            continue

        in_cert = cert_ctx["mode"] != 0

        # ----- guarded-restart rollback: a step restart can destabilize
        # the iterate outright (truss6: restart at gap 4.7e-3 exploded
        # feasibility to 8e3 within one chunk and triggered a spurious
        # INFEASIBLE declaration).  The watchdog snapshots the state
        # before each restart; if the next chunk shows the metric blown
        # up >= 5x (or a 5/6 declaration), roll back and suppress further
        # restarts.  Damage is bounded to one chunk.
        g = polish_ctx.get("guard")
        if g is not None and not phase32 and not in_cert:
            g_state, g_metric, g_k, g_tag = g
            if k > g_k:
                polish_ctx["guard"] = None
                metric_now = max(sc["gap"], sc["feas"])
                if g_tag == (phase32, polish_ctx["k_sub"]) and (
                    not np.isfinite(metric_now)
                    or metric_now > 5 * max(g_metric, 1e-12)
                    or st in (5, 6)
                ):
                    state = jax.tree_util.tree_map(jnp.asarray, g_state)
                    state = state._replace(
                        iter=jnp.asarray(k, jnp.int32),
                        status=jnp.asarray(0, jnp.int32),
                        infeas_block_until=jnp.asarray(
                            k + stall_window, jnp.int32
                        ),
                    )
                    polish_ctx["window_mult"] = 16
                    polish_ctx["since"] = k
                    polish_ctx["best"] = g_metric
                    if opts.log_verbose:
                        print(
                            f"  [polish] restart hurt (metric "
                            f"{g_metric:.2e} -> {metric_now:.2e}): "
                            "rolled back, restarts suppressed"
                        )
                    continue

        # ----- f64 polish watchdog (see polish_ctx)
        if (
            not phase32
            and not in_cert
            and st == 0
            and sc["gap"] > opts.tol_gap
        ):
            metric = max(sc["gap"], sc["feas"])
            if polish_ctx["since"] is None:
                polish_ctx["since"] = k
            if metric < polish_ctx["best"] / 1.2:
                polish_ctx["best"] = metric
                polish_ctx["since"] = k
                polish_ctx["window_mult"] = 1
            if opts.polish_restart and (
                k - polish_ctx["since"]
            ) >= stall_window * polish_ctx["window_mult"]:
                polish_ctx["since"] = k
                polish_ctx["best"] = metric
                polish_ctx["window_mult"] = min(
                    2 * polish_ctx["window_mult"], 16
                )
                # step-machinery restart (keep iterates): a hand-over from
                # a declared f32 point inherits adaptive steps tuned for a
                # converged regime, which can creep for 10k+ iterations
                # (standard PDHG restart; same reset as the stalled-
                # hand-over branch above).  beta is NOT reset: the adaptive
                # balance controller learned it from the residual history,
                # and discarding it on every restart re-kicks the iterate.
                # The steps are re-split around sqrt(beta) so the learned
                # balance is kept WITHOUT breaking the PDHG stability
                # product tau_p * tau_d * ||M||^2 <= 1 (PDLP's primal
                # weight): tau_p = tau0/sqrt(beta), tau_d = tau0*sqrt(beta).
                polish_ctx["guard"] = (
                    jax.tree_util.tree_map(np.asarray, state),
                    metric,
                    k,
                    (phase32, polish_ctx["k_sub"]),
                )
                f64 = jnp.float64
                sq = float(jnp.sqrt(state.beta))
                state = state._replace(
                    primal_step=jnp.asarray(tau0 / sq, f64),
                    primal_step_old=jnp.asarray(tau0 / sq, f64),
                    dual_step=jnp.asarray(tau0 * sq, f64),
                    theta=jnp.asarray(opts.initial_theta, f64),
                    adapt_level=jnp.asarray(opts.initial_adapt_level, f64),
                    ada_count=jnp.asarray(0, jnp.int32),
                )
                if opts.log_verbose:
                    print(
                        f"  [polish] stall at gap {sc['gap']:.2e}: "
                        f"step restart"
                    )
                k_new, r_obs, specs = (
                    _estimate_subspace(state, layout, opts, c_host=setup.c)
                    if layout.sdp_sides
                    else (0, 0, [])
                )
                k_cur = polish_ctx["k_sub"]
                if k_cur and k_new > k_cur:
                    run_chunk, _, fetch = _cached_runner(
                        layout, opts.replace(subspace_rank=k_new, **polish_fb)
                    )
                    chunk_meas["skip_next"] = True
                    chunk_meas["per_iter"] = None
                    chunk = min(chunk, chunk0_cons)
                    prog_opts = opts.replace(
                        subspace_rank=k_new, **polish_fb
                    )
                    _set_rate_key(prog_opts)
                    state = _seed_subspace_warm(
                        state, specs, k_new, jnp.float64
                    )
                    polish_ctx["k_sub"] = k_new
                    if opts.log_verbose:
                        print(
                            f"  [polish] stall at gap {sc['gap']:.2e}: "
                            f"subspace rank {k_cur} -> {k_new} "
                            f"(pre-projection rank {r_obs})"
                        )
                elif k_cur and k_new == 0 and not big_side:
                    # rank too large for any bucket: dense-eigh program
                    # (big sides stay on the current subspace program
                    # instead: a dense f64 eigh every iteration above
                    # full_eig_max_side would dominate the solve)
                    run_chunk, _, fetch = _cached_runner(layout, opts)
                    chunk_meas["skip_next"] = True
                    chunk_meas["per_iter"] = None
                    chunk = min(chunk, chunk0_cons)
                    prog_opts = opts
                    _set_rate_key(prog_opts)
                    state = state._replace(
                        warm=tuple(
                            jnp.asarray(np.asarray(w)[:, 0], jnp.float64)
                            if np.asarray(w).ndim == 2
                            else w
                            for w in state.warm
                        )
                    )
                    polish_ctx["k_sub"] = 0
                    if opts.log_verbose:
                        print(
                            f"  [polish] stall at gap {sc['gap']:.2e}: "
                            f"subspace rank {k_cur} -> dense eigh "
                            f"(pre-projection rank {r_obs})"
                        )

        # ----- certificate-search monitoring (reference pdhg.jl:184-244)
        if in_cert and (k >= int(state.cert_wait_until) or st == 7):
            done, found, fail = _check_certificate(
                sc, state, setup_h, opts, cert_ctx["mode"], st
            )
            if not done and (
                k >= cert_ctx.get("deadline_k", np.inf)
                or time.time() >= cert_ctx.get("deadline_t", np.inf)
            ):
                # per-search deadline crossed with no ray: fail the search
                # (see _set_cert_deadlines) so the solve resumes instead of
                # hunting until the global budget dies
                done, found, fail = True, False, "search deadline"
                if opts.log_verbose:
                    print("  [cert] search deadline crossed, no ray")
            # st == 1 here means the MODIFIED problem converged (c=0 for an
            # infeasibility search): a feasible point of the original
            # constraints was found, so the INFEASIBLE declaration was
            # wrong — treat it like a failed search (reference returns
            # "[Failed to find certificate - type 2]", pdhg.jl keeps 5/6).
            if done or st == 1:
                if (
                    not found
                    and cert_ctx.get("resume_state") is not None
                    and cert_ctx["entries"] < _MAX_CERT_SEARCHES
                    and k < budget.max_iter
                    and elapsed < budget.time_limit
                ):
                    # unproven declaration: the ray search came up empty
                    # with budget remaining, so RESUME the original solve
                    # from the pre-certificate iterate instead of returning
                    # an unsubstantiated INFEASIBLE/UNBOUNDED (the
                    # reference breaks out here; control-family instances
                    # show the stall heuristic misfiring on hard-but-
                    # feasible problems).  The stall-based detection is
                    # suppressed for a window so it cannot immediately
                    # re-fire.
                    # resume from the BEST tracked iterate when its
                    # program matches the current one — the declaration-
                    # time state is often already degenerate (truss6:
                    # exploded iterate declares, search fails, resuming
                    # the same explosion re-declares in a cycle) while
                    # the best point may be orders of magnitude closer
                    rs = cert_ctx["resume_state"]
                    if (
                        best_ctx["full"] is not None
                        and best_ctx["tag"]
                        == (phase32, polish_ctx["k_sub"])
                    ):
                        rs = best_ctx["full"]
                    state = jax.tree_util.tree_map(jnp.asarray, rs)
                    state = state._replace(
                        iter=jnp.asarray(k, jnp.int32),
                        status=jnp.asarray(0, jnp.int32),
                        cert_kind=jnp.asarray(0, jnp.int32),
                        infeas_block_until=jnp.asarray(
                            k + 2 * stall_window, jnp.int32
                        ),
                    )
                    # fresh watchdog view at the resumed point (otherwise
                    # the stale all-time best fires a restart immediately)
                    polish_ctx["since"] = k
                    polish_ctx["best"] = best_ctx["score"]
                    polish_ctx["window_mult"] = 2
                    operands = make_operands(dtype)
                    cert_ctx = {
                        "snapshot": None,
                        "mode": 0,
                        "found": False,
                        "fail_reason": "",
                        "resume_state": None,
                        "entries": cert_ctx["entries"],
                    }
                    chunk_meas["skip_next"] = True
                    chunk = min(chunk, chunk0_cons)
                    if opts.log_verbose:
                        print(
                            "  [cert] no ray found: resuming the solve "
                            f"(detection suppressed until iter "
                            f"{k + 2 * stall_window})"
                        )
                    continue
                cert_ctx["found"] = found
                if found:
                    final_status = cert_ctx["mode"]
                    status_string = STATUS_STRINGS[final_status] + (
                        " [Dual ray found]" if final_status == 6
                        else " [Primal ray found]"
                    )
                else:
                    final_status, status_string = _unproven_status(
                        budget, k, cert_ctx["mode"]
                    )
                break

        # ----- normal termination
        if st == 1 and not in_cert:
            # check_dual_feas: optimality additionally requires dual
            # feasibility below tol (reference pdhg.jl:248-249 gates the
            # convergence branch on it).  The device declares; the host
            # verifies and vetoes — chunk-granular version of the
            # reference's every-check_dual_feas_freq evaluation.
            if opts.check_dual_feas:
                y_now = np.asarray(state.y, np.float64)
                if equil is not None:
                    y_now = equil.E * y_now
                y_now = y_now * setup_h.obj_scale
                dfeas = _dual_feas_host(y_now, setup_h, setup_h.c_orig)
                if dfeas >= opts.tol_feasibility_dual:
                    # veto + suppress re-declaration for a window so chunks
                    # keep amortizing (reference evaluates dual_feas every
                    # check_dual_feas_freq iterations, pdhg.jl:248-249)
                    state = state._replace(
                        status=jnp.asarray(0, jnp.int32),
                        opt_block_until=jnp.asarray(
                            k + max(opts.check_dual_feas_freq, 1), jnp.int32
                        ),
                    )
                    continue
            final_status = 1
            break

        if st in (5, 6) and not in_cert:
            if opts.certificate_search:
                if cert_ctx["entries"] >= _MAX_CERT_SEARCHES:
                    # search budget exhausted across resumes: declaration
                    # remains unproven — demote (see _unproven_status)
                    final_status, status_string = _unproven_status(
                        budget, k, st
                    )
                    cert_ctx["mode"] = 0  # result from the CURRENT iterate
                    break
                # force-capture the declaration-time iterate so the
                # demoted-certificate return path's "best_ctx is at least
                # as good as the declaration snapshot" invariant survives
                # the snapshot rate limit
                score_now = max(sc["gap"], sc["feas"])
                if np.isfinite(score_now) and score_now < best_ctx["score"]:
                    take_snapshot(score_now)
                cert_ctx["snapshot"] = _cache_solution(
                    state, setup_h, opts, t0, status=st, dev_layout=layout, exact_project=big_side,
                    status_string=_declare_string(st, sc), equil=equil,
                )
                cert_ctx["resume_state"] = jax.tree_util.tree_map(
                    np.asarray, state
                )
                operands, state, budget = _enter_certificate_mode(
                    st, operands, state, budget, opts, setup, dtype
                )
                cert_ctx["mode"] = st
                cert_ctx["entries"] += 1
                _set_cert_deadlines(cert_ctx, state, opts, k)
                continue
            final_status = st
            status_string = _declare_string(st, sc)
            break

        # ----- iteration / time limits (reference pdhg.jl:335-382)
        if st == 0 and (k >= budget.max_iter or elapsed >= budget.time_limit):
            if in_cert:
                # certificate-search budget ran out without a ray: the
                # declaration is unproven — demote (see _unproven_status)
                final_status, status_string = _unproven_status(
                    budget, k, cert_ctx["mode"]
                )
                break
            lim_status, lim_string = _limit_status(sc, state, opts, budget, k, elapsed)
            if (
                lim_status in (5, 6)
                and opts.certificate_search
                and not in_cert
                and cert_ctx["entries"] < _MAX_CERT_SEARCHES
            ):
                # force-capture the declaration-time iterate so the
                # demoted-certificate return path's "best_ctx is at least
                # as good as the declaration snapshot" invariant survives
                # the snapshot rate limit
                score_now = max(sc["gap"], sc["feas"])
                if np.isfinite(score_now) and score_now < best_ctx["score"]:
                    take_snapshot(score_now)
                cert_ctx["snapshot"] = _cache_solution(
                    state, setup_h, opts, t0, status=lim_status,
                    status_string=lim_string, equil=equil,
                    dev_layout=layout, exact_project=big_side,
                )
                cert_ctx["resume_state"] = jax.tree_util.tree_map(
                    np.asarray, state
                )
                operands, state, budget = _enter_certificate_mode(
                    lim_status, operands, state, budget, opts, setup, dtype
                )
                cert_ctx["mode"] = lim_status
                cert_ctx["entries"] += 1
                _set_cert_deadlines(cert_ctx, state, opts, k)
                continue
            if lim_status in (5, 6):
                # uncertifiable (searches exhausted or disabled-by-cap):
                # never return an unproven INFEASIBLE/UNBOUNDED
                if opts.certificate_search:
                    final_status, status_string = _unproven_status(
                        budget, k, lim_status
                    )
                    break
            final_status = lim_status
            status_string = lim_string
            if opts.warn_on_limit and lim_status in (2, 3):
                # reference pdhg.jl:369-376
                print("    WARNING: "
                      + ("Iteration" if lim_status == 3 else "Time")
                      + " limit hit.")
            break

        if in_cert and (k >= budget.hard_cap or elapsed >= budget.time_limit):
            final_status, status_string = _unproven_status(
                budget, k, cert_ctx["mode"]
            )
            break

        if k >= budget.hard_cap:
            if cert_ctx["mode"] != 0:
                # budget exhausted with a standing uncertified declaration:
                # demote it (see _unproven_status)
                final_status, status_string = _unproven_status(
                    budget, k, cert_ctx["mode"]
                )
            else:
                final_status = 3
                status_string = f"Iteration limit of {budget.max_iter} was hit"
            break

    # ----- build result (reference pdhg.jl:486-529, cache_solution :745-787)
    if cert_ctx["mode"] != 0:
        assert cert_ctx["snapshot"] is not None
        if cert_ctx["found"]:
            res = _cache_solution(
                state, setup_h, opts, t0,
                status=final_status,
                status_string=status_string,
                zero_c=(final_status == 6),
                certificate_found=True,
                equil=equil,
                dev_layout=layout, exact_project=big_side,
            )
        else:
            # no ray: demoted limit status (never an unproven
            # INFEASIBLE/UNBOUNDED).  The declaration-time snapshot was
            # score-tracked at its own chunk boundary, so best_ctx is at
            # least as good — return it when available.
            if best_ctx["snap"] is not None:
                res = _cache_solution(
                    state._replace(**best_ctx["snap"]), setup_h, opts, t0,
                    status=final_status,
                    status_string=status_string
                    or cert_ctx["snapshot"].status_string,
                    equil=equil,
                    dev_layout=layout, exact_project=big_side,
                )
                res.iter = k  # report total iterations run, not the
                # snapshot's position (the buffers were indexed by it)
            else:
                res = cert_ctx["snapshot"]
                res.status = final_status
                res.status_string = status_string or res.status_string
                res.time = time.time() - t0
    else:
        # at a limit status, return the best-scored iterate seen rather
        # than the last one when the trajectory regressed past it
        total_k = int(state.iter)
        if final_status in (2, 3, 4) and best_ctx["snap"] is not None:
            cur = max(sc["gap"], sc["feas"])
            if not np.isfinite(cur) or best_ctx["score"] < cur:
                state = state._replace(**best_ctx["snap"])
        res = _cache_solution(
            state, setup_h, opts, t0, status=final_status,
            status_string=status_string or STATUS_STRINGS[final_status],
            equil=equil,
            dev_layout=layout, exact_project=big_side,
        )
        res.iter = total_k  # total iterations run (the snapshot override
        # above may have rewound state.iter to index the ring buffers)

    _annotate_limit_feas(res, setup_h, opts)
    timers["finalize"] = time.time() - t0 - sum(
        v for k_, v in timers.items() if k_ != "finalize"
    )
    if trace_dir:
        jax.profiler.stop_trace()
    if opts.timer_verbose or opts.timer_file:
        report = _timer_report(
            timers, chunk_counts, res, int(np.asarray(state.proj_fallbacks)),
            fb_ctx,
        )
        if opts.timer_verbose:
            print(report)
        if opts.timer_file:
            with open("time.log", "w") as f:
                f.write(report + "\n")

    if opts.log_verbose:
        _log_final(res)
    return res


def _probe_score(res: Result, problem) -> float:
    """Progress metric of a probe sub-solve: max(rel gap, rel lin viol),
    lower is better; non-finite/degenerate results score inf."""
    if res is None or res.primal.size == 0:
        return float("inf")
    x = res.primal
    lin = 0.0
    if problem.A is not None and getattr(problem.A, "shape", (0,))[0]:
        r = np.abs(np.asarray(problem.A @ x).ravel() - problem.b)
        lin = max(lin, float(r.max()) / (1.0 + float(np.abs(problem.b).max(initial=0.0))))
    if problem.G is not None and getattr(problem.G, "shape", (0,))[0]:
        r = np.maximum(np.asarray(problem.G @ x).ravel() - problem.h, 0.0)
        lin = max(lin, float(r.max()) / (1.0 + float(np.abs(problem.h).max(initial=0.0))))
    gap = abs(res.gap) if np.isfinite(res.gap) else float("inf")
    score = max(gap, lin)
    return score if np.isfinite(score) else float("inf")


def _solve_with_beq_probe(problem, opts: Options, t0: float) -> Result:
    """block_equilibration="auto": race both preconditioners briefly,
    then finish with the winner, warm-started from its probe iterate.

    Both probe arms and the final solve share the SAME compiled chunk
    program (identical geometry; the preconditioner only changes operand
    VALUES), so the probe costs iterations, not compiles.  Measured
    motivation: at the same row-norm spread (1.96e4) block equilibration
    rescues SDPLIB arch0 but regresses arch2 — only running both tells
    them apart.  Probe budget: block_equilibration_probe_iters each plus
    a small slice of the time limit; the final solve's time limit is
    reduced by the wall time the probes consumed."""
    margin = max(opts.block_equilibration_probe_margin, 1.0)
    probe_t = max(min(0.05 * opts.time_limit, 20.0), 2.0)
    base = dict(
        certificate_search=False,
        log_verbose=False,
        timer_verbose=False,
        warn_on_limit=False,
        checkpoint_path="",
    )
    # adaptive depth: the arms of a hard instance can track each other
    # for 10k+ iterations before separating (truss6: indistinguishable at
    # 6k, the equilibrated arm clearly ahead by ~50k).  While the scores
    # are within the margin of each other, double the probe and continue
    # each arm from its own iterate, until a winner emerges, an arm
    # solves, or the probe has consumed ~25% of the time budget.
    arms: dict = {False: None, True: None}
    scores = {False: float("inf"), True: float("inf")}
    depth = int(opts.block_equilibration_probe_iters)
    for _round in range(4):
        round_t = max(min(probe_t, opts.time_limit - (time.time() - t0)), 1.0)
        for variant in (False, True):
            prev = arms[variant]
            warm = prev if prev is not None and prev.status in (2, 3) else None
            try:
                arms[variant] = solve(
                    problem,
                    opts.replace(
                        block_equilibration=variant,
                        max_iter=depth,
                        time_limit=round_t,
                        **base,
                    ),
                    warm_start=warm,
                )
            except Exception as e:  # a probe must never kill the solve
                if opts.log_verbose:
                    print(f"  [beq probe] arm {variant} failed: {e}")
                arms[variant] = None
        scores = {v: _probe_score(r, problem) for v, r in arms.items()}
        if opts.log_verbose:
            print(
                f"  [beq probe] depth {depth}: default {scores[False]:.3e} "
                f"vs block-equilibrated {scores[True]:.3e}"
            )
        solved = any(
            r is not None and r.status == 1 for r in arms.values()
        )
        separated = (
            scores[True] * margin < scores[False]
            or scores[False] * margin < scores[True]
        )
        if solved or separated:
            break
        if time.time() - t0 > 0.25 * opts.time_limit:
            break
        depth *= 2
    # An arm that actually SOLVED always wins over one that did not.
    # Otherwise: when BOTH arms are still garbage at probe depth (scores
    # far from feasibility+gap progress), the probe is UNINFORMATIVE —
    # a 2x score spread between two non-converging trajectories does not
    # predict the long-run winner (measured: control1 at depth 6000
    # scored default 0.51 vs equilibrated 1.22, but at the iteration
    # limit the equilibrated arm reaches rel_err 1.4e-2 vs 0.96).  In
    # that regime trust the trigger itself: the probe only runs because
    # the row-norm spread exceeds the threshold, i.e. the default
    # pipeline is known badly scaled — take the equilibrated arm.  The
    # margin comparison decides only when at least one arm shows real
    # progress (arch2-style regressions, where the default arm's score
    # is clearly better AND meaningful).
    opt1 = {v: arms[v] is not None and arms[v].status == 1 for v in arms}
    if opt1[True] != opt1[False]:
        winner = opt1[True]
    elif (
        min(scores.values()) > 0.3
        and arms[True] is not None
        and np.isfinite(scores[True])
    ):
        # the override must never pick an arm that crashed in the probe
        # (arms[True] None) or diverged to NaN/inf over a default arm
        # that was making slow but real progress
        winner = True
    else:
        winner = bool(scores[True] * margin < scores[False])
    wres = arms[winner]
    if opts.log_verbose:
        print(
            f"  [beq probe] -> "
            f"{'block-equilibrated' if winner else 'default'}"
        )
    t_probe = time.time() - t0
    if opts.log_verbose or opts.timer_verbose:
        # attribute the probe's cold cost explicitly (it runs both arms
        # through compiled programs BEFORE the main solve; on slow-compile
        # backends that can be the dominant pre-solve cost)
        print(
            f"  [beq probe] probe consumed {t_probe:.1f}s before the main "
            "solve (both arms share the main solve's compiled program)"
        )
    if wres is not None and wres.status == 1:
        wres.time = time.time() - t0
        return wres
    warm = None
    if wres is not None and wres.status in (2, 3) and np.isfinite(
        scores[winner]
    ):
        warm = wres
    remaining = opts.time_limit - (time.time() - t0)
    final_opts = opts.replace(
        block_equilibration=winner,
        time_limit=max(remaining, 1.0),
    )
    return solve(problem, final_opts, warm_start=warm)


def _timer_report(
    timers, chunk_counts, res, proj_fallbacks: int = -1, fb_ctx=None
) -> str:
    """Phase-timing report (reference: TimerOutputs print, MOI_wrapper.jl:317-330)."""
    total = sum(timers.values())
    lines = [
        "-" * 58,
        f"  {'phase':<12} {'time (s)':>10} {'share':>8}   chunks",
        "-" * 58,
    ]
    for name, v in timers.items():
        extra = ""
        if name == "f32 loop":
            extra = f"  {chunk_counts['f32']}"
        elif name == "f64 loop":
            extra = f"  {chunk_counts['f64']}"
        lines.append(f"  {name:<12} {v:>10.3f} {v / max(total, 1e-9):>7.1%}{extra}")
    lines.append("-" * 58)
    tail = f"  total {total:.3f}s  iters={res.iter}"
    if proj_fallbacks >= 0 and res.iter > 0:
        f32_fb = (fb_ctx or {}).get("f32", 0)
        f32_polar = (fb_ctx or {}).get("f32_is_polar", False)
        f64_fb = max(proj_fallbacks - f32_fb, 0)
        if f32_fb and f32_polar:
            # f32-race fallbacks are Newton-Schulz polar reseeds (all
            # matmuls, no eigh anywhere in that program)
            tail += (f"  proj fallbacks: f32 polar-reseed={f32_fb}, "
                     f"dense-eigh={f64_fb} "
                     f"({f64_fb / max(res.iter, 1):.1%} of iters)")
        else:
            tail += (f"  proj dense-eigh iters={proj_fallbacks}"
                     f" ({proj_fallbacks / max(res.iter, 1):.1%})")
    lines.append(tail)
    return "\n".join(lines)


def _declare_string(st, sc):
    if st == 5:
        return f"Unbounded: |Primal objective| = {sc['prim_obj']:.3e} too large"
    return f"Infeasible: detected during iteration (dual objective {sc['dual_obj']:.3e})"


def _row_norm_spread(setup) -> float:
    """max/min nonzero row 2-norm of M = [A; G] (block_equilibration
    "auto" gate).  Cheap host-side pass over the sparse data."""
    import scipy.sparse as sp

    from .ops.linop import stack_vertical

    M = sp.csr_matrix(stack_vertical(setup.A, setup.G))
    if M.shape[0] == 0:
        return 1.0
    rn = np.sqrt(np.asarray(M.multiply(M).sum(axis=1)).ravel())
    rn = rn[rn > 0]
    if rn.size == 0:
        return 1.0
    return float(rn.max() / rn.min())


# Maximum certificate searches per solve.  The reference enters a search
# at most once (pdhg.jl gates on !p.certificate_search); we additionally
# RESUME the solve after a failed search (an unproven declaration on a
# hard-but-feasible problem should not end it), so without a cap a
# declare->search->fail->resume->redeclare cycle could extend budgets
# forever.  Three searches bound the overhead at roughly one extra solve.
_MAX_CERT_SEARCHES = 3


def _unproven_status(budget: _Budget, k: int, mode: int):
    """Demote an uncertified INFEASIBLE/UNBOUNDED declaration to a limit
    status.

    Documented deviation from the reference: pdhg.jl keeps stop_reason 5/6
    with a "[Failed to find certificate]" annotation when the ray search
    comes up empty (pdhg.jl:228-244,508-521).  On hard-but-feasible
    problems (SDPLIB control*/truss*) the stall heuristics misfire and that
    behavior reports a feasible problem as INFEASIBLE.  A declaration
    without a Farkas ray is a suspicion, not a proof — so once every
    search budget is exhausted we return the cached best solution under
    TIME_LIMIT/ITERATION_LIMIT with the suspicion recorded in the status
    string.  Certified declarations (ray found) are unaffected."""
    lim = 3 if k >= budget.max_iter else 2
    suspected = "infeasible" if mode == 6 else "unbounded"
    return lim, (
        STATUS_STRINGS[lim]
        + f" [Suspected {suspected}: no certificate found]"
    )


def _limit_status(sc, state, opts: Options, budget: _Budget, k: int, elapsed: float):
    """Limit-time infeasibility heuristics (reference pdhg.jl:335-378)."""
    buf_gap = np.asarray(state.buf_gap)
    stable_gap = float(np.max(np.abs(buf_gap - np.roll(buf_gap, 1))))
    if (
        k > opts.min_iter_time_infeas
        and stable_gap < opts.infeas_stable_gap_tol
        and sc["gap"] > opts.infeas_limit_gap_tol
    ):
        if sc["feas"] <= opts.tol_feasibility / 100:
            return 5, "Problem declared unbounded due to lack of improvement"
        if sc["feas"] > opts.infeas_feasibility_tol:
            return 6, "Problem declared infeasible due to lack of improvement"
    if k >= budget.max_iter:
        return 3, f"Iteration limit of {budget.max_iter} was hit"
    return 2, f"Time limit hit, limit: {budget.time_limit} time: {elapsed}"


def _enter_certificate_mode(st, operands, state, budget, opts, setup, dtype):
    """Zero out c (infeasible) or b,h (unbounded) and extend budgets
    (reference certificate_infeasibility / certificate_dual_infeasibility,
    pdhg.jl:639-676).  Same shapes -> the compiled loop is reused."""
    if st == 6:
        operands = operands._replace(c=jnp.zeros_like(operands.c))
        # a blowup-declared infeasibility enters with an enormous dual
        # iterate; rays are directions, so renormalize the dual side to
        # keep the search finite (the pre-search state is snapshotted by
        # the caller, nothing is lost)
        scale = max(1.0, float(np.abs(np.asarray(state.y)).max()))
        if scale > 1e3:
            inv = jnp.asarray(1.0 / scale, state.y.dtype)
            state = state._replace(
                y=state.y * inv, y_old=state.y_old * inv,
                Mty=state.Mty * inv, Mty_old=state.Mty_old * inv,
                avg_y=state.avg_y * inv, avg_Mty=state.avg_Mty * inv,
            )
    else:
        operands = operands._replace(
            b=jnp.zeros_like(operands.b), h=jnp.zeros_like(operands.h)
        )
        # same for the primal side on unboundedness declarations
        scale = max(1.0, float(np.abs(np.asarray(state.x)).max()))
        if scale > 1e3:
            inv = jnp.asarray(1.0 / scale, state.x.dtype)
            state = state._replace(
                x=state.x * inv, x_old=state.x_old * inv,
                Mx=state.Mx * inv, Mx_old=state.Mx_old * inv,
                avg_x=state.avg_x * inv, avg_Mx=state.avg_Mx * inv,
            )
    k = int(state.iter)
    wait = k + 2 * opts.convergence_window + k // 5 + 1000
    state = state._replace(
        cert_kind=jnp.asarray(st, jnp.int32),
        cert_wait_until=jnp.asarray(wait, jnp.int32),
        status=jnp.asarray(0, jnp.int32),
    )
    budget.time_limit *= 1.1
    # reference grants +10% iterations (pdhg.jl:674), but when the
    # declaration happens AT the iteration limit that extension can be
    # smaller than the monitoring wait above — the ray check would never
    # run and a certifiable infeasibility would be demoted to a limit
    # status.  Guarantee the search at least reaches its window plus a
    # margin to converge onto the ray.
    budget.max_iter = max(
        budget.max_iter + budget.max_iter // 10,
        wait + 2 * opts.convergence_window + 2000,
    )
    budget.hard_cap = max(budget.hard_cap, budget.max_iter + k)
    return operands, state, budget


def _set_cert_deadlines(cert_ctx, state, opts: Options, k: int):
    """Bound ONE certificate search in iterations and wall time.

    The reference grants a search ~10% extra budget (pdhg.jl:670-676);
    without a per-search bound our search runs until the global limits,
    and on a hard-but-feasible problem (SDPLIB truss6) the ray hunt
    consumed half the total wall time before being demoted.  A search
    gets twice its monitoring warm-up window in iterations and 10% of
    the user time limit, whichever ends later matters per-dimension —
    crossing EITHER deadline fails the search (and the failed-search
    path resumes the real solve)."""
    wait = int(state.cert_wait_until)
    cert_ctx["deadline_k"] = k + 2 * max(wait - k, 1)
    span_t = 0.1 * opts.time_limit if np.isfinite(opts.time_limit) else 60.0
    cert_ctx["deadline_t"] = time.time() + max(min(span_t, 600.0), 5.0)


def _check_certificate(sc, state, setup, opts: Options, mode: int, st: int = 0):
    """Host-side ray checks (reference pdhg.jl:184-244).

    Returns (done, found, fail_string)."""
    if mode == 5 and st == 7:
        # on-device per-iteration primal-ray detection fired (the iterate
        # was still finite at the moment the scale-invariant check held)
        return True, True, ""
    # Farkas rays are directions: the iterate grows without bound along
    # the ray, so feasibility-of-the-certificate must be checked on the
    # NORMALIZED candidate (violation per unit of certificate strength).
    # The reference checks absolutely (pdhg.jl:191-194), which only
    # certifies when the ray happens to pass near magnitude ~1; on LPs the
    # dual blows up to 1e2-1e3 before the window opens and the absolute
    # check can never fire again.
    if mode == 6:
        if sc["dual_obj"] > opts.certificate_obj_tol:
            y = np.asarray(state.y, np.float64) * setup.obj_scale
            y_hat = y / max(sc["dual_obj"], 1.0)
            dfeas = _dual_feas_host(y_hat, setup, 0.0 * setup.c_orig)
            if dfeas < opts.tol_feasibility_dual:
                return True, True, ""
    else:  # mode == 5 (unbounded): look for a primal ray
        if sc["prim_obj"] < -opts.certificate_obj_tol and (
            sc["feas"] / max(abs(sc["prim_obj"]), 1.0) < opts.tol_feasibility
        ):
            return True, True, ""
    ft = opts.certificate_fail_tol
    if (
        sc["prim_obj"] < -ft and sc["dual_obj"] < -ft and sc["feas"] < -ft
    ) or np.isnan(sc["comb"]):
        return True, False, "failed"
    return False, False, ""


def _annotate_limit_feas(res: Result, setup, opts: Options) -> Result:
    """Flag constraint-violating "best iterates" in the status string.

    At a limit/demoted status (2/3/4) the returned point is the
    best-scored iterate the trajectory passed through, but on hard
    instances that can still violate the linear constraints by O(1)
    (observed: SDPLIB truss8 lin_viol 6.8 under "Time limit hit").  The
    reference returns its cached solution at limits (pdhg.jl:335-382);
    unlike it, we tell the user when that point is not a near-solution:
    user-unit relative linear violation > 10x tol_feasibility appends
    "(infeasible iterate, lin_viol=...)" so the row cannot be mistaken
    for a near-feasible answer.
    """
    if res.status not in (2, 3, 4) or res.primal.size == 0:
        return res
    viol = 0.0
    if res.slack_eq.size:
        viol = float(np.abs(res.slack_eq).max()) / (
            1.0 + float(np.abs(setup.b_orig).max(initial=0.0))
        )
    if res.slack_in.size:
        viol = max(
            viol,
            float(np.maximum(res.slack_in, 0.0).max())
            / (1.0 + float(np.abs(setup.h_orig).max(initial=0.0))),
        )
    if viol > 10 * opts.tol_feasibility and (
        "(infeasible iterate" not in res.status_string
    ):
        res.status_string += f" (infeasible iterate, lin_viol={viol:.1e})"
    return res


def _cache_solution(
    state: State,
    setup: SetupProblem,
    opts: Options,
    t0: float,
    status: int,
    status_string: str | None = None,
    zero_c: bool = False,
    certificate_found: bool = False,
    equil=None,
    dev_layout: ConeLayout | None = None,
    exact_project: bool = False,
) -> Result:
    """Unscale, recover duals/slacks, build Result (pdhg.jl:745-787).

    ``setup`` is the TRI-space SetupProblem (host recovery data);
    ``dev_layout`` the device layout — when square_form, the iterate is
    converted back to scaled-tri coordinates with the embed isometry's
    transpose before the reference's unscale chain runs.
    """
    layout = setup.layout
    # ONE batched device->host transfer for every field read below,
    # instead of one blocking np.asarray / float(buf[i]) read per field
    (x_d, y_d, buf_prim_obj, buf_dual_obj, buf_gap, buf_pres, buf_dres,
     buf_feas, cur_rank, k) = jax.device_get([
        state.x, state.y, state.buf_prim_obj, state.buf_dual_obj,
        state.buf_gap, state.buf_pres, state.buf_dres, state.buf_feas,
        state.current_rank, state.iter,
    ])
    k = int(k)
    L = buf_gap.shape[0]
    i = (k - 1) % L

    x = np.asarray(x_d, np.float64)
    y = np.asarray(y_d, np.float64)
    if dev_layout is not None and dev_layout.square_form:
        from .problem import square_embed_matrix

        x = square_embed_matrix(layout).T @ x
    x = _fix_diag_scaling(x, layout, np.sqrt(2.0))
    if equil is not None:  # undo E M D preconditioning (pdhg.jl:752-755)
        x = equil.D * x
        y = equil.E * y
    # undo the data normalization: the device solved the (c/sc, b/sr,
    # h/sr) problem, whose primal is 1/sr of the user's and whose dual is
    # 1/sc of the user's
    x = x * setup.rhs_scale
    y = y * setup.obj_scale

    if exact_project and layout.sdp_sides:
        # Large-side solves run inexact device projections (polar
        # fallbacks above side 384 — deliberate ~1e-5-relative budget),
        # which leaves the RETURNED X with eigenvalues slightly below 0
        # (measured: -7.4e-3 on maxG32 at side 2000 — above the
        # reference's own PSD-ness acceptance bar of -1e-4,
        # moi_sdplib.jl:53-56).  One exact host eigh per block restores
        # machine-exact cone membership; the induced feasibility drift is
        # the same magnitude as the clamped mass and is reflected in the
        # recomputed slacks below.
        from .utils.vech import tri_ij as _tij

        for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
            if side == 1:
                x[off] = max(x[off], 0.0)
                continue
            tl = sympackedlen(side)
            iu, ju = _tij(side)
            Xm = np.zeros((side, side))
            Xm[iu, ju] = x[off : off + tl]
            Xm[ju, iu] = x[off : off + tl]
            w, V = np.linalg.eigh(Xm)
            if w[0] < -1e-12:
                Xp = (V * np.maximum(w, 0.0)) @ V.T
                x[off : off + tl] = Xp[iu, ju]

    c_used = (0.0 * setup.c_orig) if zero_c else setup.c_orig

    slack_eq = np.asarray(setup.A_orig @ x).ravel() - setup.b_orig
    slack_in = np.asarray(setup.G_orig @ x).ravel() - setup.h_orig

    p_ = layout.p
    dual_eq = y[:p_]
    dual_in = y[p_:]
    dual_cone = c_used + _TA(setup.A_orig, dual_eq, layout.n) + _TA(
        setup.G_orig, dual_in, layout.n
    )
    dual_cone = _fix_diag_scaling(dual_cone, layout, 2.0)

    ineq_viol = -min(0.0, dual_in.min()) if dual_in.size else 0.0
    cone_viol = _cone_feas(dual_cone, layout)
    tail = dual_cone[layout.cone_dim :]
    zero_viol = np.abs(tail).max() if tail.size else 0.0
    dual_feasibility = max(cone_viol, ineq_viol, zero_viol)

    vo = setup.var_ordering
    sense_mul = -1.0 if setup.objective_sense == "max" else 1.0
    # buf_prim_obj / buf_dual_obj are already user-unit (the residual
    # kernel multiplies by obj_scale)
    objval = float(buf_prim_obj[i])
    dual_objval = float(buf_dual_obj[i])
    gap_out = float(buf_gap[i])
    if exact_project and layout.sdp_sides and not zero_c:
        # the final exact projection may have moved x — report the
        # objective OF THE RETURNED POINT (x is fully user-scaled here,
        # same units as the buffered value), and keep the reported gap
        # consistent with objval - dual_objval (residuals.jl:22-28 form)
        objval = float(np.dot(setup.c_orig, x))
        gap_out = abs(objval - dual_objval) / max(abs(objval), 1.0)

    return Result(
        status=status,
        status_string=status_string or STATUS_STRINGS[status],
        primal=x[vo],
        dual_cone=dual_cone[vo],
        dual_eq=dual_eq,
        dual_in=dual_in,
        slack_eq=slack_eq,
        slack_in=slack_in,
        # the PPA residuals, matching the reference's Residuals semantics
        # (residuals.jl:46-55); equality/inequality feasibility are exposed
        # separately via slacks and primal_feasible_user_tol
        primal_residual=float(buf_pres[i]),
        dual_residual=float(buf_dres[i]),
        objval=sense_mul * objval + setup.objective_constant,
        dual_objval=sense_mul * dual_objval + setup.objective_constant,
        gap=gap_out,
        time=time.time() - t0,
        iter=k,
        final_rank=int(np.sum(cur_rank)),
        primal_feasible_user_tol=float(buf_feas[i]) <= opts.tol_feasibility,
        dual_feasible_user_tol=dual_feasibility <= opts.tol_feasibility_dual,
        certificate_found=certificate_found,
        result_count=1,
    )


def _print_header(layout: ConeLayout, opts: Options):
    """Banner + problem/parameter summary (reference printing.jl:1-95)."""
    import jax as _jax

    bar = "=" * 74
    print(bar)
    print("  proxsdp_tpu — JAX PDHG conic solver"
          f"  [backend: {_jax.default_backend()}]")
    print(bar)
    print(f"  variables      : {layout.n} "
          f"(free: {layout.n_free})")
    print(f"  equalities     : {layout.p}    inequalities: {layout.m}")
    if layout.sdp_sides:
        sides = ", ".join(str(s) for s in layout.sdp_sides)
        print(f"  PSD blocks     : {len(layout.sdp_sides)} (sides: {sides})")
    if layout.soc_lens:
        lens = ", ".join(str(s) for s in layout.soc_lens)
        print(f"  SOC blocks     : {len(layout.soc_lens)} (lens: {lens})")
    print(f"  tol_gap={opts.tol_gap:.1e}  tol_feas={opts.tol_feasibility:.1e}  "
          f"tol_psd={opts.tol_psd:.1e}  dtype={opts.dtype}"
          + ("+hybrid" if opts.hybrid_precision and opts.dtype == "float64" else ""))
    print(bar)


def _progress_columns(opts: Options) -> str:
    """Column header for the progress table (reference printing.jl:69-93)."""
    cols = ("    iter        prim obj   rel. gap    feasb.  prim res  "
            "dual res  rank   time(s)")
    if opts.extended_log or opts.extended_log2:
        cols += "    dual obj"
    if opts.extended_log2:
        cols += "   d feasb."
    return cols


def _log_progress(sc, elapsed, opts: Options, dfeas=None):
    """One progress-table row (reference print_progress, printing.jl:96-150).

    extended_log adds the dual objective column; extended_log2 additionally
    adds a dual-feasibility column (computed host-side at each log, like the
    reference's per-log dual_feas evaluation, pdhg.jl:167 + printing.jl:138).
    """
    if opts.log_repeat_header:
        print(_progress_columns(opts))
    row = (
        f"  iter={sc['iter']:>8d}  obj={sc['prim_obj']:+.6e}  "
        f"gap={sc['gap']:.2e}  feas={sc['feas']:.2e}  "
        f"pres={sc['pres']:.2e}  dres={sc['dres']:.2e}  "
        f"rank={sc['sum_target_rank']}  t={elapsed:.1f}s"
    )
    if opts.extended_log or opts.extended_log2:
        row += f"  dobj={sc['dual_obj']:+.6e}"
    if opts.extended_log2:
        row += f"  dfeas={float('nan') if dfeas is None else dfeas:.2e}"
    print(row)


def _log_final(res: Result):
    print("-" * 74)
    print(f"  status: {res.status_string}")
    print(
        f"  obj={res.objval:+.6e}  dual={res.dual_objval:+.6e}  "
        f"gap={res.gap:.2e}  iters={res.iter}  rank={res.final_rank}  "
        f"time={res.time:.2f}s"
    )
    print("-" * 74)
