"""Cone projections (PSD / SOC / box) as pure jittable functions.

Reference behavior being reproduced:
* box projection of the dual onto {b} x (-inf, h]  — src/prox_operators.jl:160-170
* SOC projection                                   — src/prox_operators.jl:138-158
* PSD projection with positive-eigenpair
  reconstruction and rank accounting               — src/prox_operators.jl:33-126

Everything is branch-free (jnp.where / lax.cond) with static shapes.  Each
PSD block reports (projected block, min_eig, current_rank) exactly like the
reference's Params bookkeeping so the adaptive-rank controller can run
on-device.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .tri import square_to_tri, tri_to_square
from . import lanczos as _lz


def box_projection(v, b, h, step, p: int, m: int):
    """Projection used inside the dual step (Moreau decomposition).

    Equality rows are pinned to b; inequality rows are min(v/step, h)
    (reference src/prox_operators.jl:160-170 — note the reference divides
    only the inequality part by step; the equality projection is constant).
    """
    parts = []
    if p:
        parts.append(b)
    if m:
        parts.append(jnp.minimum(v[p:] / step, h))
    if not parts:
        return jnp.zeros_like(v)
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def soc_projection_block(block):
    """Project one SOC block [s, v...] onto ||v|| <= s.

    Branch-free version of reference src/prox_operators.jl:145-158.
    """
    s, v = block[0], block[1:]
    nv = jnp.sqrt(jnp.sum(v * v))
    # three cases: nv <= -s -> 0 ; nv <= s -> identity ; else scale
    scale = 0.5 * (1.0 + s / jnp.where(nv == 0, 1.0, nv))
    in_cone = nv <= s
    in_polar = nv <= -s
    new_s = jnp.where(in_polar, 0.0, jnp.where(in_cone, s, scale * nv))
    new_v = jnp.where(in_polar, 0.0, jnp.where(in_cone, 1.0, scale)) * v
    return jnp.concatenate([new_s[None], new_v])


POLAR_QA, POLAR_QB, POLAR_QC = 3.4445, -4.7750, 2.0315


def polar_psd(X, side: int, *, aggressive: int, polish: int, dtype=None):
    """PSD projection via a Newton-Schulz matrix-sign iteration.

    proj_PSD(X) = (X + sign(X) X) / 2.  sign(X) is built with a FIXED
    schedule of matmul-only polynomial steps: `aggressive` quintic steps
    (Muon/Polar-Express coefficients — small-eigenvalue growth factor
    ~3.44/step) then `polish` cubic Newton-Schulz steps (quadratic
    convergence to +-1).  Unlike an eigh, whose latency can depend on the
    spectrum, this costs a fixed ~(3*aggressive + 2*polish + 1) matmuls.

    Eigenvalues below ~delta * ||X||_F are projected inexactly (error
    <= |lambda|); with the default schedule (7, 4) delta ~= 9e-5, which
    is the design point of the f32 race phase (the reference's own
    thesis is inexact projections with controlled error,
    arXiv:1810.05231; the f64 phase re-projects exactly).

    Returns (Xp, rank_estimate) where rank = trace((I + sign)/2).
    """
    ct = dtype or X.dtype
    Xc = X.astype(ct)
    s = jnp.sqrt(jnp.sum(Xc * Xc)) + jnp.asarray(1e-30, ct)
    Y = Xc / s
    for _ in range(aggressive):
        A = Y @ Y
        B = POLAR_QB * A + POLAR_QC * (A @ A)
        Y = POLAR_QA * Y + Y @ B
    for _ in range(polish):
        A = Y @ Y
        Y = 1.5 * Y - 0.5 * (Y @ A)
    S = 0.5 * (Y + Y.T)
    P = 0.5 * (Xc + S @ Xc)
    Xp = 0.5 * (P + P.T)
    rank = 0.5 * (side + jnp.trace(S))
    # sanitize: the iteration is contractive for ||Y0||_2 <= 1 (guaranteed
    # by Frobenius scaling), but f32 edge cases are cheap to guard against;
    # a bad step passes X through unprojected (same NaN-guard policy as the
    # batch subspace mode) and the solver's divergence watchdog owns it
    bad = ~jnp.all(jnp.isfinite(Xp))
    Xp = jnp.where(bad, Xc, Xp)
    return (
        Xp.astype(X.dtype),
        jnp.where(bad, side, jnp.clip(jnp.round(rank), 0, side)).astype(
            jnp.int32
        ),
    )


class PsdProjResult(NamedTuple):
    block: jax.Array  # projected packed triangle
    min_eig: jax.Array  # smallest eigenvalue "seen" (reference semantics)
    current_rank: jax.Array  # int32 rank used
    warm: jax.Array  # warm-start vector for the next iteration's Lanczos
    used_full: jax.Array  # bool: dense eigh ran (gated or fallback/reseed)
    # subspace-mode diagnostics (zeros outside subspace mode):
    # [rnmax/scale, min_theta, npos] — fetched by the host with the other
    # chunk scalars to explain acceptance/rejection
    sub_stats: jax.Array  # block dtype, (3,)


def psd_projection_block(
    v_block,
    side: int,
    target_rank,
    warm,
    *,
    opt,
    allow_lanczos: bool,
    accept_tol=None,
    force_full=None,
):
    """Project one packed PSD block onto the PSD cone.

    Gating (reference src/prox_operators.jl:43-60):
      side == 1                 -> max(0, x)
      lanczos eligible & target_rank <= max_target -> low-rank Lanczos,
                                   falling back to eigh if not converged
      otherwise                 -> full eigh keeping positive eigenpairs

    min_eig semantics follow the reference: full path reports 0.0
    (prox_operators.jl:114), Lanczos path reports the smallest computed Ritz
    value (prox_operators.jl:95).

    Matmul precision is set by the caller's jit boundary
    (ops/precision.full_f32), as in the solver's chunk programs.
    """
    dtype = v_block.dtype
    if side == 1:
        val = v_block[0]
        proj = jnp.maximum(val, 0.0)
        return PsdProjResult(
            block=proj[None],
            min_eig=proj,
            current_rank=(proj > 0).astype(jnp.int32),
            warm=warm,
            used_full=jnp.asarray(False),
            sub_stats=jnp.zeros((3,), dtype),
        )

    # square-form layout (ConeLayout.square_form): the block IS the dense
    # matrix — a free reshape replaces the tri<->square gathers.  The
    # symmetrize guards against rounding drift; iterates are symmetric by
    # construction (c/Mty are symmetric embeds, projections return
    # symmetric matrices).
    square_in = v_block.shape[0] == side * side

    def pack(Xp):
        return Xp.reshape(-1) if square_in else square_to_tri(Xp, side)

    if square_in:
        X = v_block.reshape(side, side)
        X = 0.5 * (X + X.T)
    else:
        X = tri_to_square(v_block, side)

    if opt.tp_shards > 0:
        # tensor-parallel: row-shard the dense block over the mesh's tp
        # axis; GSPMD propagates the layout through Lanczos/eigh and the
        # rank-k reconstruction, inserting psum collectives for the inner
        # products (parallel/sharded.py)
        from ..parallel.sharded import current_tp_mesh

        ctx = current_tp_mesh()
        if ctx is not None:
            mesh, axis = ctx
            X = jax.lax.with_sharding_constraint(
                X,
                jax.sharding.NamedSharding(
                    mesh, jax.sharding.PartitionSpec(axis, None)
                ),
            )

    # mixed projection: f32 programs compute the eigendecomposition in
    # f64 when available (see Options.mixed_projection rationale)
    eig_dtype = dtype
    if (
        opt.mixed_projection
        and dtype == jnp.float32
        and jax.config.jax_enable_x64
    ):
        eig_dtype = jnp.float64

    def full_path(X):
        w, V = jnp.linalg.eigh(X.astype(eig_dtype))  # ascending
        pos = jnp.maximum(w, 0.0)
        Xp = ((V * pos[None, :]) @ V.T).astype(dtype)
        cur = jnp.sum(w > opt.tol_psd).astype(jnp.int32)
        return Xp, jnp.asarray(0.0, dtype), cur, V[:, -1].astype(dtype)

    # ---- persistent-subspace Rayleigh-Ritz projection (no reference
    # counterpart).  One subspace-iteration step per PDHG iteration on a
    # warm (side, k) basis: all matmuls instead of the O(side^3)
    # serialized eigh.  Residual-checked: any untrusted Ritz pair falls back
    # to dense eigh, which also reseeds the basis with the true top-k
    # eigenvectors (so at most one slow iteration after any subspace loss).
    k_sub = int(min(opt.subspace_rank, side))
    if k_sub > 0 and k_sub < side // 2 and warm.ndim == 2:

        def full_path_sub(X):
            w, V = jnp.linalg.eigh(X.astype(eig_dtype))  # ascending
            pos = jnp.maximum(w, 0.0)
            Xp = ((V * pos[None, :]) @ V.T).astype(dtype)
            cur = jnp.sum(w > opt.tol_psd).astype(jnp.int32)
            me = jnp.asarray(0.0, dtype)
            Vk = V[:, -k_sub:][:, ::-1].astype(dtype)  # top-k, descending
            return Xp, me, cur, Vk

        # mixed-precision basis: in f64 programs, build the orthonormal
        # basis with f32 matmuls; Ritz values / residuals / reconstruction
        # stay f64.  Whether this pays where f64 is native is not yet
        # measured on the H100.
        # Rayleigh quotients are 2nd-order accurate in basis error, and
        # the f64 acceptance residual sees the f32 basis error, so a bad
        # basis is rejected like any other — semantics unchanged.
        mixed = bool(opt.subspace_mixed) and dtype == jnp.float64
        bdt = jnp.float32 if mixed else dtype

        def _cholqr2(Y):
            # CholeskyQR2: tall-skinny orthonormalization via two
            # Gram+Cholesky passes — matmul work only (no Householder
            # serialization on device)
            def one(Yc):
                G = Yc.T @ Yc
                # jitter keyed off the COMPUTE dtype: an f32 Gram+Cholesky
                # needs ~1e-6-relative regularization (f32 eps is 1.2e-7;
                # 1e-12 underflows the pivot and the factor goes NaN —
                # measured: the f32 race subspace rejected 100% of its
                # iterations through round 3 because of exactly this)
                jit_eps = jnp.asarray(
                    1e-6 if bdt == jnp.float32 else 1e-12, bdt
                ) * (jnp.trace(G) / k_sub + 1.0)
                R = jnp.linalg.cholesky(G + jit_eps * jnp.eye(k_sub, dtype=bdt))
                Q = jax.scipy.linalg.solve_triangular(
                    R, Yc.T, lower=True
                ).T
                return Q

            return one(one(Y))

        def polar_reseed(X):
            # matmul-only fallback (race programs): compute the FULL
            # Newton-Schulz polar projection of X — exact to NS
            # accuracy (~1e-5 * ||X||_F) independent of the subspace
            # rank, exactly the role the dense-eigh fallback plays —
            # and refresh the warm basis from the sign projector's
            # range: sign(X) maps the positive eigenspace to
            # eigenvalue 1, so ONE application of P+ = (I+S)/2 to the
            # old basis converges the subspace (unit spectral gap).
            # The last column is steered into the NEGATIVE space so
            # the covers test (min theta <= tol_psd) can hold next
            # iteration.  No eigh anywhere — a fixed
            # ~(3*aggressive+2*polish+5) matmuls.
            Xb32 = X.astype(bdt)
            sF = jnp.sqrt(jnp.sum(Xb32 * Xb32)) + jnp.asarray(1e-30, bdt)
            Y = Xb32 / sF
            for _ in range(opt.polar_aggressive):
                A2 = Y @ Y
                Bq = POLAR_QB * A2 + POLAR_QC * (A2 @ A2)
                Y = POLAR_QA * Y + Y @ Bq
            for _ in range(opt.polar_polish):
                A2 = Y @ Y
                Y = 1.5 * Y - 0.5 * (Y @ A2)
            Sgn = 0.5 * (Y + Y.T)
            Pp = 0.5 * (Xb32 + Sgn @ Xb32)  # full polar projection
            Xp2_b = 0.5 * (Pp + Pp.T)
            wb = warm.astype(bdt)
            Zp = 0.5 * (wb + Sgn @ wb)  # P+ @ warm
            zn = 0.5 * (wb[:, -1] - Sgn @ wb[:, -1])  # P- @ last
            Z = jnp.concatenate([Zp[:, :-1], zn[:, None]], axis=1)
            # rank-deficient Z columns are rescued by _cholqr2's
            # trace-scaled jitter
            Qn = _cholqr2(Z)
            rank2 = 0.5 * (side + jnp.trace(Sgn))
            Xp2 = Xp2_b.astype(dtype)
            bad2 = ~jnp.all(jnp.isfinite(Xp2))
            Xp2 = jnp.where(bad2, X, Xp2)
            # full-path bookkeeping semantics (prox_operators.jl:114)
            me2 = jnp.asarray(0.0, dtype)
            cur2 = jnp.where(
                bad2, side, jnp.clip(jnp.round(rank2), 0, side)
            ).astype(jnp.int32)
            wv2 = jnp.where(bad2, warm, Qn.astype(dtype))
            # 4-tuple like full_path_sub; the cond wrapper appends
            # used_full=True ("a fallback/reseed ran this iteration")
            return Xp2, me2, cur2, wv2


        use_sign = (
            bool(getattr(opt, "subspace_sign", True))
            and not mixed
            and dtype == jnp.float32
            and not getattr(opt, "subspace_accept_always", False)
        )

        def subspace_path(X):
            # needs full-f32 products (the jit boundary's policy): a
            # reduced-precision pass floors the Ritz residual at ~2e-3 and
            # the acceptance test then rejects every iteration
            if use_sign:
                return _subspace_body_sign(X)
            return _subspace_body(X)

        def _subspace_body_sign(X):
            """Matmul-only subspace projection step (no eigh anywhere).

            Replaces the k x k Rayleigh-Ritz eigh(B) with a Newton-Schulz
            matrix-sign of B (k x k matmuls only): the in-span
            projection is (B + sign(B)B)/2, the positive-rank count is
            trace((I+sign)/2), and acceptance uses the aggregate
            positive-subspace residual ||(XQ - QB) P+||_F instead of
            per-Ritz-pair residuals (same relative-inexactness budget).
            """
            Q = _cholqr2(X @ warm)
            Z = X @ Q
            B = Q.T @ Z
            B = 0.5 * (B + B.T)
            sF = jnp.sqrt(jnp.sum(B * B)) + jnp.asarray(1e-30, bdt)
            Y = B / sF
            for _ in range(opt.polar_aggressive):
                A2 = Y @ Y
                Y = POLAR_QA * Y + Y @ (POLAR_QB * A2 + POLAR_QC * (A2 @ A2))
            for _ in range(opt.polar_polish):
                Y = 1.5 * Y - 0.5 * (Y @ (Y @ Y))
            S = 0.5 * (Y + Y.T)
            npos_f = 0.5 * (k_sub + jnp.trace(S))
            Pp = 0.5 * (jnp.eye(k_sub, dtype=bdt) + S)
            # aggregate residual of the positive in-span subspace
            R = (Z - Q @ B) @ Pp
            rfro = jnp.sqrt(jnp.sum(R * R))
            scale = jnp.maximum(sF, 1.0)
            thresh = jnp.asarray(opt.subspace_tol, dtype)
            if accept_tol is not None:
                thresh = jnp.maximum(thresh, accept_tol.astype(dtype))
            ok_resid = rfro <= thresh * scale
            # a non-positive direction must be present inside the basis
            # (same role as min(theta) <= tol_psd in the eigh body)
            covers = (k_sub - npos_f) >= 0.5
            # Newton-Schulz sign(B) is least accurate exactly at the PSD
            # boundary (eigenvalues of B near 0), where the in-span
            # residual test cannot see the error; require the sign itself
            # to have converged (||S^2 - I||_F small — each unconverged
            # eigendirection contributes O(1)) so a poorly-converged sign
            # falls back like any rejected subspace.
            sign_err = jnp.sqrt(
                jnp.sum((S @ S - jnp.eye(k_sub, dtype=bdt)) ** 2)
            )
            sign_ok = sign_err <= 0.05 * jnp.sqrt(
                jnp.asarray(k_sub, bdt)
            )
            conv_ok = ok_resid & covers & sign_ok
            if force_full is not None:
                conv_ok = conv_ok & ~force_full
            stats = jnp.stack(
                [
                    (rfro / scale).astype(dtype),
                    (npos_f - k_sub).astype(dtype),  # -(negative count)
                    npos_f.astype(dtype),
                ]
            )

            def reconstruct(_):
                Bp = 0.5 * (B + S @ B)
                Bp = 0.5 * (Bp + Bp.T)
                Xp = Q @ (Bp @ Q.T)
                bad = ~jnp.all(jnp.isfinite(Xp))
                Xp = jnp.where(bad, X, Xp)
                # full-path min_eig semantics (prox_operators.jl:114);
                # covers already guarantees a non-positive direction, so
                # the adaptive-rank controller stays quiescent exactly as
                # with min(theta) <= tol_psd
                me = jnp.asarray(0.0, dtype)
                cur = jnp.clip(
                    jnp.round(npos_f), 0, k_sub
                ).astype(jnp.int32)
                wv = jnp.where(bad, warm, Q)
                return Xp, me, cur, wv, bad

            fb = (
                polar_reseed
                if getattr(opt, "subspace_fallback", "eigh") == "polar"
                else full_path_sub
            )
            out = jax.lax.cond(
                conv_ok,
                reconstruct,
                lambda _: fb(X) + (jnp.asarray(True),),
                operand=None,
            )
            return out + (stats,)

        def _subspace_body(X):
            Xb = X.astype(bdt)
            Q = _cholqr2(Xb @ warm.astype(bdt))
            Zb = Xb @ Q
            B = Q.T @ Zb
            B = 0.5 * (B + B.T)
            if mixed:
                # f64 Rayleigh-Ritz on the f32-built span: the f32 basis is
                # orthonormal only to ~1e-7, which put a ~2e-6 relative
                # error into the reconstruction.  Re-orthonormalize it in
                # f64 (Cholesky of the k x k Gram) before the k x k eigh;
                # all of it is k-wide work next to the one (side, k) matmul.
                Qd = Q.astype(dtype)
                XQ = X @ Qd  # the one f64 (side,k) matmul
                Lg = jnp.linalg.cholesky(Qd.T @ Qd)
                Qo = jax.scipy.linalg.solve_triangular(
                    Lg, Qd.T, lower=True
                ).T
                XQo = jax.scipy.linalg.solve_triangular(
                    Lg, XQ.T, lower=True
                ).T
                B64 = Qo.T @ XQo
                theta, U = jnp.linalg.eigh(0.5 * (B64 + B64.T))
                W = Qo @ U  # Ritz vectors, f64-orthonormal
                XW = XQo @ U
            else:
                theta, U = jnp.linalg.eigh(B)  # ascending, k x k (cheap)
                W = Q @ U  # Ritz vectors
                XW = Zb @ U
            rn = jnp.sqrt(jnp.sum((XW - W * theta[None, :]) ** 2, axis=0))
            pos = theta > 0.0
            scale = jnp.maximum(jnp.max(jnp.abs(theta)), 1.0)
            # acceptance: a one-step Ritz residual is proportional to the
            # per-iteration drift of X, so a fixed tight tolerance would
            # reject every step.  The principled rule (the reference's own
            # thesis — approximate projections with controlled error,
            # arXiv:1810.05231) is RELATIVE inexactness: accept error
            # proportional to the current PPA residual (accept_tol, traced)
            # so projection error decays in lockstep with outer progress.
            thresh = jnp.asarray(
                max(opt.subspace_tol, opt.subspace_mixed_tol)
                if mixed
                else opt.subspace_tol,
                dtype,
            )
            if accept_tol is not None:
                thresh = jnp.maximum(thresh, accept_tol.astype(dtype))
            ok_resid = jnp.all(jnp.where(pos, rn <= thresh * scale, True))
            stats = jnp.stack(
                [
                    (jnp.max(jnp.where(pos, rn, 0.0)) / scale).astype(dtype),
                    jnp.min(theta).astype(dtype),
                    jnp.sum(pos).astype(dtype),
                ]
            )
            # the basis must also exhibit a non-positive direction, i.e.
            # the positive eigenspace fits strictly inside the subspace
            covers = jnp.min(theta) <= opt.tol_psd
            conv_ok = ok_resid & covers
            if force_full is not None:
                # periodic forced dense reseed: a positive eigendirection
                # orthogonal to the warm basis is invisible to the Ritz
                # residual test, so the accepted-subspace path could stall
                # forever; every subspace_reseed_freq iterations the dense
                # eigh re-derives the true top-k basis (the reference's
                # full_eig_freq/full_eig_len play the same role for its
                # Lanczos engine, prox_operators.jl:49)
                conv_ok = conv_ok & ~force_full

            def reconstruct(_):
                lam = jnp.maximum(theta, 0.0)
                Xp = (W * lam[None, :]) @ W.T
                me = jnp.min(theta).astype(dtype)
                cur = jnp.sum(theta > opt.tol_psd).astype(jnp.int32)
                # new warm basis: Ritz vectors, dominant first
                return Xp, me, cur, W[:, ::-1], jnp.asarray(False)

            fallback_fn = (
                polar_reseed
                if getattr(opt, "subspace_fallback", "eigh") == "polar"
                else full_path_sub
            )

            if getattr(opt, "subspace_accept_always", False):
                # batch/vmap mode: no dense-eigh fallback inside the
                # program (under vmap lax.cond becomes select and would
                # run the eigh for every instance every iteration — the
                # very thing this mode exists to avoid).
                # The reconstruction is applied unconditionally with a
                # NaN guard; the worst relative residual rides sub_stats
                # so the HOST can reseed stale bases between chunks.
                Xp, me, cur, wv, uf = reconstruct(None)
                bad = ~jnp.all(jnp.isfinite(Xp))
                Xp = jnp.where(bad, X, Xp)
                wv = jnp.where(bad, warm, wv)
                return (Xp, me, cur, wv, uf | bad) + (stats,)
            out = jax.lax.cond(
                conv_ok,
                reconstruct,
                lambda _: fallback_fn(X) + (jnp.asarray(True),),
                operand=None,
            )
            return out + (stats,)

        Xp, me, cur, wv, uf, stats = subspace_path(X)
        return PsdProjResult(pack(Xp), me, cur, wv, uf, stats)

    # matmul-only polar projection (see polar_psd): deterministic latency,
    # no data-dependent eigh in the loop.  Engaged by the hybrid driver
    # for the f32 race phase (projection="polar"); inexact below
    # ~1e-4 * ||X||_F, which the f64 phase re-projects exactly.
    if (
        getattr(opt, "projection", "auto") == "polar"
        and side >= opt.polar_min_side
    ):
        Xp, rank = polar_psd(
            X, side, aggressive=opt.polar_aggressive, polish=opt.polar_polish
        )
        return PsdProjResult(
            block=pack(Xp),
            min_eig=jnp.asarray(0.0, dtype),  # full-path semantics
            current_rank=rank,
            warm=warm,
            used_full=jnp.asarray(False),
            sub_stats=jnp.zeros((3,), dtype),
        )

    use_lz = (
        allow_lanczos
        and not opt.full_eig_decomp
        and side > opt.min_size_krylov_eigs
        and side > opt.full_eig_max_side
        and opt.use_lanczos
    )
    if not use_lz:
        Xp, me, cur, wv = full_path(X)
        return PsdProjResult(
            pack(Xp), me, cur, wv, jnp.asarray(True),
            jnp.zeros((3,), dtype),
        )

    # giant sides: a dense eigh inside the jitted iteration costs O(side^3)
    # per call and dominates the step once target_rank outgrows
    # max_target_rank_krylov_eigs — above full_eig_max_side the
    # rejection/overflow fallback stays matmul-only (polar), like the
    # f64-polish rule (solver.py polish_fb).  More Lanczos steps are
    # cheap (two (ncv,n)@(n,)
    # matmuls per step), so scale ncv with side to keep the top-k
    # converging at 5000-dim spectra instead of punting to the fallback.
    giant = side > opt.full_eig_max_side
    ncv = min(
        max(
            2 * opt.max_target_rank_krylov_eigs + 1,
            opt.eigsolver_min_lanczos,
            side // 32 if giant else 0,
        ),
        side,
    )

    def polar_fallback(X):
        Xp, rank = polar_psd(
            X, side, aggressive=opt.polar_aggressive, polish=opt.polar_polish
        )
        return Xp, jnp.asarray(0.0, dtype), rank, warm

    def lanczos_path(X):
        out = _lz.lanczos_topk(X, warm, ncv=ncv, tol=opt.krylovkit_tol)
        # Ritz pairs sorted descending in out.vals / out.vecs columns
        k_mask = jnp.arange(ncv) < target_rank
        conv_ok = jnp.all(jnp.where(k_mask, out.resid <= jnp.maximum(
            opt.krylovkit_tol * jnp.abs(out.vals), 10 * opt.krylovkit_tol), True))

        def reconstruct(_):
            pos_mask = k_mask & (out.vals > 0.0)
            lam = jnp.where(pos_mask, out.vals, 0.0)
            W = out.vecs * jnp.sqrt(lam)[None, :]
            Xp = W @ W.T
            # min over the target_rank leading Ritz values
            me = jnp.min(jnp.where(k_mask, out.vals, jnp.inf))
            cur = jnp.sum(pos_mask).astype(jnp.int32)
            return Xp, me.astype(dtype), cur, out.vecs[:, 0], jnp.asarray(False)

        def fallback(_):
            if giant:
                return polar_fallback(X) + (jnp.asarray(True),)
            return full_path(X) + (jnp.asarray(True),)

        return jax.lax.cond(conv_ok, reconstruct, fallback, operand=None)

    # target_rank is traced: decide lanczos vs full at run time; a
    # force_full pulse (full_eig_freq/full_eig_len cadence) overrides
    pred = target_rank <= opt.max_target_rank_krylov_eigs
    if force_full is not None:
        pred = pred & ~force_full
    if giant:
        # rank outgrew the Krylov cap: polar, never a giant dense eigh
        overflow = lambda X: polar_fallback(X) + (jnp.asarray(True),)
    else:
        overflow = lambda X: full_path(X) + (jnp.asarray(True),)
    Xp, me, cur, wv, uf = jax.lax.cond(pred, lanczos_path, overflow, X)
    return PsdProjResult(
        pack(Xp), me, cur, wv, uf,
        jnp.zeros((3,), dtype),
    )


def psd_projection_small_batch(v_blocks, side: int, *, opt):
    """Batched dense-eigh projection of B same-side packed triangles.

    Multi-block parallelism (SURVEY §2.3): problems like SDPLIB's truss
    family carry 100+ PSD blocks of one small side; projecting them with a
    per-block Python loop serializes 100+ tiny eighs per iteration, while
    one vmapped (B, side, side) eigh is a single batched kernel.  Only
    valid for blocks whose gating guarantees the dense full path (side <=
    min_size_krylov_eigs and <= full_eig_max_side, subspace off) — the
    caller (solver._primal_step) checks that statically.

    Returns (blocks (B, tl), min_eig (B,), current_rank (B,) i32,
    warm (B, side)); min_eig is 0.0 per the reference's full-path
    semantics (prox_operators.jl:114).
    """
    dtype = v_blocks.dtype
    B = v_blocks.shape[0]
    if side == 1:
        proj = jnp.maximum(v_blocks, 0.0)
        val = proj[:, 0]
        return (
            proj,
            val,
            (val > 0).astype(jnp.int32),
            jnp.ones((B, 1), dtype),
        )

    eig_dtype = dtype
    if (
        opt.mixed_projection
        and dtype == jnp.float32
        and jax.config.jax_enable_x64
    ):
        eig_dtype = jnp.float64

    square_in = v_blocks.shape[1] == side * side
    if square_in:
        X = v_blocks.reshape(B, side, side)
        X = 0.5 * (X + jnp.swapaxes(X, 1, 2))
    else:
        X = jax.vmap(lambda v: tri_to_square(v, side))(v_blocks)
    w, V = jnp.linalg.eigh(X.astype(eig_dtype))  # (B, s), (B, s, s)
    pos = jnp.maximum(w, 0.0)
    Xp = jnp.einsum("bik,bk,bjk->bij", V, pos, V).astype(dtype)
    cur = jnp.sum(w > opt.tol_psd, axis=1).astype(jnp.int32)
    warm = V[:, :, -1].astype(dtype)
    if square_in:
        blocks = Xp.reshape(B, side * side)
    else:
        blocks = jax.vmap(lambda Xb: square_to_tri(Xb, side))(Xp)
    zero = jnp.zeros((B,), dtype)
    return blocks, zero, cur, warm
