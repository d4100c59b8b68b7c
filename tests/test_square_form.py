"""Square-form device layout (ConeLayout.square_form).

The packed scaled triangle is the reference's CPU-era coordinate system
(src/prox_operators.jl:1-31 rebuilds dense matrices from it every
iteration); on device the tri<->square index maps lower to gathers over
the whole PSD segment every iteration.  The
square layout folds the isometry into A/G/c once on the host
(problem.to_square_form) — these tests pin the exact-equivalence
guarantees that make that safe.
"""

from __future__ import annotations

import numpy as np
import pytest

import proxsdp_tpu as px
from proxsdp_tpu.problem import preprocess, square_embed_matrix, to_square_form
from proxsdp_tpu.solver import solve


def _maxcut_opt(**kw):
    W = np.array(
        [[18.0, -5, -7, -6], [-5, 6, 0, -1], [-7, 0, 8, -1], [-6, -1, -1, 8]]
    )
    opt = px.Optimizer(tol_gap=1e-6, tol_feasibility=1e-6, **kw)
    X = opt.add_psd_var(4)
    for i in range(4):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * W), sense="max")
    return opt


class TestEmbedIsometry:
    def test_embed_matrix_orthonormal_columns(self):
        """S'S = I on tri space: the change of coordinates is exact."""
        opt = _maxcut_opt()
        setup = preprocess(opt.build_problem())
        S = square_embed_matrix(setup.layout)
        StS = (S.T @ S).toarray()
        assert np.allclose(StS, np.eye(setup.layout.n), atol=1e-14)

    def test_round_trip_and_norms(self):
        opt = _maxcut_opt()
        setup = preprocess(opt.build_problem())
        S = square_embed_matrix(setup.layout)
        rng = np.random.RandomState(0)
        v = rng.randn(setup.layout.n)
        x_sq = S @ v
        # isometry: 2-norms and inner products preserved
        assert abs(np.linalg.norm(x_sq) - np.linalg.norm(v)) < 1e-12
        assert np.allclose(S.T @ x_sq, v, atol=1e-13)
        # the square embedding is a symmetric matrix
        side = setup.layout.sdp_sides[0]
        X = x_sq[: side * side].reshape(side, side)
        assert np.allclose(X, X.T)

    def test_operator_transform_preserves_action(self):
        """M_sq (S v) == M v — the transformed operator acts identically."""
        opt = _maxcut_opt()
        setup = preprocess(opt.build_problem())
        setup_sq = to_square_form(setup)
        S = square_embed_matrix(setup.layout)
        rng = np.random.RandomState(1)
        v = rng.randn(setup.layout.n)
        lhs = np.asarray(setup_sq.A @ (S @ v)).ravel()
        rhs = np.asarray(setup.A @ v).ravel()
        assert np.allclose(lhs, rhs, atol=1e-12)
        # objective values agree
        assert abs(setup_sq.c @ (S @ v) - setup.c @ v) < 1e-12

    def test_layout_offsets(self):
        opt = _maxcut_opt()
        setup = preprocess(opt.build_problem())
        lay_sq = to_square_form(setup).layout
        assert lay_sq.square_form
        assert lay_sq.sdp_blk_lens == (16,)
        assert lay_sq.n == setup.layout.n - 10 + 16
        assert lay_sq.n_tri == setup.layout.n


class TestSolveEquivalence:
    def test_maxcut_square_vs_tri(self):
        r_sq = _maxcut_opt().optimize()
        r_tri = _maxcut_opt(square_form=False).optimize()
        assert r_sq.status == 1 and r_tri.status == 1
        assert abs(r_sq.objval - 18.0) < 1e-3
        # the unitary equivalence keeps the trajectories in lockstep
        assert abs(r_sq.iter - r_tri.iter) <= 2
        assert abs(r_sq.objval - r_tri.objval) < 1e-4
        assert np.abs(r_sq.primal - r_tri.primal).max() < 1e-3
        assert np.abs(r_sq.dual_eq - r_tri.dual_eq).max() < 1e-3

    def test_mixed_sdp_soc_square(self):
        """PSD + SOC + square layout: the SOC/free tail is untouched."""
        opt = px.Optimizer()
        X = opt.add_psd_var(2)
        s = opt.add_soc_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
        opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
        opt.add_eq_constraint({int(s[1]): 1.0}, 2.0)
        opt.set_objective({int(X[0, 1]): 1.0, int(s[0]): 1.0}, sense="min")
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 1.0) < 2e-2

    def test_warm_start_square(self):
        opt = _maxcut_opt()
        r1 = opt.optimize()
        r2 = _maxcut_opt().optimize(warm_start=r1)
        assert r2.status == 1
        assert r2.iter <= r1.iter
        assert abs(r2.objval - 18.0) < 1e-3

    def test_sign_subspace_race(self):
        """subspace_sign=True (matmul-only f32 subspace step: Newton-
        Schulz sign(B) instead of eigh(B)) must converge to the same
        answer through the hybrid race.  Small side, so force the
        subspace on via subspace_rank and a tiny warmup."""
        opt = _maxcut_opt(
            subspace_sign=True,
            race_subspace_warmup=8,
            convergence_check=8,
            chunk_iters=16,
        )
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 1e-3

    def test_sign_subspace_matches_eigh_subspace(self):
        """Forced f32 subspace mode, sign vs eigh bodies: same optimum
        on mcp-style maxcut, comparable iteration counts."""
        import proxsdp_tpu as _px
        from proxsdp_tpu.models.maxcut import (
            maxcut_problem,
            random_graph_weights,
        )
        from proxsdp_tpu.solver import solve as _solve

        prob, _ = maxcut_problem(random_graph_weights(3, 40))
        base = _px.Options(
            dtype="float32",
            hybrid_precision=False,
            subspace_rank=12,
            subspace_fallback="polar",
            tol_gap=1e-3,
            tol_feasibility=1e-3,
            max_iter=30_000,
        )
        r_sign = _solve(prob, base.replace(subspace_sign=True))
        r_eigh = _solve(prob, base.replace(subspace_sign=False))
        assert r_sign.status == 1 and r_eigh.status == 1
        assert abs(r_sign.objval - r_eigh.objval) < 5e-2 * max(
            1.0, abs(r_eigh.objval)
        )
        assert r_sign.iter < 3 * max(r_eigh.iter, 1)

    def test_two_blocks_square(self):
        """Two PSD blocks: per-block square offsets line up."""
        opt = px.Optimizer(tol_gap=1e-6, tol_feasibility=1e-6)
        X = opt.add_psd_var(2)
        Y = opt.add_psd_var(3)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
        opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
        for i in range(3):
            opt.add_eq_constraint({int(Y[i, i]): 1.0}, 1.0)
        opt.set_objective(
            {int(X[0, 1]): 1.0, int(Y[0, 1]): 1.0, int(Y[1, 2]): 1.0},
            sense="min",
        )
        r_sq = opt.optimize()
        assert r_sq.status == 1
        # min X01 s.t. X PSD, diag 1 -> X01 = -1; same for the 3x3 pairs
        assert abs(r_sq.objval - (-3.0)) < 2e-2
