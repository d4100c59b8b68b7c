"""Oracle tests for cone projections against NumPy/SciPy references."""

import numpy as np
import pytest

from proxsdp_tpu.options import Options
from proxsdp_tpu.ops.cones import (
    box_projection,
    psd_projection_block,
    soc_projection_block,
)
from proxsdp_tpu.ops.lanczos import lanczos_topk
from proxsdp_tpu.ops.tri import square_to_tri, tri_to_square
from proxsdp_tpu.utils.vech import sympackedlen
import jax.numpy as jnp


def psd_oracle(X):
    w, V = np.linalg.eigh(X)
    return (V * np.maximum(w, 0.0)) @ V.T


class TestSOC:
    def test_interior(self):
        blk = np.array([5.0, 3.0, 0.0])
        out = np.asarray(soc_projection_block(jnp.asarray(blk)))
        assert np.allclose(out, blk)

    def test_polar(self):
        blk = np.array([-5.0, 3.0, 0.0])
        out = np.asarray(soc_projection_block(jnp.asarray(blk)))
        assert np.allclose(out, 0.0)

    def test_boundary_projection(self):
        blk = np.array([0.0, 3.0, 4.0])
        out = np.asarray(soc_projection_block(jnp.asarray(blk)))
        # projection of (0, v): s = ||v||/2, v scaled to norm ||v||/2
        assert np.isclose(out[0], 2.5)
        assert np.isclose(np.linalg.norm(out[1:]), 2.5)

    def test_zero(self):
        out = np.asarray(soc_projection_block(jnp.zeros(4)))
        assert np.allclose(out, 0.0)


class TestBox:
    def test_semantics(self, rng):
        p, m = 3, 4
        b, h = rng.randn(p), rng.randn(m)
        v = rng.randn(p + m)
        step = 0.7
        out = np.asarray(
            box_projection(jnp.asarray(v), jnp.asarray(b), jnp.asarray(h), step, p, m)
        )
        assert np.allclose(out[:p], b)
        assert np.allclose(out[p:], np.minimum(v[p:] / step, h))


class TestPSDFull:
    @pytest.mark.parametrize("side", [2, 5, 17])
    def test_matches_eigh_oracle(self, side, rng):
        opts = Options()
        S = rng.randn(side, side)
        S = (S + S.T) / 2
        v = np.asarray(square_to_tri(jnp.asarray(S), side))
        res = psd_projection_block(
            jnp.asarray(v), side, jnp.asarray(2, jnp.int32),
            jnp.ones(side), opt=opts, allow_lanczos=True,
        )
        got = np.asarray(tri_to_square(res.block, side))
        assert np.allclose(got, psd_oracle(S), atol=1e-10)
        # full path reports min_eig = 0 (reference prox_operators.jl:114)
        assert float(res.min_eig) == 0.0

    def test_side1(self):
        opts = Options()
        for val, expect in [(3.0, 3.0), (-2.0, 0.0)]:
            res = psd_projection_block(
                jnp.asarray([val]), 1, jnp.asarray(1, jnp.int32),
                jnp.ones(1), opt=opts, allow_lanczos=True,
            )
            assert np.isclose(float(res.block[0]), expect)


class TestSubspace:
    """Persistent-subspace Rayleigh-Ritz projection (no reference counterpart)."""

    def _project(self, S, side, k, warm):
        opts = Options(subspace_rank=k)
        v = np.asarray(square_to_tri(jnp.asarray(S), side))
        return psd_projection_block(
            jnp.asarray(v), side, jnp.asarray(2, jnp.int32),
            jnp.asarray(warm), opt=opts, allow_lanczos=True,
        )

    def test_cold_start_falls_back_to_oracle(self, rng):
        side, k = 40, 8
        S = rng.randn(side, side)
        S = (S + S.T) / 2
        Q, _ = np.linalg.qr(rng.randn(side, k))
        res = self._project(S, side, k, Q)
        got = np.asarray(tri_to_square(res.block, side))
        # a random basis fails the residual check -> dense-eigh fallback
        assert np.allclose(got, psd_oracle(S), atol=1e-9)
        assert res.warm.shape == (side, k)

    def test_warm_basis_projects_exactly(self, rng):
        # rank-3 PSD + tiny negative tail: the exact invariant basis must
        # pass the residual check and reproduce the oracle via matmuls only
        side, r, k = 40, 3, 8
        U, _ = np.linalg.qr(rng.randn(side, side))
        w = np.zeros(side)
        w[:r] = [5.0, 3.0, 1.0]
        w[r:] = -np.linspace(0.5, 2.0, side - r)
        S = (U * w) @ U.T
        warm = U[:, : k]  # exact invariant subspace incl. guard direction
        res = self._project(S, side, k, warm)
        got = np.asarray(tri_to_square(res.block, side))
        assert np.allclose(got, psd_oracle(S), atol=1e-8)
        assert int(res.current_rank) == r
        assert float(res.min_eig) < 0.0  # covers check saw a neg direction

    def test_warm_iteration_tracks_slow_drift(self, rng):
        """Repeated projection of a slowly drifting matrix keeps passing
        the subspace check (the PDHG steady-state regime)."""
        side, r, k = 30, 2, 8
        U, _ = np.linalg.qr(rng.randn(side, side))
        w = np.concatenate([[4.0, 2.0], -np.ones(side - r)])
        S = (U * w) @ U.T
        warm = np.linalg.qr(rng.randn(side, k))[0]
        res = self._project(S, side, k, warm)  # cold: falls back, reseeds
        for step in range(5):
            P = rng.randn(side, side) * 1e-3
            S = S + (P + P.T) / 2
            res = self._project(S, side, k, np.asarray(res.warm))
            got = np.asarray(tri_to_square(res.block, side))
            assert np.allclose(got, psd_oracle(S), atol=1e-6)

    def test_solver_forced_subspace_matches_default(self):
        import proxsdp_tpu as px
        from proxsdp_tpu.models.maxcut import (
            maxcut_problem,
            random_graph_weights,
        )
        from proxsdp_tpu.solver import solve

        prob, _ = maxcut_problem(random_graph_weights(0, 30))
        r_ref = solve(prob, px.Options(hybrid_precision=False))
        r_sub = solve(
            prob, px.Options(hybrid_precision=False, subspace_rank=8)
        )
        assert r_sub.status == 1
        # relative-inexactness acceptance means a different (but equally
        # converged) trajectory; the two runs stop at different corners of
        # the RELATIVE tolerance box, whose feasibility slack (1e-4 of
        # 1+||b||) permits an objective shift of ~|c|*dx — measured ~1.5e-3
        # relative here, with the subspace run the closer to a tight-
        # tolerance truth solve.  Compare at the contract level, not 1e-4.
        rel = abs(r_sub.objval - r_ref.objval) / (
            1.0 + abs(r_sub.objval) + abs(r_ref.objval)
        )
        assert rel < 5e-3, (r_sub.objval, r_ref.objval)
        # with relative acceptance disabled AND the mixed (f32-basis)
        # projection off, the paths must agree exactly
        r_exact = solve(
            prob,
            px.Options(
                hybrid_precision=False, subspace_rank=8,
                subspace_rel_accept=0.0, subspace_mixed=False,
            ),
        )
        assert abs(r_exact.objval - r_ref.objval) < 1e-6
        # mixed mode admits f32-class projection error by design; the
        # result must still be converged at solver tolerance
        r_mixed = solve(
            prob,
            px.Options(
                hybrid_precision=False, subspace_rank=8,
                subspace_rel_accept=0.0,
            ),
        )
        assert r_mixed.status == 1
        assert abs(r_mixed.objval - r_ref.objval) < 1e-3 * (
            1.0 + abs(r_ref.objval)
        )


class TestLanczos:
    @pytest.mark.parametrize("n,k", [(50, 3), (120, 5)])
    def test_topk_eigenpairs_gapped(self, n, k, rng):
        """Spectrum with clear gaps: ncv=25 single-pass Lanczos nails it."""
        spec = np.concatenate([[30.0, 20.0, 12.0, 8.0, 5.0][:k],
                               rng.rand(n - k)])
        Q = np.linalg.qr(rng.randn(n, n))[0]
        A = (Q * spec[None, :]) @ Q.T
        A = (A + A.T) / 2
        out = lanczos_topk(jnp.asarray(A), jnp.asarray(rng.randn(n)), ncv=25)
        w = np.linalg.eigvalsh(A)[::-1]
        vals = np.asarray(out.vals)
        assert np.allclose(vals[:k], w[:k], atol=1e-8)
        # residual bounds are small for converged pairs
        assert np.all(np.asarray(out.resid)[:k] < 1e-6)
        # Ritz vectors are orthonormal and satisfy A v = lambda v
        V = np.asarray(out.vecs)[:, :k]
        assert np.allclose(V.T @ V, np.eye(k), atol=1e-8)
        assert np.allclose(A @ V, V * vals[:k][None, :], atol=1e-6)

    def test_residual_bound_self_consistency(self, rng):
        """On a gapless random matrix the residual bound must honestly
        report the achieved accuracy (the caller uses it to gate the
        eigh fallback)."""
        n = 60
        A = rng.randn(n, n)
        A = (A + A.T) / 2
        out = lanczos_topk(jnp.asarray(A), jnp.asarray(rng.randn(n)), ncv=25)
        w = np.linalg.eigvalsh(A)[::-1]
        vals, resid = np.asarray(out.vals), np.asarray(out.resid)
        for i in range(5):
            # each Ritz value lies within its residual bound of SOME
            # exact eigenvalue (standard Lanczos a-posteriori bound)
            err = np.min(np.abs(vals[i] - w))
            assert err <= resid[i] + 1e-9, (i, err, resid[i])

    def test_lowrank_projection_path(self, rng):
        """PSD block big enough to trigger Lanczos; low-rank spectrum so the
        truncated projection equals the oracle."""
        side = 150
        opts = Options(min_size_krylov_eigs=100)
        # rank-2 positive part + small negative tail
        U = np.linalg.qr(rng.randn(side, 2))[0]
        S = U @ np.diag([5.0, 3.0]) @ U.T - 0.01 * np.eye(side)
        v = np.asarray(square_to_tri(jnp.asarray(S), side))
        res = psd_projection_block(
            jnp.asarray(v), side, jnp.asarray(2, jnp.int32),
            jnp.asarray(rng.randn(side)), opt=opts, allow_lanczos=True,
        )
        got = np.asarray(tri_to_square(res.block, side))
        assert np.allclose(got, psd_oracle(S), atol=1e-6)
        assert int(res.current_rank) == 2
        # min_eig is the smallest computed Ritz value among target_rank
        assert float(res.min_eig) < opts.tol_psd or float(res.min_eig) > 0


class TestPolar:
    """Newton-Schulz polar PSD projection (ops/cones.py:polar_psd) — the
    matmul-only race-phase engine (no reference counterpart; replaces the
    dense eigh whose backend latency is data-dependent)."""

    @pytest.fixture
    def rng(self):
        return np.random.RandomState(7)

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
    def test_matches_oracle(self, rng, dtype):
        from proxsdp_tpu.ops.cones import polar_psd

        n = 120
        V = np.linalg.qr(rng.randn(n, n))[0]
        for spec in (
            np.linspace(-1, 1, n),
            np.concatenate([np.linspace(0.1, 2.0, 10), -np.abs(rng.randn(n - 10))]),
            rng.randn(n) * 3,
        ):
            X = (V * spec) @ V.T
            Xp, rank = polar_psd(jnp.asarray(X, dtype), n, aggressive=7, polish=4)
            want = (V * np.maximum(spec, 0)) @ V.T
            scale = np.abs(spec).max()
            err = np.abs(np.asarray(Xp, np.float64) - want).max() / scale
            assert err < 5e-5, err
            assert int(rank) == int((spec > 0).sum())

    def test_tiny_eigenvalues_bounded_error(self, rng):
        """Eigenvalues below the sign threshold project with error <= |lam|
        (soft-thresholding, never amplification)."""
        from proxsdp_tpu.ops.cones import polar_psd

        n = 100
        V = np.linalg.qr(rng.randn(n, n))[0]
        spec = np.concatenate([np.linspace(0.5, 1, 10), 1e-6 * rng.randn(n - 10)])
        X = (V * spec) @ V.T
        Xp, _ = polar_psd(jnp.asarray(X), n, aggressive=7, polish=4)
        want = (V * np.maximum(spec, 0)) @ V.T
        assert np.abs(np.asarray(Xp) - want).max() < 1e-5

    def test_projection_block_polar_mode(self, rng):
        """projection='polar' engages in psd_projection_block for sides >=
        polar_min_side and reports full-path min_eig semantics."""
        side = 110
        opts = Options(projection="polar", polar_min_side=100)
        A = rng.randn(side, side)
        A = (A + A.T) / 2
        v = np.asarray(square_to_tri(jnp.asarray(A), side))
        res = psd_projection_block(
            jnp.asarray(v), side, jnp.asarray(2, jnp.int32),
            jnp.asarray(rng.randn(side)), opt=opts, allow_lanczos=False,
        )
        got = np.asarray(tri_to_square(res.block, side))
        assert np.abs(got - psd_oracle(A)).max() < 5e-4 * np.abs(A).max()
        assert float(res.min_eig) == 0.0
        assert not bool(res.used_full)
