"""Structured-application suites (reference test/moitest.jl:97-151):
MIMO detection, sensor localization, random SDPs, SDPLIB instances."""

import os

import numpy as np
import pytest

import proxsdp_tpu as px
from proxsdp_tpu.models import (
    maxcut,
    mimo,
    randsdp,
    sdplib,
    sensorloc,
)

SDPLIB_DIR = "/root/reference/test/data"


class TestMIMO:
    @pytest.mark.parametrize("n", [2, 3, 4, 5])
    def test_detection(self, n):
        """reference moitest.jl:97-105: solve at tol 1e-6; every |X_ij| in
        (0.99, 1.01); sign recovery of the true signal."""
        opts = px.Options(tol_gap=1e-6, tol_feasibility=1e-6)
        X, s, res = mimo.solve_mimo(seed=0, n=n, options=opts)
        assert res.status == 1, res.status_string
        assert np.all(np.abs(X) > 0.99) and np.all(np.abs(X) < 1.01)
        x_hat, decode_error, rank = mimo.mimo_eval(s, X)
        assert decode_error == 0.0
        assert rank == 1


class TestSensorLoc:
    @pytest.mark.parametrize("n", [5, 10])
    def test_solves(self, n):
        """reference moitest.jl:145-151: OPTIMAL at tol 1e-6."""
        opts = px.Options(tol_gap=1e-6, tol_feasibility=1e-6)
        X, x_true, res = sensorloc.solve_sensorloc(seed=0, n=n, options=opts)
        assert res.status == 1, res.status_string
        # anchor frame pinned
        assert abs(X[0, 0] - 1.0) < 1e-3 and abs(X[1, 1] - 1.0) < 1e-3


class TestRandSDP:
    def test_mini_benchmark_variant(self):
        """run_mini_benchmark.jl solves randsdp WITHOUT the box bounds;
        assertion level mirrors moi_randsdp.jl:70-81 (relative violation
        < 1e-1; X PSD at -1e-4)."""
        from proxsdp_tpu.solver import solve

        prob, Xidx, (A, b, C) = randsdp.randsdp_problem(
            seed=0, n=10, m=5, varbounds=False
        )
        res = solve(prob, px.Options(max_iter=50_000))
        assert res.status == 1, res.status_string
        X = res.primal[Xidx]
        minus_rank, rank, obj, viol = randsdp.randsdp_eval(A, b, C, X)
        eigs = np.linalg.eigvalsh(X)
        assert np.sum(eigs < -1e-4) == 0
        rel_viol = max(
            v / (1.0 + abs(bk)) for v, bk in zip(viol, b.values())
        )
        assert rel_viol < 1e-1

    def test_bounded_variant_feasibility(self):
        """The bounded variant (moi_randsdp.jl:32-45 quirk: +-10 bounds on
        the first n triangle vars) is hard for PDHG — the reference's CI
        has it disabled (moitest.jl:110-114).  We assert feasibility-level
        quality, not optimality."""
        X, (A, b, C), res = randsdp.solve_randsdp(
            seed=0, n=10, m=5, max_iter=5000
        )
        minus_rank, rank, obj, viol = randsdp.randsdp_eval(A, b, C, X)
        # limit exit may come from the hybrid f32 phase: PSD-ness at the
        # reference's own low-accuracy threshold (moi_sdplib.jl:53-56)
        eigs = np.linalg.eigvalsh(X)
        assert np.sum(eigs < -1e-4) == 0
        rel_viol = max(
            v / (1.0 + abs(bk)) for v, bk in zip(viol, b.values())
        )
        assert rel_viol < 1e-1


class TestMaxcutModel:
    def test_random_graph(self):
        W = maxcut.random_graph_weights(seed=1, n=12)
        X, res = maxcut.solve_maxcut(W)
        assert res.status == 1
        eigs = np.linalg.eigvalsh(X)
        assert eigs.min() > -1e-6
        assert np.allclose(np.diag(X), 1.0, atol=1e-3)


@pytest.mark.skipif(not os.path.isdir(SDPLIB_DIR), reason="SDPLIB data absent")
class TestSDPLIB:
    def test_parser_mcp124(self):
        n, m, entries, c = sdplib.sdplib_data(f"{SDPLIB_DIR}/mcp124-1.dat-s")
        assert n == 124 and m == 124
        assert len(c) == 124
        assert entries.shape[1] == 4

    def test_native_parser_agrees(self):
        """C++ parser (native/parse_sdpa.cpp) must agree with the Python
        fallback exactly."""
        try:
            from proxsdp_tpu.utils.native import parse_sdpa
        except Exception:
            pytest.skip("native parser not built")
        path = f"{SDPLIB_DIR}/mcp124-1.dat-s"
        n1, m1, e1, c1 = parse_sdpa(path)
        import proxsdp_tpu.models.sdplib as s

        # call the pure-Python path directly by bypassing _try_native
        native = s._try_native
        s._try_native = lambda p: None
        try:
            n2, m2, e2, c2 = s.sdplib_data(path)
        finally:
            s._try_native = native
        assert (n1, m1) == (n2, m2)
        assert np.allclose(c1, c2)
        assert e1.shape == e2.shape
        assert np.allclose(np.sort(e1, axis=0), np.sort(e2, axis=0))

    @pytest.mark.parametrize("name,published", [
        ("mcp124-1", 141.990),
        ("gpp124-1", -7.3431),
    ])
    def test_solve_sdplib(self, name, published):
        """reference moitest.jl:120-143 at tol 1e-3: solution PSD; we
        additionally check the objective against the SDPLIB published
        optimum (sign flipped by the reference's F0 negation)."""
        opts = px.Options(tol_gap=1e-3, tol_feasibility=1e-3,
                          max_iter=100_000)
        X, res = sdplib.solve_sdplib(f"{SDPLIB_DIR}/{name}.dat-s", opts)
        assert sdplib.sdplib_eval(f"{SDPLIB_DIR}/{name}.dat-s", X) == 0
        assert abs(res.objval - (-published)) / abs(published) < 2e-2, (
            res.objval, res.status_string
        )


class TestPerturbedSDPLIBInfeasible:
    """Certificate path at realistic size: an mcp124-shaped max-cut
    (side 124, 2% edge density, generated in the repo) with an appended
    diag-entry = -1 equality is infeasible (PSD forces diag >= 0).  The
    solver must classify it INFEASIBLE and run the certificate search
    gracefully within a bounded time budget (finding the ray within the
    short CI budget is not required)."""

    def test_mcp124_with_contradictory_row(self):
        import scipy.sparse as sp
        from proxsdp_tpu.problem import ConicProblem
        from proxsdp_tpu.solver import solve

        problem, _ = maxcut.maxcut_problem(
            maxcut.random_graph_weights(1, 124, density=0.02)
        )
        A = sp.csr_matrix(problem.A)
        n = problem.n
        row = np.zeros((1, n))
        row[0, problem.sdp_vars[0][0]] = 1.0
        A2 = sp.vstack([A, sp.csr_matrix(row)]).tocsc()
        b2 = np.concatenate([problem.b, [-1.0]])
        p2 = ConicProblem(
            c=problem.c, A=A2, b=b2, G=problem.G, h=problem.h,
            sdp_vars=problem.sdp_vars, soc_vars=problem.soc_vars,
            objective_sense=problem.objective_sense,
        )
        # hybrid off: one compiled program for this one-off geometry, and
        # the f32 race adds nothing on an infeasible instance.  The stall
        # window is relaxed with the reference's own knobs (as the
        # conformance suite's infeasibility tests do): at the defaults this
        # instance declares only at the iteration limit, which a loaded
        # CPU does not reach within the time limit
        r = solve(
            p2,
            px.Options(
                max_iter=20000, time_limit=150, hybrid_precision=False,
                infeas_gap_tol=0.3, infeas_stable_gap_tol=1e-2,
            ),
        )
        # certified infeasibility when the ray search finishes in budget;
        # under CPU contention the search may run out of time, in which
        # case the declaration is demoted to a limit status with the
        # suspicion annotated (never a bare INFEASIBLE without a ray)
        if r.status == 6:
            assert r.certificate_found, r.status_string
            assert r.termination_status == "INFEASIBLE"
        else:
            assert r.status in (2, 3), (r.status, r.status_string)
            assert "Suspected infeasible" in r.status_string, r.status_string


class TestMaxcutCertificate:
    """models.maxcut.maxcut_certificate: solver-independent bounds."""

    W4 = np.array([[18., -5, -7, -6], [-5, 6, 0, -1],
                   [-7, 0, 8, -1], [-6, -1, -1, 8]])

    @pytest.fixture(scope="class")
    def solved(self):
        X, res = maxcut.solve_maxcut(
            self.W4, px.Options(tol_gap=1e-4, tol_feasibility=1e-4)
        )
        return X, res

    def test_brackets_readme_optimum(self, solved):
        X, res = solved
        L, U, gap = maxcut.maxcut_certificate(self.W4, X, res.dual_eq)
        assert L <= 18.0 + 1e-9 <= U + 2e-9
        assert 0.0 <= gap <= 1e-3

    def test_sign_of_dual_does_not_matter(self, solved):
        X, res = solved
        a = maxcut.maxcut_certificate(self.W4, X, res.dual_eq)
        b = maxcut.maxcut_certificate(self.W4, X, -res.dual_eq)
        assert a == b

    @pytest.mark.parametrize("scale", [0.05, 0.3])
    def test_rejects_perturbed_x(self, solved, scale):
        X, res = solved
        rng = np.random.RandomState(0)
        E = rng.randn(4, 4)
        L, U, gap = maxcut.maxcut_certificate(
            self.W4, X + scale * (E + E.T), res.dual_eq
        )
        assert L < 18.0 and gap > 1e-3

    @pytest.mark.parametrize("kind", ["raise_one", "random"])
    def test_rejects_perturbed_y(self, solved, kind):
        X, res = solved
        y = res.dual_eq.copy()
        if kind == "raise_one":
            y[0] += 0.05
        else:
            y += 0.1 * np.random.RandomState(2).randn(4)
        L, U, gap = maxcut.maxcut_certificate(self.W4, X, y)
        assert U >= 18.0 and gap > 1e-3

    def test_zero_diagonal_stays_feasible(self):
        # a PSD projection with a zero diagonal entry: the rescaled point
        # sets it to 1 and stays a valid (feasible) lower bound
        X = np.zeros((4, 4))
        X[:2, :2] = 1.0
        L, U, _ = maxcut.maxcut_certificate(self.W4, X, np.zeros(4))
        assert np.isfinite(L) and L <= 18.0 <= U
