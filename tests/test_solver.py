"""End-to-end solver tests: known-answer problems (reference
test/moi_proxsdp_unit.jl) and termination statuses
(test/test_terminationstatus.jl)."""

import numpy as np
import pytest

import proxsdp_tpu as px


def build_maxcut_opt(**kw):
    W = np.array(
        [[18.0, -5.0, -7.0, -6.0],
         [-5.0, 6.0, 0.0, -1.0],
         [-7.0, 0.0, 8.0, -1.0],
         [-6.0, -1.0, -1.0, 8.0]]
    )
    opt = px.Optimizer(**kw)
    X = opt.add_psd_var(4)
    for i in range(4):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * W), sense="max")
    return opt, X


class TestKnownAnswers:
    def test_readme_maxcut(self):
        opt, X = build_maxcut_opt(tol_gap=1e-4, tol_feasibility=1e-4)
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2
        Xs = opt.get_psd_solution(X)
        assert np.allclose(np.diag(Xs), 1.0, atol=1e-3)
        assert np.linalg.eigvalsh(Xs).min() > -1e-6
        assert res.final_rank == 1

    def test_simple_2x2_sdp(self):
        """min -4x11 - 4x12 + ... style 2x2 with known X (reference
        moi_proxsdp_unit.jl:184-223 solves to X = ones(2,2))."""
        # min <C,X> with C=[[2,1],[1,2]] s.t. x11=1, x22=1 -> X = ones
        opt = px.Optimizer()
        X = opt.add_psd_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
        opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
        opt.set_objective(
            opt.psd_inner_product_coeffs(X, np.array([[2.0, 1.0], [1.0, 2.0]])),
            sense="min",
        )
        res = opt.optimize()
        assert res.status == 1
        # optimum at x12 = -1 (PSD boundary): obj = 2+2-2 = 2
        assert abs(res.objval - 2.0) < 1e-2
        Xs = opt.get_psd_solution(X)
        assert abs(Xs[0, 1] + 1.0) < 1e-2

    def test_min_max_eigenvalue(self):
        C = np.array([[2.0, 1.0], [1.0, 2.0]])
        X, res = px.solve_sdp(C, As=[np.eye(2)], bs=[1.0], sense="max")
        assert abs(res.objval - 3.0) < 1e-2
        X, res = px.solve_sdp(C, As=[np.eye(2)], bs=[1.0], sense="min")
        assert abs(res.objval - 1.0) < 1e-2

    def test_wiki_sdp(self):
        """Wikipedia 3x3 example (reference moi_proxsdp_unit.jl:302-338):
        min/max x13 s.t. corr matrix with x12 in [-.2,-.1], x23 in [.4,.5]:
        min -> -0.978, max -> 0.872."""
        for sense, expected in [("min", -0.978), ("max", 0.872)]:
            opt = px.Optimizer()
            X = opt.add_psd_var(3)
            for i in range(3):
                opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
            # -0.2 <= x12 <= -0.1 ; 0.4 <= x23 <= 0.5
            opt.add_ineq_constraint({int(X[0, 1]): 1.0}, -0.1)
            opt.add_ineq_constraint({int(X[0, 1]): -1.0}, 0.2)
            opt.add_ineq_constraint({int(X[1, 2]): 1.0}, 0.5)
            opt.add_ineq_constraint({int(X[1, 2]): -1.0}, -0.4)
            opt.set_objective({int(X[0, 2]): 1.0}, sense=sense)
            res = opt.optimize()
            assert res.status == 1, res.status_string
            assert abs(res.objval - expected) < 1e-2, (sense, res.objval)

    def test_two_sdp_blocks(self):
        """Two simultaneous PSD blocks (moi_proxsdp_unit.jl double-block)."""
        opt = px.Optimizer()
        X = opt.add_psd_var(2)
        Y = opt.add_psd_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
        opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
        opt.add_eq_constraint({int(Y[0, 0]): 1.0}, 2.0)
        opt.add_eq_constraint({int(Y[1, 1]): 1.0}, 2.0)
        opt.set_objective(
            {int(X[0, 1]): 1.0, int(Y[0, 1]): 1.0}, sense="min"
        )
        res = opt.optimize()
        assert res.status == 1
        # each off-diag bounded below by -sqrt(d1*d2): -1 + -2 = -3
        assert abs(res.objval + 3.0) < 2e-2

    def test_lp_as_sdp(self):
        """Diagonal SDP == LP (moi_proxsdp_unit.jl LP-as-SDP)."""
        opt = px.Optimizer()
        X = opt.add_psd_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0, int(X[1, 1]): 1.0}, 4.0)
        opt.add_eq_constraint({int(X[0, 1]): 1.0}, 0.0)
        opt.set_objective({int(X[0, 0]): 1.0, int(X[1, 1]): 2.0}, sense="min")
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 4.0) < 2e-2  # all mass on x11

    def test_soc_norm(self):
        opt = px.Optimizer()
        s = opt.add_soc_var(3)
        opt.add_eq_constraint({int(s[1]): 1.0}, 3.0)
        opt.add_eq_constraint({int(s[2]): 1.0}, 4.0)
        opt.set_objective({int(s[0]): 1.0}, sense="min")
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 5.0) < 1e-2

    def test_free_vars_lp(self):
        opt = px.Optimizer()
        opt.add_free_vars(2)
        opt.add_ineq_constraint({0: -1.0}, -1.0)  # x >= 1
        opt.add_eq_constraint({1: 1.0}, 2.0)  # y = 2
        opt.set_objective({0: 1.0, 1: 1.0}, sense="min")
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 3.0) < 1e-2

    def test_mixed_sdp_soc(self):
        """PSD + SOC + free in one problem."""
        opt = px.Optimizer()
        X = opt.add_psd_var(2)
        s = opt.add_soc_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
        opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
        opt.add_eq_constraint({int(s[1]): 1.0}, 2.0)  # |2| <= t
        opt.set_objective({int(X[0, 1]): 1.0, int(s[0]): 1.0}, sense="min")
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - (-1.0 + 2.0)) < 2e-2


class TestTermination:
    def test_iteration_limit(self):
        opt, _ = build_maxcut_opt(max_iter=1)
        res = opt.optimize()
        assert res.status == 3
        assert res.iter == 1
        assert res.termination_status == "ITERATION_LIMIT"

    def test_time_limit(self):
        opt, _ = build_maxcut_opt(time_limit=0.0)
        res = opt.optimize()
        assert res.status == 2
        assert res.termination_status == "TIME_LIMIT"

    def test_infeasible(self):
        opt = px.Optimizer(max_iter=20000)
        X = opt.add_psd_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, 2.0)
        opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
        res = opt.optimize()
        assert res.status == 6
        assert res.termination_status == "INFEASIBLE"

    def test_unbounded(self):
        opt = px.Optimizer(max_iter=20000)
        v = opt.add_free_vars(1)
        opt.add_ineq_constraint({0: -1.0}, -1.0)  # x >= 1
        opt.set_objective({0: -1.0}, sense="min")  # min -x -> unbounded below
        res = opt.optimize()
        assert res.status == 5, res.status_string

    def test_infeasible_sdp_dual_ray(self):
        """Certificate search finds a Farkas dual ray for an infeasible SDP
        (reference certificate_infeasibility, pdhg.jl:655-668)."""
        opt = px.Optimizer()
        X = opt.add_psd_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, -1.0)  # x11 = -1, X psd
        opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
        res = opt.optimize()
        assert res.status == 6
        assert res.certificate_found
        assert "ray" in res.status_string.lower()

    def test_unbounded_lp_primal_ray(self):
        """Certificate search finds a primal ray for an unbounded LP
        (reference certificate_dual_infeasibility, pdhg.jl:639-653)."""
        opt = px.Optimizer()
        opt.add_free_vars(1)
        opt.add_ineq_constraint({0: 1.0}, 0.0)  # x <= 0
        opt.set_objective({0: 1.0}, sense="min")
        res = opt.optimize()
        assert res.status == 5
        assert res.certificate_found

    def test_certificate_search_disabled(self):
        opt = px.Optimizer(certificate_search=False)
        X = opt.add_psd_var(2)
        opt.add_eq_constraint({int(X[0, 0]): 1.0}, -1.0)
        opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
        res = opt.optimize()
        assert res.status == 6
        assert not res.certificate_found

    def test_no_false_infeasible_without_certificate(self):
        """A feasible problem mis-declared infeasible by the stall
        heuristics must NOT surface status 5/6 once the certificate
        search fails: it is demoted to a limit status with a "suspected"
        annotation (r2 verdict: control1-4/truss6 returned hard
        INFEASIBLE on feasible SDPs).  Deviation from reference
        pdhg.jl:228-244, which keeps stop_reason 6."""
        # aggressive mis-detection knobs: any not-yet-converged iterate
        # with feasibility > 1e-12 "stalls" immediately after iter 8
        opt, _ = build_maxcut_opt(
            min_iter_max_obj=8,
            infeas_limit_gap_tol=0.0,
            infeas_feasibility_tol=1e-12,
            infeas_stable_feasibility_tol=1e10,
            max_iter=300,
            tol_gap=1e-12,          # unreachable: never converges
            tol_feasibility=1e-12,
        )
        res = opt.optimize()
        # never an uncertified INFEASIBLE/UNBOUNDED.  Either the resume
        # machinery recovered the solve (status 1 — observed: after the
        # failed search the solver converges to the exact rank-1 cut) or
        # the demoted limit status with the suspicion annotated.
        assert res.status in (1, 2, 3), (res.status, res.status_string)
        assert not res.certificate_found
        if res.status in (2, 3):
            assert "Suspected infeasible" in res.status_string, (
                res.status_string
            )
        else:
            # only the certificate-search budget extension can carry the
            # solve past max_iter=300 — proves the mis-declaration fired
            assert res.iter > 300, res.iter
        # the cached best solution is returned, not a zeroed ray
        assert np.isfinite(res.objval)


class TestWarmStart:
    def test_warm_start_cuts_iterations(self):
        # min_iter=0: otherwise the min_iter=40 floor masks the cut
        opt, X = build_maxcut_opt(min_iter=0)
        res1 = opt.optimize()
        assert res1.status == 1
        res2 = opt.optimize(warm_start=res1)
        assert res2.status == 1
        assert abs(res2.objval - res1.objval) < 1e-2
        # restarting at the solution should converge almost immediately
        assert res2.iter < res1.iter / 2, (res2.iter, res1.iter)

    def test_warm_start_tuple_form(self):
        opt, X = build_maxcut_opt()
        res1 = opt.optimize()
        res2 = opt.optimize(
            warm_start=(res1.primal, res1.dual_eq, res1.dual_in)
        )
        assert res2.status == 1
        assert abs(res2.objval - res1.objval) < 1e-2


class TestCheckpoint:
    def test_checkpoint_and_resume(self, tmp_path):
        """Interrupt a solve at an iteration limit, resume from the
        checkpoint, and converge (no reference counterpart: SURVEY.md §5
        documents checkpointing as absent upstream)."""
        from proxsdp_tpu.solver import solve

        ckpt = str(tmp_path / "state.npz")
        opt, _ = build_maxcut_opt()
        prob = opt.build_problem()
        # phase 1: stop early with a checkpoint on disk
        r1 = solve(prob, px.Options(
            checkpoint_path=ckpt, checkpoint_freq=10, max_iter=60,
            chunk_iters=20, min_iter=0))
        assert r1.status == 3  # iteration limit
        import os
        assert os.path.exists(ckpt)
        # phase 2: resume and run to optimality
        r2 = solve(prob, px.Options(min_iter=0), resume_from=ckpt)
        assert r2.status == 1
        assert abs(r2.objval - 18.0) < 5e-2
        assert r2.iter > 20  # continued from the saved iterate

    def test_checkpoint_roundtrip_state(self, tmp_path):
        from proxsdp_tpu.problem import preprocess
        from proxsdp_tpu.solver import init_state
        from proxsdp_tpu.utils.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        opt, _ = build_maxcut_opt()
        setup = preprocess(opt.build_problem())
        s = init_state(setup.layout, px.Options(), setup)
        p = str(tmp_path / "s.npz")
        save_checkpoint(p, s, phase32=True)
        s2, ph = load_checkpoint(p)
        assert ph is True
        np.testing.assert_array_equal(np.asarray(s.x), np.asarray(s2.x))
        np.testing.assert_array_equal(
            np.asarray(s.buf_gap), np.asarray(s2.buf_gap)
        )
        assert len(s.warm) == len(s2.warm)


class TestOptions:
    def test_unknown_option_errors(self):
        with pytest.raises(ValueError):
            px.make_options(not_an_option=1)

    def test_block_equilibration_string_coercion(self):
        """CLI --opt plumbing passes strings; 'False' must not become
        truthy (round-5 regression: forced-beq probe arms silently died
        on validation)."""
        from proxsdp_tpu.options import Options

        assert Options(block_equilibration="true").block_equilibration is True
        assert Options(block_equilibration="off").block_equilibration is False
        assert Options(block_equilibration="auto").block_equilibration == "auto"
        with pytest.raises(ValueError):
            Options(block_equilibration="garbage")

    def test_full_eig_decomp_mode(self):
        opt, _ = build_maxcut_opt(full_eig_decomp=True)
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2

    def test_no_linesearch_mode(self):
        opt, _ = build_maxcut_opt(line_search_flag=False)
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2

    def test_float32_mode(self):
        opt, _ = build_maxcut_opt(dtype="float32", tol_gap=1e-3,
                                  tol_feasibility=1e-3)
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 0.5

    def test_equilibration_forced(self):
        opt, _ = build_maxcut_opt(equilibration_force=True,
                                  equilibration_iters=100)
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2

    def test_exact_norm_mode(self):
        opt, _ = build_maxcut_opt(approx_norm=False)
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2

    def test_check_dual_feas_mode(self):
        """check_dual_feas gates optimality on host-verified dual
        feasibility (reference pdhg.jl:248-249).  The guarded solve must
        still reach OPTIMAL and report a dual-feasible solution (r2
        verdict weak #6: the veto path was untested on a full solve)."""
        opt, _ = build_maxcut_opt(
            check_dual_feas=True, check_dual_feas_freq=64
        )
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2
        assert res.dual_feasible_user_tol

    def test_check_dual_feas_mixed_cones(self):
        # LP + SOC + PSD geometry through the same veto path
        o = px.Optimizer(check_dual_feas=True, check_dual_feas_freq=64)
        X = o.add_psd_var(2)
        s = o.add_soc_var(3)
        o.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
        o.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
        o.add_eq_constraint({int(s[1]): 1.0}, 3.0)
        o.add_eq_constraint({int(s[2]): 1.0}, 4.0)
        o.set_objective(
            {int(X[0, 1]): 2.0, int(s[0]): 1.0}, sense="min"
        )
        res = o.optimize()
        assert res.status == 1
        # X12 -> -1 on the PSD boundary, ||v|| <= t -> t = 5
        assert abs(res.objval - 3.0) < 5e-2
        assert res.dual_feasible_user_tol

    def test_block_equilibration_mode(self):
        """Cone-safe block Ruiz equilibration (an extension,
        ROADMAP §3) preserves the solution; round-trip through the
        shared equilibration undo path."""
        opt, _ = build_maxcut_opt(block_equilibration=True)
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2

    def test_equilibrated_feasibility_is_user_units(self):
        """A row scaled down by 1e-4 must not hide its violation behind
        the equilibration: OPTIMAL may only be declared when the USER-
        unit residual meets tol (observed on SDPLIB arch2: status 1 with
        lin_viol 0.146 before the row_unscale operand)."""
        W = np.array(
            [[18.0, -5.0, -7.0, -6.0],
             [-5.0, 6.0, 0.0, -1.0],
             [-7.0, 0.0, 8.0, -1.0],
             [-6.0, -1.0, -1.0, 8.0]]
        )
        opt = px.Optimizer(tol_feasibility=1e-5, tol_gap=1e-5)
        X = opt.add_psd_var(4)
        for i in range(4):
            # same feasible set as maxcut, rows deliberately mis-scaled
            # across 4 decades (forces the auto block equilibration on)
            s = 10.0 ** (-4 * (i % 2))
            opt.add_eq_constraint({int(X[i, i]): s}, s)
        opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * W), sense="max")
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2
        Xs = opt.get_psd_solution(X)
        # USER-unit feasibility: every diagonal pinned to 1 within ~tol
        assert np.abs(np.diag(Xs) - 1.0).max() < 1e-3, np.diag(Xs)

    def test_beq_probe_races_both_preconditioners(self, capsys):
        """block_equilibration="auto" with row-norm spread above the
        probe threshold races both preconditioners through the same
        compiled program (solver._solve_with_beq_probe) and returns the
        winner's result; a probe arm that SOLVES is returned directly.
        Motivation: a static spread gate mispredicts within one SDPLIB
        family (arch0 rescued / arch2 regressed at the same spread)."""
        opt = px.Optimizer(log_verbose=True, log_freq=10**9)
        X = opt.add_psd_var(4)
        W = np.array(
            [[18.0, -5.0, -7.0, -6.0],
             [-5.0, 6.0, 0.0, -1.0],
             [-7.0, 0.0, 8.0, -1.0],
             [-6.0, -1.0, -1.0, 8.0]]
        )
        for i in range(4):
            s = 100.0 if i % 2 else 1.0  # spread 100 > probe threshold 3
            opt.add_eq_constraint({int(X[i, i]): s}, s)
        opt.set_objective(
            opt.psd_inner_product_coeffs(X, 0.25 * W), sense="max"
        )
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2
        assert "[beq probe]" in capsys.readouterr().out

    def test_limit_status_reports_total_iters(self):
        """At a limit status the solver may return the BEST tracked
        iterate (ring buffers rewound to its position) — but Result.iter
        must still report the total iterations actually run."""
        opt, _ = build_maxcut_opt(max_iter=37, min_iter=0)
        res = opt.optimize()
        assert res.status == 3
        assert res.iter == 37, res.iter
        assert np.isfinite(res.objval)

    def test_limit_status_flags_infeasible_iterate(self):
        """A limit status whose returned point violates the linear
        constraints by > 10x tol_feasibility must say so in the status
        string, so a truss8-style "Time limit hit" row cannot be read as
        a near-solution (reference pdhg.jl:335-382 returns its cached
        point silently; we annotate)."""
        opt, _ = build_maxcut_opt(max_iter=1, min_iter=0)
        res = opt.optimize()
        assert res.status == 3
        # one iteration from the cold start cannot satisfy X_ii = 1
        assert "(infeasible iterate, lin_viol=" in res.status_string

    def test_limit_status_near_feasible_not_flagged(self):
        """A limit hit at an already-near-feasible iterate stays clean."""
        # past the 1e-4 optimum (~116 iters) but below the iterate where
        # the f64 gap collapses to exactly 0 (~335) — the returned point
        # is near-feasible and the limit status must stay unannotated
        opt, _ = build_maxcut_opt(max_iter=200, tol_gap=1e-30)
        res = opt.optimize()
        assert res.status == 3
        assert "(infeasible iterate" not in res.status_string

    def test_adaptive_restart_mode(self):
        """restart="adaptive" (PDLP-style restart-to-average; an
        extension, no reference counterpart) converges to the same
        answer with a short epoch so the restart logic actually fires."""
        opt, _ = build_maxcut_opt(
            restart="adaptive", restart_window=32, chunk_iters=32
        )
        res = opt.optimize()
        assert res.status == 1
        assert abs(res.objval - 18.0) < 5e-2

    def test_restart_value_validated(self):
        with pytest.raises(ValueError):
            px.make_options(restart="bogus")

    def test_print_options_exercise(self, capsys):
        """Extended logging columns + repeat header + limit warning
        (reference print-options smoke, moi_proxsdp_unit.jl:350-356;
        printing.jl:69-150, pdhg.jl:369-376)."""
        opt, _ = build_maxcut_opt(
            log_verbose=True, log_freq=16, chunk_iters=16,
            extended_log2=True, log_repeat_header=True, warn_on_limit=True,
            max_iter=48, tol_gap=1e-14, tol_feasibility=1e-14,
        )
        res = opt.optimize()
        out = capsys.readouterr().out
        assert res.status == 3
        assert "dobj=" in out and "dfeas=" in out
        assert out.count("d feasb.") >= 2  # repeated header
        assert "WARNING: Iteration limit hit." in out


class TestInitState:
    def test_cold_start_matches_reference_iterate0(self):
        """Cold start: x = tau*c (advanced initialization) but x_old and
        Mx_old stay ZERO, exactly like the reference's fresh PrimalDual
        (pdhg.jl:138-142 sets only x; x_old is the zeros it was
        constructed with).  Round-1 regression: a shadowed variable made
        every cold start take the warm branch (x_old = x0)."""
        from proxsdp_tpu.problem import preprocess
        from proxsdp_tpu.solver import init_state

        opt, _ = build_maxcut_opt()
        problem = opt.build_problem()
        setup = preprocess(problem)
        st = init_state(setup.layout, px.Options(), setup)

        tau = float(st.primal_step)
        np.testing.assert_allclose(
            np.asarray(st.x), tau * setup.c, rtol=1e-12
        )
        assert np.all(np.asarray(st.x_old) == 0.0)
        assert np.all(np.asarray(st.Mx_old) == 0.0)
        assert np.all(np.asarray(st.Mty) == 0.0)
        # warm start still seeds the old iterates with the given point
        x0 = np.asarray(st.x)
        y0 = np.zeros(setup.layout.p + setup.layout.m)
        stw = init_state(setup.layout, px.Options(), setup, warm=(x0, y0))
        np.testing.assert_allclose(np.asarray(stw.x_old), x0, rtol=1e-12)
        assert np.any(np.asarray(stw.Mx_old) != 0.0)


class TestDataScaling:
    """PDLP-style objective/rhs normalization (Options.scale_objective /
    scale_rhs; an extension).  The solver must return USER-unit
    primal/dual/objective values, and badly-imbalanced instances must not
    be mis-declared (theta2 with ||c||=141 was declared infeasible, and
    randsdp with ||b||=806 needed 23k iterations, before these)."""

    def _mineig(self, scale_c, scale_b):
        # min <sc*C, X> s.t. <I, X> = sb, X psd  -> obj = sc*sb*lam_min(C)
        import numpy as np
        from proxsdp_tpu.api import solve_sdp

        C = scale_c * np.array([[2.0, 1.0], [1.0, 2.0]])
        return solve_sdp(C=C, As=[np.eye(2)], bs=[scale_b])

    def test_unscaling_exact(self):
        X, r = self._mineig(100.0, 50.0)
        assert r.status == 1
        # lam_min = 1 -> obj = 100*50*1
        assert abs(r.objval - 5000.0) / 5000.0 < 1e-3
        # dual of <I,X>=b is lam_min(C) = 100 in user units; the solver
        # carries the reference's sign convention (dual_obj = -b'y), so
        # the stored multiplier is -lam_min
        np.testing.assert_allclose(r.dual_eq, [-100.0], rtol=1e-2)
        # primal solution X = b * v v^T with trace b = 50
        assert abs(np.trace(X) - 50.0) / 50.0 < 1e-3

    def test_scaling_off_matches_on(self):
        X1, r1 = self._mineig(3.0, 2.0)
        from proxsdp_tpu.api import solve_sdp
        import numpy as np

        C = 3.0 * np.array([[2.0, 1.0], [1.0, 2.0]])
        X2, r2 = solve_sdp(
            C=C, As=[np.eye(2)], bs=[2.0],
            options=px.Options(scale_objective=False, scale_rhs=False),
        )
        assert r1.status == r2.status == 1
        assert abs(r1.objval - r2.objval) < 1e-2 * (1 + abs(r2.objval))

    def test_imbalanced_objective_not_misdeclared(self):
        # theta-style imbalance: huge ||c||, ||b||=1.  Without obj scaling
        # the dual overshoots by ||c|| and the stall heuristic declares
        # infeasible; with it this must solve.
        import numpy as np
        from proxsdp_tpu.api import solve_sdp

        rng = np.random.RandomState(7)
        B = rng.randn(12, 12)
        C = 200.0 * (B + B.T) / 2.0
        X, r = solve_sdp(C=C, As=[np.eye(12)], bs=[1.0],
                         options=px.Options(max_iter=20000))
        assert r.status == 1, r.status_string
        lam = np.linalg.eigvalsh(C).min()
        assert abs(r.objval - lam) < 1e-2 * (1 + abs(lam))

    def test_warm_start_round_trip_with_scaling(self):
        # warm-starting from a USER-unit Result must land at the solution
        # (ingestion divides by the scales the Result multiplied in)
        X, r = self._mineig(100.0, 50.0)
        from proxsdp_tpu.api import solve_sdp
        import numpy as np

        C = 100.0 * np.array([[2.0, 1.0], [1.0, 2.0]])
        X2, r2 = solve_sdp(C=C, As=[np.eye(2)], bs=[50.0], warm_start=r)
        assert r2.status == 1
        assert r2.iter <= r.iter
        assert abs(r2.objval - 5000.0) / 5000.0 < 1e-3
