"""Solver options.

Re-design of the reference's flat ``Options`` struct
(reference: src/options.jl:1-132).  Same field names and defaults so users of
the reference can switch without relearning the knob surface.  The dataclass
is frozen/hashable because it is consumed as a *static* argument when the
PDHG chunk is jit-compiled: changing an option triggers a (cached) recompile,
exactly like changing a Julia type parameter.

Fields that only made sense for ARPACK's reverse-communication interface are
kept for API compatibility but are inert (documented per-field).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Options:
    # ------------------------------------------------------------------
    # Printing options (reference: src/options.jl:3-16)
    # ------------------------------------------------------------------
    log_verbose: bool = False
    log_freq: int = 1000
    timer_verbose: bool = False
    timer_file: bool = False
    disable_julia_logger: bool = True  # inert (no Julia logger here)

    # time options
    time_limit: float = 360000.0  # seconds (100 hours)

    warn_on_limit: bool = False
    extended_log: bool = False
    extended_log2: bool = False
    log_repeat_header: bool = False

    # ------------------------------------------------------------------
    # Tolerances (reference: src/options.jl:18-28)
    # ------------------------------------------------------------------
    tol_gap: float = 1e-4
    tol_feasibility: float = 1e-4
    tol_feasibility_dual: float = 1e-4
    tol_primal: float = 1e-4
    tol_dual: float = 1e-4
    tol_psd: float = 1e-7
    tol_soc: float = 1e-7

    # Host-side dual-feasibility gate on optimality declarations; after a
    # veto, re-declaration is suppressed for check_dual_feas_freq
    # iterations (reference pdhg.jl:248-249 cadence).
    check_dual_feas: bool = False
    check_dual_feas_freq: int = 1000

    max_obj: float = 1e20
    min_iter_max_obj: int = 10

    # infeasibility check (reference: src/options.jl:33-39)
    min_iter_time_infeas: int = 1000
    infeas_gap_tol: float = 1e-4
    infeas_limit_gap_tol: float = 1e-1
    infeas_stable_gap_tol: float = 1e-4
    infeas_feasibility_tol: float = 1e-4
    infeas_stable_feasibility_tol: float = 1e-8

    certificate_search: bool = True
    certificate_obj_tol: float = 1e-1
    certificate_fail_tol: float = 1e-8

    # Bounds on beta (kept for parity; unused by the reference loop too)
    min_beta: float = 1e-5
    max_beta: float = 1e5
    initial_beta: float = 1.0

    # Step-balance rule: "reference" = fire on the absolute tol_primal /
    # tol_dual gates (pdhg.jl:306-332); "ratio" = fire whenever one PPA
    # residual exceeds the other by step_balance_ratio (PDLP primal-weight
    # style; escapes the deadlock where both residuals sit just above
    # tolerance at a skewed ratio).
    # Default "ratio": 2.4x fewer iterations on mcp250-1 (981 iters vs
    # 2343) and rescues gpp500
    # (reference rule deadlocks at gap 1e-1).  Set "reference" for the
    # reference's exact behavior.
    step_balance: str = "ratio"
    step_balance_ratio: float = 10.0

    # Adaptive primal-dual step parameters (reference: src/options.jl:50-53)
    initial_adapt_level: float = 0.9
    adapt_decay: float = 0.8
    adapt_window: int = 50

    # PDHG parameters (reference: src/options.jl:55-63)
    convergence_window: int = 200
    convergence_check: int = 50
    max_iter: int = 0
    min_iter: int = 40
    divergence_min_update: int = 50
    max_iter_lp: int = 10_000_000
    max_iter_conic: int = 1_000_000

    advanced_initialization: bool = True

    # Linesearch parameters (reference: src/options.jl:67-72)
    line_search_flag: bool = True
    max_linsearch_steps: int = 5000
    delta: float = 0.9999
    initial_theta: float = 1.0
    linsearch_decay: float = 0.75

    # Spectral decomposition parameters (reference: src/options.jl:74-80)
    full_eig_decomp: bool = False
    max_target_rank_krylov_eigs: int = 16
    min_size_krylov_eigs: int = 100
    warm_start_eig: bool = True
    rank_increment: int = 1  # 0 = multiply, 1 = add
    rank_increment_factor: int = 1

    # eigsolver selection (reference: src/options.jl:82-89).  Here there is
    # a single engine: static-shape Lanczos with full reorthogonalization
    # (ops/lanczos.py).  1/2 both map to it; kept for parity.
    eigsolver: int = 2
    eigsolver_min_lanczos: int = 25
    eigsolver_resid_seed: int = 1234

    # ARPACK-era knobs (inert; the static-shape Lanczos is deterministic)
    arpack_tol: float = 1e-10
    arpack_resid_init: int = 3
    arpack_reset_resid: bool = True
    arpack_max_iter: int = 10_000

    # KrylovKit-era knobs (krylovkit_tol reused as the Lanczos residual
    # convergence tolerance; krylovkit_max_iter — the KrylovKit
    # restart cap, eigsolver.jl:807 — is inert here because the static-shape
    # Lanczos is single-pass by design: non-convergence falls back to eigh
    # instead of restarting)
    krylovkit_reset_resid: bool = False
    krylovkit_resid_init: int = 3
    krylovkit_tol: float = 1e-12
    krylovkit_max_iter: int = 100
    krylovkit_eager: bool = False
    krylovkit_verbose: int = 0

    # Rank reduction heuristic (inert in the reference as well)
    reduce_rank: bool = False
    rank_slack: int = 3

    # Periodic exact-projection pulse: for full_eig_len iterations out of
    # every full_eig_freq, force the dense-eigh projection regardless of
    # the Lanczos/subspace gating (reference src/prox_operators.jl:49).
    full_eig_freq: int = 10_000_000
    full_eig_len: int = 0

    # objective normalization (an extension, no reference
    # counterpart): solve min <c/||c||, x> and unscale duals/objectives on
    # the way out.  PDLP-style conditioning; without it, problems with
    # ||c|| >> ||b|| (SDPLIB theta/gpp) overshoot the cold-start dual by
    # ||c|| and stall the primal at 0 (theta2 was mis-declared infeasible).
    scale_objective: bool = True
    # rhs normalization companion (see SetupProblem.rhs_scale): b and h are
    # divided by ||[b; h]|| — exact for conic problems (cones are
    # scale-invariant).  randsdp's ||b||=806 needed 23k iterations
    # unscaled; with both scalings it solves in ~900.
    scale_rhs: bool = True

    # equilibration parameters (reference: src/options.jl:122-128)
    equilibration: bool = False
    equilibration_iters: int = 1000
    equilibration_lb: float = -10.0
    equilibration_ub: float = +10.0
    equilibration_limit: float = 0.9
    equilibration_force: bool = False
    # cone-safe block Ruiz equilibration (an extension; see
    # equilibration.block_equilibrate_host): rows scale freely, columns
    # uniformly per cone block.  For problems whose constraint-row norms
    # span decades (SDPLIB arch/control: spreads ~1e4, where the default
    # pipeline stalls at ~100% gap; measured spreads elsewhere <= 250).
    # True/False force it on/off.  "auto" PROBES: when the row-norm
    # spread exceeds block_equilibration_probe_spread, both
    # preconditioners race for block_equilibration_probe_iters
    # iterations through the same compiled program and the solve
    # continues (warm-started) with whichever made more progress — a
    # static spread gate cannot separate instances the scaling helps
    # from ones it hurts (measured: arch0 rescued, arch2 regressed, at
    # the SAME spread 1.96e4).  Takes precedence over `equilibration`
    # when on.
    block_equilibration: object = "auto"
    block_equilibration_iters: int = 10
    # hard gate used when probing is disabled (probe_spread <= 0):
    # "auto" then means spread > block_equilibration_spread
    block_equilibration_spread: float = 1e3
    block_equilibration_probe_spread: float = 3.0
    block_equilibration_probe_iters: int = 6000
    # the block-equilibrated arm must beat the default pipeline by this
    # factor to win the probe (measured: at 2500 iters arch2's arms score
    # within 1.2x of each other and the long-run winner is the default —
    # near-ties must not flip the pipeline)
    block_equilibration_probe_margin: float = 1.3

    # spectral norm: True = Frobenius upper bound (deterministic, default);
    # False = power-iteration 2-norm (reference uses ARPACK svds here)
    approx_norm: bool = True

    # ------------------------------------------------------------------
    # Extensions (no reference counterpart)
    # ------------------------------------------------------------------
    # Computation dtype: "float64" (default; accuracy parity with the
    # reference) or "float32".
    dtype: str = "float64"
    # Hybrid precision: when dtype="float64", run the loop in f32 until
    # gap/feasibility reach hybrid_switch_factor * tol, then hand the
    # state to the f64 program to finish.  The optimality decision is only
    # ever made by the f64 program, so accuracy semantics are unchanged;
    # f32 phase statuses (including infeasibility heuristics) are always
    # re-confirmed in f64.  What it saves over a pure-f64 solve is not yet
    # measured on the H100, where f64 is native.
    hybrid_precision: bool = True
    hybrid_switch_factor: float = 10.0
    # Tensor-parallel shard count for the PSD-block work (set by
    # parallel.sharded.solve_sharded; 0 = unsharded). Static: participates
    # in the compile cache key.
    tp_shards: int = 0
    # Batch/vmap subspace mode: apply the subspace reconstruction
    # unconditionally (NaN-guarded) instead of lax.cond-falling back to
    # dense eigh — under vmap cond becomes select, so the vmapped eigh
    # would run every iteration.  The host reseeds stale bases between
    # chunks (parallel/batch.py).
    subspace_accept_always: bool = False

    # Iterations executed per jitted chunk between host syncs (time-limit /
    # logging checks live on the host between chunks).
    chunk_iters: int = 0  # 0 = auto (max(convergence_check, 50))
    # Power-iteration steps used when approx_norm=False.
    power_iters: int = 50
    # Device operator form for M = [A; G]: "auto" picks per the policy in
    # ops/linop.py; "dense" | "ell" | "coo" force one.  Static (affects
    # the traced program).
    linop: str = "auto"
    # Use the low-rank Lanczos path when eligible (mirrors the reference's
    # krylov gating); set False to force dense eigh everywhere.
    use_lanczos: bool = True
    # Projection policy: for PSD blocks with side <= this, always use the
    # dense eigh (exact) projection.  The exact projection removes the
    # reference's +1-rank-per-window escalation phase (thousands of extra
    # iterations); the crossover against Lanczos is not yet measured on
    # the H100.  Set 0 to recover the reference's gating (Lanczos whenever
    # side > min_size_krylov_eigs and target_rank <=
    # max_target_rank_krylov_eigs).
    full_eig_max_side: int = 1024
    # Square-form device layout: store PSD blocks as full side*side
    # matrices on device, folding the reference's packed-triangle
    # isometry into A/G/c once on the host (problem.to_square_form).
    # The tri<->square index maps lower to gathers over the whole PSD
    # segment every iteration; the square layout replaces them with free
    # reshapes.  Exact unitary
    # change of coordinates — same objective, norms and duals.  Costs
    # ~2x HBM for the PSD segment of x (irrelevant at these sizes).
    # Driver-level knob: does not change the compiled program for a
    # given layout (the layout itself carries square_form).
    square_form: bool = True
    # Mixed-precision projection: in f32 programs, run the PSD eigh and
    # rank-k reconstruction in f64 and cast back.  The f32 eigh error
    # (~n*eps*lam_max, injected into x EVERY iteration) contributes to the
    # pure-f32 gap floor around 1e-3.  Default off; its cost and effect
    # are not yet measured on the H100.
    mixed_projection: bool = False
    # Warm-start the solver from a previous Result (closes the reference's
    # roadmap gap; README.md:145-148 lists warm start as future work).
    # Supplied per-call via solve(..., warm_start=...), not here.

    # Persistent-subspace Rayleigh-Ritz PSD projection (no reference
    # counterpart).  When subspace_rank = k > 0, PSD blocks with
    # side > 2k are projected via one warm subspace-iteration step per PDHG
    # iteration (CholeskyQR2 + k x k eigh — all matmuls) with a
    # residual-checked fallback to dense eigh that also reseeds the basis.
    # The hybrid driver turns this on automatically for the f64 polish
    # phase (see polish_subspace), sizing k from the rank the f32 phase
    # observed; set it explicitly to force the path everywhere.
    subspace_rank: int = 0
    # Relative Ritz-residual bound (vs the dominant eigenvalue) below which
    # a subspace projection is trusted unconditionally.
    subspace_tol: float = 1e-9
    # Force a dense-eigh reseed of the subspace basis every this many
    # iterations (0 = never).  Guards against a positive eigendirection
    # that sits outside the warm basis and is therefore invisible to the
    # Ritz-residual acceptance test; plays the role of the reference's
    # full_eig_freq/full_eig_len periodic exact projections
    # (src/prox_operators.jl:49).
    subspace_reseed_freq: int = 256
    # Relative-inexactness acceptance: additionally trust a subspace
    # projection whose positive-pair Ritz residual is below
    # subspace_rel_accept * (current combined PPA residual), capped at
    # subspace_accept_cap — projection error then decays in lockstep with
    # outer-loop progress (the reference paper's approximate-projection
    # principle, arXiv:1810.05231). 0 disables.
    subspace_rel_accept: float = 0.1
    subspace_accept_cap: float = 1e-3
    # Mixed-precision subspace projection (f64 programs only): build the
    # orthonormal basis (CholeskyQR2 + small eigh) in f32 matmuls, then
    # compute the Ritz values, the
    # acceptance residuals and the rank-k reconstruction in f64 on that
    # basis.  Rayleigh quotients are second-order accurate in the basis
    # error (f32 basis error ~1e-7 -> Ritz value error ~1e-14*scale), and
    # the f64 acceptance residual SEES the basis error, so an inadequate
    # f32 basis falls back to dense f64 eigh exactly like any other
    # rejected subspace — accuracy semantics are unchanged.
    # Matmul-only subspace step for f32 race programs: replace the k x k
    # Rayleigh-Ritz eigh(B) with a Newton-Schulz sign(B): in-span
    # projection (B + sign(B)B)/2, rank = trace((I+sign)/2), acceptance
    # on the aggregate positive-subspace residual.  Falls back exactly
    # like the eigh body (polar reseed / dense eigh).  Default off; not
    # yet measured on the H100.
    subspace_sign: bool = False
    subspace_mixed: bool = True
    # Unconditional acceptance floor for the mixed projection: an f32
    # basis cannot push the (f64-measured) Ritz residual below ~sqrt(side)
    # * eps_f32 * scale even when it spans the exact invariant subspace,
    # so the f64-mode subspace_tol (1e-9) would reject every step.  The
    # projection error this admits is f32-class (~1e-6 relative) — the
    # design point of mixed mode; min_eig / rank decisions stay f64.
    subspace_mixed_tol: float = 4e-6
    # Let the hybrid driver use the subspace projection for the f64 polish
    # phase (effective when dtype="float64" and hybrid_precision).
    polish_subspace: bool = True
    # Also enter subspace mode during the f32 race phase: after
    # race_subspace_warmup iterations of dense-eigh cold start the driver
    # estimates the rank (host eigh), seeds an exact top-k basis and
    # re-enters a subspace-mode f32 program (the subspace step is matmuls
    # where the dense path runs an eigh every iteration).
    race_subspace: bool = True
    race_subspace_warmup: int = 100
    # PSD projection engine for the dense (non-subspace) path:
    #   "auto"  — dense eigh, except the hybrid driver switches the f32
    #             race program to "polar" for sides >= polar_min_side
    #   "eigh"  — always the dense eigenvalue projection
    #   "polar" — matmul-only Newton-Schulz matrix-sign projection
    #             (ops/cones.py:polar_psd): fixed ~(3*polar_aggressive +
    #             2*polar_polish + 1) matmuls, whatever the spectrum.
    #             Inexact below ~9e-5 * ||X||_F with the default schedule
    #             — race-phase accuracy class; the f64 phase re-projects.
    projection: str = "auto"
    polar_aggressive: int = 7  # quintic steps (small-eig growth ~3.44x)
    polar_polish: int = 4  # cubic Newton-Schulz steps (quadratic finish)
    # below this side the dense eigh is used (crossover not yet measured
    # on the H100)
    polar_min_side: int = 100
    # Subspace-mode rejected-step fallback: "eigh" (dense eigenvalue
    # reseed — exactness anchor, default; the f64 polish keeps this) or
    # "polar" (Newton-Schulz sign projector rebuilds the basis + fresh
    # Rayleigh-Ritz — matmul-only; the hybrid driver sets this for the
    # f32 race program when projection="auto").
    subspace_fallback: str = "eigh"
    # Side threshold for the f64 polish: above this side the polish's
    # rejected-step fallback switches from the dense f64 eigh (O(side^3)
    # per rejected iteration) to the f32 polar reseed, and the returned X
    # is exactly-projected on the host instead.  Not yet measured on the
    # H100.  Interacts with full_eig_max_side as
    # min(full_eig_max_side, polar_fallback_min_side) — raising
    # full_eig_max_side alone will not re-enable big dense eighs.
    polar_fallback_min_side: int = 384
    # Guard width added to the observed rank when the driver sizes the
    # polish subspace.
    polish_subspace_guard: int = 8
    # Step-machinery restart on a stalled f64 polish (the "[polish] stall"
    # watchdog).  Off = the polish keeps its adaptive steps no matter how
    # long the metric stalls (diagnostic knob: on SDPLIB arch0 repeated
    # step restarts destabilized the iterate outright, round 5).
    polish_restart: bool = True

    # Adaptive restart-to-average (no reference counterpart —
    # upstream PDHG has no restarts).  PDLP-style: the loop maintains
    # step-weighted running averages of (x, y, Mx, Mty); when the duality
    # gap fails to shrink by restart_decay over restart_window iterations
    # while still above tol_gap, the iterates are reset to the running
    # average (Mx/Mty averages make this free of extra matvecs — the
    # operator is linear) and the averages restart.  Targets PDHG's 1/k
    # last-iterate tail on badly scaled instances (the gpp family stalls
    # at gap ~1e-3 for tens of thousands of iterations without it).
    # DEFAULT ON (round 5): fixes the degenerate-dual gap floor on MIMO
    # (10302 active-but-zero-dual box rows each carrying ~1e-6 positivity
    # noise -> h'y error ~0.05 -> relative gap floored at ~0.07 forever;
    # with restarts the adopted average's dual noise decays ~1/k and
    # MIMO n=50 solves to rank 1), solves control1/2 jointly with block
    # equilibration, and is adoption-gated so converging instances are
    # unaffected (the average is only adopted when it measurably beats
    # the current iterate).
    restart: str = "adaptive"  # "none" | "adaptive"
    restart_window: int = 500
    restart_decay: float = 0.8
    # Stall metric for the restart epoch test: "gap" (duality gap only)
    # or "kkt" (max(gap, feasibility), PDLP-style).  Measured (r5):
    # kkt solves control1 but destabilizes arch0/arch4 into false
    # INFEASIBLE declarations; gap is the conservative default.
    restart_trigger: str = "gap"

    # Checkpoint/resume (no reference counterpart — SURVEY.md §5 lists
    # checkpointing as absent upstream).  When checkpoint_path is set, the
    # full solver state is written there atomically every
    # checkpoint_freq iterations (at chunk boundaries); resume with
    # solve(..., resume_from=path).
    checkpoint_path: str = ""
    checkpoint_freq: int = 0  # iterations between saves; 0 = off

    def __post_init__(self):
        if self.dtype not in ("float64", "float32"):
            raise ValueError(f"dtype must be float64|float32, got {self.dtype}")
        if self.restart not in ("none", "adaptive"):
            raise ValueError(f"restart must be none|adaptive, got {self.restart}")
        if self.restart_trigger not in ("gap", "kkt"):
            raise ValueError(
                f"restart_trigger must be gap|kkt, got {self.restart_trigger}"
            )
        if isinstance(self.block_equilibration, str):
            # accept option-string spellings ("True"/"false"/"on"/"0" via
            # CLI --opt plumbing); the dataclass is frozen, so coerce
            # through object.__setattr__
            low = self.block_equilibration.lower()
            if low != "auto":
                if low not in ("1", "true", "yes", "on",
                               "0", "false", "no", "off"):
                    raise ValueError(
                        "block_equilibration must be True|False|'auto', "
                        f"got {self.block_equilibration!r}"
                    )
                object.__setattr__(
                    self, "block_equilibration",
                    low in ("1", "true", "yes", "on"),
                )
        elif self.block_equilibration not in (True, False):
            raise ValueError(
                "block_equilibration must be True|False|'auto', got "
                f"{self.block_equilibration!r}"
            )

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    @property
    def max_iter_local(self) -> Optional[int]:
        # resolved at solve time (depends on whether cones are present)
        return None


_FIELD_NAMES = {f.name for f in dataclasses.fields(Options)}


def make_options(**kwargs) -> Options:
    """Build Options, erroring on unknown names.

    Mirrors the reference's reflection-based raw-attribute setting
    (src/MOI_wrapper.jl:84-103): unknown option names are an error.
    """
    unknown = set(kwargs) - _FIELD_NAMES
    if unknown:
        raise ValueError(f"Unknown option(s): {sorted(unknown)}")
    return Options(**kwargs)
