"""Ruiz-style diagonal equilibration (reference: src/equilibration.jl:1-78).

Projected-averaged stochastic-gradient scheme over E*M*D with
exp-parameterized diagonals.  This is one-shot host-side preprocessing
(reference runs it once before the loop, pdhg.jl:64-92), so it is NumPy —
the device never sees unequilibrated data.

Reference quirks reproduced faithfully:
* the column scaling v is collapsed to its mean each iteration
  (equilibration.jl:56-58), making D a positive scalar multiple of I;
* the averaged iterates (u_, v_) produce the final E, D;
* gating: skipped unless min(M)/max(M) > equilibration_limit
  (pdhg.jl:67-73) — i.e. practically only for all-positive matrices —
  unless equilibration_force is set.

Deviation from the reference: we equilibrate the already sqrt(2)-scaled M
(the reference scales in the other order).  Because D is a scalar multiple
of the identity it commutes with the triangle scaling, so only E's value
differs slightly — same fixed point semantics, documented here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .utils.vech import sympackedlen


class Equilibration(NamedTuple):
    E: np.ndarray  # row scaling (p+m,)
    D: np.ndarray  # column scaling (n,)


def block_equilibrate_host(setup, opts):
    """Cone-safe Ruiz equilibration (an extension, no reference
    counterpart; ROADMAP §3).

    Classic Ruiz alternates row/column inf-norm scalings, but an
    arbitrary per-column D is invalid for conic variables: the solver
    would project onto K while the preconditioned problem needs
    D^{-1}K.  This variant restricts D to be UNIFORM WITHIN EACH CONE
    BLOCK — X -> aX preserves PSD-ness and (t,v) -> a(t,v) preserves the
    SOC — while free variables scale individually and rows (E) scale
    freely.  Targets problems whose constraint-row norms span decades
    (SDPLIB arch/control), where the reference's scalar-D scheme
    (equilibrate!'s column-mean collapse, equilibration.jl:56-58) cannot
    help.

    Mutates ``setup`` like :func:`equilibrate_host` and returns the same
    :class:`Equilibration` (the solver's undo path is shared).  Norms
    ``norm_b/h/c`` are recomputed post-scaling so relative residuals
    measure the problem the device actually solves.
    """
    import scipy.sparse as sp

    from .ops.linop import stack_vertical

    M = stack_vertical(setup.A, setup.G)
    pm, n = M.shape
    if pm == 0 or n == 0:
        return None
    Ms = sp.csr_matrix(M, dtype=np.float64)

    layout = setup.layout
    # block id per column: PSD blocks, then SOC blocks, then free vars
    # (free vars get singleton blocks = unrestricted scaling)
    block_of = np.zeros(n, np.int64)
    nb = 0
    pos = 0
    for t in (sympackedlen(s) for s in layout.sdp_sides):
        block_of[pos:pos + t] = nb
        nb += 1
        pos += t
    for ln in layout.soc_lens:
        block_of[pos:pos + ln] = nb
        nb += 1
        pos += ln
    for i in range(pos, n):
        block_of[i] = nb
        nb += 1

    E = np.ones(pm)
    D = np.ones(n)
    for _ in range(max(int(opts.block_equilibration_iters), 1)):
        S = sp.diags(E) @ Ms @ sp.diags(D)
        Sa = abs(S)
        r = np.asarray(Sa.max(axis=1).todense()).ravel()
        r[r == 0] = 1.0
        E /= np.sqrt(r)
        c = np.asarray(Sa.max(axis=0).todense()).ravel()
        # cone-safety: one factor per block (the block's max column norm)
        cb = np.zeros(nb)
        np.maximum.at(cb, block_of, c)
        cb[cb == 0] = 1.0
        D /= np.sqrt(cb[block_of])

    lb, ub = np.exp(opts.equilibration_lb), np.exp(opts.equilibration_ub)
    np.clip(E, lb, ub, out=E)
    np.clip(D, lb, ub, out=D)

    p_ = layout.p
    if sp.issparse(setup.A):
        setup.A = (sp.diags(E[:p_]) @ setup.A @ sp.diags(D)).tocsc()
        setup.G = (sp.diags(E[p_:]) @ setup.G @ sp.diags(D)).tocsc()
    else:
        setup.A = E[:p_, None] * setup.A * D[None, :]
        setup.G = E[p_:, None] * setup.G * D[None, :]
    setup.b = E[:p_] * setup.b
    setup.h = E[p_:] * setup.h
    setup.c = D * setup.c
    # norm_b/h/c stay at their PRE-equilibration values: the device
    # measures feasibility in user units (row_unscale operand), so the
    # denominators must be user-unit norms too
    return Equilibration(E=E, D=D)


def equilibrate_host(setup, opts):
    """Apply E M D preconditioning to a SetupProblem in place.

    Returns Equilibration or None when gated off.
    """
    from .ops.linop import stack_vertical

    M = stack_vertical(setup.A, setup.G)
    sparse = hasattr(M, "toarray")
    Md = M.toarray() if sparse else np.asarray(M, dtype=np.float64)
    pm, n = Md.shape
    if pm == 0 or n == 0:
        return None

    if not opts.equilibration_force:
        UB = Md.max()
        LB = Md.min()
        if UB == 0 or LB / UB <= opts.equilibration_limit:
            return None

    alpha2 = np.sqrt(n / pm)
    beta2 = np.sqrt(pm / n)
    gamma = 0.1
    lb, ub = opts.equilibration_lb, opts.equilibration_ub

    u = np.zeros(pm)
    v = np.zeros(n)
    u_avg = np.zeros(pm)
    v_avg = np.zeros(n)
    M2 = Md * Md

    for it in range(opts.equilibration_iters):
        E2 = np.exp(2 * u)
        D2 = np.exp(2 * v)
        # row/col squared norms of E M D without forming it
        row_norms = E2 * (M2 @ D2)
        col_norms = D2 * (M2.T @ E2)
        step = 2.0 / (gamma * (it + 1.0))
        u = np.clip(u - step * (row_norms - alpha2 + gamma * u), lb, ub)
        v = v - step * (col_norms - beta2 + gamma * v)
        v[:] = v.sum() / n  # reference collapses columns to their mean
        np.clip(v, 0.0, ub, out=v)
        u_avg = 2 * u / (it + 2.0) + it * u_avg / (it + 2.0)
        v_avg = 2 * v / (it + 2.0) + it * v_avg / (it + 2.0)

    E = np.exp(u_avg)
    D = np.exp(v_avg)

    p_ = setup.layout.p
    if sparse:
        import scipy.sparse as sp

        setup.A = (sp.diags(E[:p_]) @ setup.A @ sp.diags(D)).tocsc()
        setup.G = (sp.diags(E[p_:]) @ setup.G @ sp.diags(D)).tocsc()
    else:
        setup.A = E[:p_, None] * setup.A * D[None, :]
        setup.G = E[p_:, None] * setup.G * D[None, :]
    setup.b = E[:p_] * setup.b
    setup.h = E[p_:] * setup.h
    setup.c = D * setup.c
    return Equilibration(E=E, D=D)
