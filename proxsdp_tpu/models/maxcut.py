"""Max-cut SDP relaxation (reference: README.md:58-113, examples/jump.jl).

    max  0.25 * <W, X>   s.t.  diag(X) = 1,  X psd.
"""

from __future__ import annotations

import numpy as np

from ..api import Optimizer
from ..options import Options
from ..problem import ConicProblem
from ..utils.vech import sympackedlen, tri_ij


def maxcut_problem(W: np.ndarray, options: Options | None = None) -> tuple:
    """Build the max-cut relaxation; returns (problem, Xidx)."""
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    opt = Optimizer(options)
    X = opt.add_psd_var(n)
    for i in range(n):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * W), sense="max")
    return opt.build_problem(), X


def maxcut_matrices(W: np.ndarray):
    """Raw (c, A, b) in scaled-triangle variable space for BATCHED solving.

    All max-cut instances of the same side share A and b; only c differs —
    which is what makes a 1024-instance sweep a single vmapped solve.
    Returns (c_tri, A, b) where variables are raw triangle entries.
    """
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    tl = sympackedlen(n)
    i, j = tri_ij(n)
    # minimization vector for "max 0.25<W,X>": c = -0.25 * (2 - diag) * W_ij
    mult = np.where(i == j, 1.0, 2.0)
    c = -0.25 * mult * W[i, j]
    A = np.zeros((n, tl))
    diag_pos = (j * (j + 1)) // 2 + i
    for d in range(n):
        A[d, (d * (d + 1)) // 2 + d] = 1.0
    b = np.ones(n)
    return c, A, b


def random_graph_weights(seed: int, n: int, density: float = 0.5) -> np.ndarray:
    """Random symmetric weight matrix for benchmark sweeps."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(n, n) < density
    Wu = np.triu(rng.randn(n, n) * mask, 1)
    return Wu + Wu.T


def maxcut_certificate(W, X, y) -> tuple[float, float, float]:
    """Bounds on the max-cut SDP optimum from a solution, independent of
    the solver's own gap (host NumPy, f64).

    Lower bound L: project X onto the PSD cone, rescale it to unit
    diagonal (X̂ = D^-1/2 X+ D^-1/2, a zero diagonal entry becomes 1),
    and take the objective 1/4 <W, X̂> of that feasible point.
    Upper bound U: any y gives the dual-feasible y + t 1 with
    t = max(0, lambda_max(W/4 - Diag(y))), so U(y) = sum(y) + n t; the
    smaller of U(y) and U(-y) is used, so the dual sign convention cannot
    fool the check.

    Returns (L, U, (U - L) / |L|).
    """
    W = np.asarray(W, np.float64)
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64).ravel()
    n = W.shape[0]
    w, V = np.linalg.eigh(0.5 * (X + X.T))
    Xp = (V * np.maximum(w, 0.0)) @ V.T
    d = np.diag(Xp)
    s = np.where(d > 0.0, 1.0 / np.sqrt(np.where(d > 0.0, d, 1.0)), 0.0)
    Xh = s[:, None] * Xp * s[None, :]
    np.fill_diagonal(Xh, 1.0)
    lower = 0.25 * float(np.sum(W * Xh))

    def upper_of(yv):
        lam = np.linalg.eigvalsh(0.25 * W - np.diag(yv))[-1]
        return float(np.sum(yv) + n * max(0.0, lam))

    upper = min(upper_of(y), upper_of(-y))
    return lower, upper, (upper - lower) / max(abs(lower), 1e-300)


def solve_maxcut(W, options: Options | None = None, **kwargs):
    """Solve one max-cut relaxation; returns (X, result)."""
    from ..solver import solve

    problem, Xidx = maxcut_problem(W, options)
    if kwargs:
        options = (options or Options()).replace(**kwargs)
    res = solve(problem, options)
    return res.primal[Xidx], res
