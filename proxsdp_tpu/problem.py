"""Conic problem IR and host-side preprocessing.

Problem form (identical to the reference, SURVEY.md §0):

    min  c'x   s.t.  A x = b  (p equalities),  G x <= h  (m inequalities),
                     x in K = (scaled PSD triangle cones) x (SOCs) x (free)

``ConicProblem`` is the user-facing container (NumPy / SciPy-sparse).
``preprocess`` performs the cone-first variable permutation
(reference: src/scaling.jl:2-26) and the sqrt(2) off-diagonal triangle scaling
(reference: src/scaling.jl:28-58), returning a ``SetupProblem`` whose static
``ConeLayout`` drives jit compilation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

try:  # scipy ships with jax; used only host-side for sparse assembly
    import scipy.sparse as _sp
except Exception:  # pragma: no cover
    _sp = None

from .utils.vech import offdiag_mask_tri, sympackeddim, sympackedlen


@dataclasses.dataclass(frozen=True)
class ConeLayout:
    """Static (hashable) description of the permuted variable layout.

    After preprocessing, variables are ordered: SDP blocks (packed triangles,
    in declaration order), then SOC blocks, then free variables — each block
    contiguous.  This makes every cone projection a static-offset slice.
    """

    n: int  # total primal variables
    p: int  # number of equalities
    m: int  # number of inequalities
    sdp_sides: tuple  # matrix side per PSD block
    soc_lens: tuple  # length per SOC block (s + v)
    # square-form device layout: PSD blocks stored as FULL side*side
    # matrices (row-major) instead of packed scaled triangles.  The packed
    # triangle is the reference's layout; on device the tri<->square
    # index maps lower to gathers over the whole PSD segment every
    # iteration.  The square layout is
    # an exact isometric change of coordinates (off-diagonal pair (X_ij,
    # X_ji) <-> sqrt(2)*X_ij), applied to A/G/c once on the host
    # (to_square_form), so the device loop never touches an index map.
    square_form: bool = False

    @property
    def sdp_tri_lens(self):
        return tuple(sympackedlen(s) for s in self.sdp_sides)

    @property
    def sdp_blk_lens(self):
        """Stored length per PSD block under this layout."""
        if self.square_form:
            return tuple(s * s for s in self.sdp_sides)
        return self.sdp_tri_lens

    @property
    def sdp_offsets(self):
        offs, o = [], 0
        for t in self.sdp_blk_lens:
            offs.append(o)
            o += t
        return tuple(offs)

    @property
    def soc_offsets(self):
        o = sum(self.sdp_blk_lens)
        offs = []
        for l in self.soc_lens:
            offs.append(o)
            o += l
        return tuple(offs)

    @property
    def cone_dim(self):
        return sum(self.sdp_blk_lens) + sum(self.soc_lens)

    @property
    def n_free(self):
        return self.n - self.cone_dim

    @property
    def n_tri(self):
        """Variable count of the tri-packed equivalent layout (the
        reference's coordinate count — used for residual scaling parity)."""
        if not self.square_form:
            return self.n
        return self.n - sum(self.sdp_blk_lens) + sum(self.sdp_tri_lens)


class ConicProblem:
    """User-facing conic problem (host-side, NumPy/SciPy).

    Parameters
    ----------
    c : (n,) objective vector (minimization).
    A, b : equality constraints A x = b; A is (p, n) dense or scipy-sparse.
    G, h : inequality constraints G x <= h; G is (m, n) dense or scipy-sparse.
    sdp_vars : per PSD block, the indices into x holding the packed upper
        triangle (column-major, MOI order).  Entries across all cones must be
        disjoint (the reference requires the same; MOI bridges add equalities
        for shared variables, reference src/structs.jl:36 'extra').
    soc_vars : per SOC block, the indices into x: first entry is s, the rest v.
    objective_sense : "min" (default) or "max" — with "max", c is the vector
        being maximized (sign handled internally, reference
        src/MOI_wrapper.jl:247-254).
    objective_constant : added to the reported objective value.
    """

    def __init__(
        self,
        c,
        A=None,
        b=None,
        G=None,
        h=None,
        sdp_vars: Sequence = (),
        soc_vars: Sequence = (),
        objective_sense: str = "min",
        objective_constant: float = 0.0,
    ):
        c = np.asarray(c, dtype=np.float64).ravel()
        n = c.shape[0]
        if A is None:
            A = np.zeros((0, n))
            b = np.zeros((0,))
        if G is None:
            G = np.zeros((0, n))
            h = np.zeros((0,))
        b = np.asarray(b, dtype=np.float64).ravel()
        h = np.asarray(h, dtype=np.float64).ravel()
        if objective_sense not in ("min", "max"):
            raise ValueError("objective_sense must be 'min' or 'max'")

        self.n = n
        self.A = A
        self.G = G
        self.b = b
        self.h = h
        self.c = c
        self.sdp_vars = [np.asarray(v, dtype=np.int64).ravel() for v in sdp_vars]
        self.soc_vars = [np.asarray(v, dtype=np.int64).ravel() for v in soc_vars]
        self.objective_sense = objective_sense
        self.objective_constant = float(objective_constant)

        for v in self.sdp_vars:
            sympackeddim(len(v))  # validates triangular length
        all_cone = (
            np.concatenate(self.sdp_vars + self.soc_vars)
            if (self.sdp_vars or self.soc_vars)
            else np.zeros(0, np.int64)
        )
        if len(np.unique(all_cone)) != len(all_cone):
            raise ValueError(
                "cone variable index lists must be disjoint "
                "(introduce duplicate variables + equality constraints instead)"
            )
        if all_cone.size and (all_cone.min() < 0 or all_cone.max() >= n):
            raise ValueError("cone variable index out of range")

    @property
    def p(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.G.shape[0]

    @property
    def sdp_sides(self):
        return tuple(sympackeddim(len(v)) for v in self.sdp_vars)

    @property
    def soc_lens(self):
        return tuple(len(v) for v in self.soc_vars)


@dataclasses.dataclass
class SetupProblem:
    """Preprocessed problem: permuted + scaled, ready for the solver core.

    ``A_orig/G_orig/b_orig/h_orig/c_orig`` are the *permuted but unscaled*
    copies kept for solution recovery and dual-feasibility checks
    (reference: src/pdhg.jl:58-62).
    """

    layout: ConeLayout
    # scaled operands fed to the device loop
    A: object
    G: object
    b: np.ndarray
    h: np.ndarray
    c: np.ndarray
    # unscaled copies (post-permutation)
    A_orig: object
    G_orig: object
    b_orig: np.ndarray
    h_orig: np.ndarray
    c_orig: np.ndarray
    var_ordering: np.ndarray  # inverse permutation back to user order
    norm_b: float
    norm_h: float
    norm_c: float
    objective_sense: str = "min"
    objective_constant: float = 0.0
    # PDLP-style data conditioning (no reference counterpart; the
    # reference inherits both imbalances):
    # * obj_scale:  the device solves min <c/obj_scale, x>; duals and
    #   objective values are multiplied back on the way out.  SDPLIB's
    #   theta/gpp families carry ||c|| ~ 1e2-1e3 against ||b|| = 1, which
    #   makes the cold-start dual overshoot by that factor and stall the
    #   primal at 0 for thousands of iterations (theta2 was mis-declared
    #   infeasible without it).
    # * rhs_scale:  b and h are divided by ||[b; h]||; the cones are
    #   scale-invariant so the solver's x is exactly x_user / rhs_scale.
    #   randsdp (||b||=806) needed 23k iterations unscaled and diverged
    #   with c-scaling alone; with both scalings it solves in 913.
    obj_scale: float = 1.0
    rhs_scale: float = 1.0


def _colscale(M, scale: np.ndarray):
    """Return M with columns scaled (dense or scipy-sparse)."""
    if _sp is not None and _sp.issparse(M):
        return (M @ _sp.diags(scale)).tocsc()
    return np.asarray(M) * scale[None, :]


def _tocsc(M):
    if _sp is not None and _sp.issparse(M):
        return M.tocsc()
    return np.asarray(M, dtype=np.float64)


def preprocess(
    problem: ConicProblem,
    *,
    scale_objective: bool = True,
    scale_rhs: bool = True,
) -> SetupProblem:
    """Cone-first permutation + sqrt(2) triangle scaling.

    Mirrors reference preprocess! (src/scaling.jl:2-26) and norm_scaling
    (src/scaling.jl:28-58) as pure index/column transforms applied once on
    the host — nothing dynamic remains for the device loop.  On top of the
    reference's transforms, the objective is normalized to unit 2-norm
    (``scale_objective``, see SetupProblem.obj_scale).
    """
    n = problem.n
    cone_vars = problem.sdp_vars + problem.soc_vars
    if cone_vars:
        all_cone = np.concatenate(cone_vars)
        mask = np.ones(n, dtype=bool)
        mask[all_cone] = False
        extra = np.nonzero(mask)[0]
        ord_ = np.concatenate([all_cone, extra])
    else:
        ord_ = np.arange(n)
    var_ordering = np.argsort(ord_, kind="stable")

    A = _tocsc(problem.A)[:, ord_]
    G = _tocsc(problem.G)[:, ord_]
    c = problem.c[ord_]

    layout = ConeLayout(
        n=n,
        p=problem.p,
        m=problem.m,
        sdp_sides=problem.sdp_sides,
        soc_lens=problem.soc_lens,
    )

    # norms of the ORIGINAL (pre-scaling) data; reference computes them at
    # the very top of chambolle_pock (src/pdhg.jl:14-16)
    norm_b = float(np.linalg.norm(problem.b)) if problem.p else 0.0
    norm_h = float(np.linalg.norm(problem.h)) if problem.m else 0.0
    norm_c = float(np.linalg.norm(problem.c))

    A_orig, G_orig = A.copy(), G.copy()
    b_orig, h_orig, c_orig = problem.b.copy(), problem.h.copy(), c.copy()

    # sqrt(2)/2 scaling of off-diagonal triangle columns (scaling.jl:28-58)
    scale = np.ones(n)
    cte = np.sqrt(2.0) / 2.0
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        mask_off = offdiag_mask_tri(side)
        scale[off : off + sympackedlen(side)] = np.where(mask_off, cte, 1.0)
    A_s = _colscale(A, scale) if problem.p else A
    G_s = _colscale(G, scale) if problem.m else G
    c_s = c * scale

    obj_scale = 1.0
    if scale_objective and norm_c > 1e-12:
        obj_scale = norm_c
        c_s = c_s / obj_scale

    rhs_norm = float(np.hypot(norm_b, norm_h))
    rhs_scale = 1.0
    if scale_rhs and rhs_norm > 1e-12:
        rhs_scale = rhs_norm

    return SetupProblem(
        layout=layout,
        A=A_s,
        G=G_s,
        b=problem.b / rhs_scale,
        h=problem.h / rhs_scale,
        c=c_s,
        A_orig=A_orig,
        G_orig=G_orig,
        b_orig=b_orig,
        h_orig=h_orig,
        c_orig=c_orig,
        var_ordering=var_ordering,
        norm_b=norm_b / rhs_scale,
        norm_h=norm_h / rhs_scale,
        norm_c=norm_c / obj_scale,
        objective_sense=problem.objective_sense,
        objective_constant=problem.objective_constant,
        obj_scale=obj_scale,
        rhs_scale=rhs_scale,
    )


# ---------------------------------------------------------------------------
# Square-form device layout (see ConeLayout.square_form)
# ---------------------------------------------------------------------------

import functools as _functools

from .utils.vech import tri_ij as _tri_ij


@_functools.lru_cache(maxsize=32)
def square_embed_matrix(layout: ConeLayout):
    """The isometry S mapping scaled-tri coordinates to square-form
    coordinates, as a scipy CSR matrix of shape (n_sq, n_tri).

    Per PSD block: diagonal tri entry k=(i,i) -> square (i,i) with 1.0;
    off-diagonal tri entry k=(i,j), i<j (holding sqrt(2)*X_ij) -> square
    (i,j) and (j,i), each with 1/sqrt(2).  SOC/free tail: identity.
    S'S = I on tri space, so the change of coordinates is exact:
    ||Sv|| = ||v||, M_sq = M S' has the same Frobenius/spectral norms,
    and c_sq'x_sq = c'v for x_sq = Sv.

    ``layout`` must be the TRI layout (square_form=False).
    """
    assert not layout.square_form
    if _sp is None:  # pragma: no cover - scipy ships with jax
        raise RuntimeError("square-form layout requires scipy")
    n_tri = layout.n
    n_sq = n_tri - sum(layout.sdp_tri_lens) + sum(
        s * s for s in layout.sdp_sides
    )
    rows, cols, vals = [], [], []
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    os_ = 0
    for ot, side in zip(layout.sdp_offsets, layout.sdp_sides):
        i, j = _tri_ij(side)  # upper triangle, column-major (i <= j)
        tl = sympackedlen(side)
        for k in range(tl):
            ik, jk = int(i[k]), int(j[k])
            if ik == jk:
                rows.append(os_ + ik * side + jk)
                cols.append(ot + k)
                vals.append(1.0)
            else:
                rows.append(os_ + ik * side + jk)
                cols.append(ot + k)
                vals.append(inv_sqrt2)
                rows.append(os_ + jk * side + ik)
                cols.append(ot + k)
                vals.append(inv_sqrt2)
        os_ += side * side
    # SOC + free tail: identity
    ot = sum(layout.sdp_tri_lens)
    tail = n_tri - ot
    for t in range(tail):
        rows.append(os_ + t)
        cols.append(ot + t)
        vals.append(1.0)
    S = _sp.csr_matrix(
        (np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
        shape=(n_sq, n_tri),
    )
    return S


def to_square_form(setup: SetupProblem) -> SetupProblem:
    """Return a SetupProblem whose DEVICE operands (A, G, c, layout) are in
    square-form coordinates.  Host-recovery fields (*_orig, var_ordering,
    scales) are kept in tri space — solution recovery converts the iterate
    back with ``square_embed_matrix(tri_layout).T`` once.
    """
    layout = setup.layout
    if layout.square_form or not layout.sdp_sides:
        return setup
    S = square_embed_matrix(layout)
    layout_sq = dataclasses.replace(
        layout, n=S.shape[0], square_form=True
    )
    def conv(M, rows):
        if not rows:
            return np.zeros((0, S.shape[0]))
        out = _tocsc(M) @ S.T
        return out.tocsc() if _sp.issparse(out) else np.asarray(out)

    A_sq = conv(setup.A, layout.p)
    G_sq = conv(setup.G, layout.m)
    c_sq = S @ setup.c
    return dataclasses.replace(
        setup, layout=layout_sq, A=A_sq, G=G_sq, c=c_sq
    )


