"""Linear operator M = [A; G] for the PDHG loop.

The reference stores M and M' as sparse CSC and applies BLAS-backed
``mul!`` (src/structs.jl:153-157, src/pdhg.jl:104-128).  Here we pick, at
setup time, between:

* ``DenseOp`` — a dense (p+m, n) array; matvec/rmatvec are matmuls.
  For small or dense matrices; XLA fuses the adjacent axpy/projection
  elementwise work around the matmul.
* ``EllOp`` — per-row and per-column padded gather tables; both products
  are gather + dense reduction.  For very sparse matrices.
* ``CooOp`` — padded COO triples; matvec = segment-sum of vals*x[cols]
  (rows pre-sorted so XLA lowers to a cheap sorted-segment reduction),
  rmatvec = scatter-add.  For SDPLIB-style constraints (p+m << n, a handful
  of nnz per row) this keeps device-memory traffic proportional to nnz.

Both are registered as pytrees so they can ride through jit as operands
(no recompilation when values change, only when shapes change).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

try:
    import scipy.sparse as _sp
except Exception:  # pragma: no cover
    _sp = None


@jax.tree_util.register_pytree_node_class
class DenseOp:
    def __init__(self, mat):
        self.mat = mat

    @property
    def shape(self):
        return self.mat.shape

    # precision: the PDHG fixed-point map needs true-f32 products (a
    # reduced-precision pass floors the f32 race phase at ~1e-3
    # residuals); the chunk programs trace under full-f32 matmul
    # precision (solver.FULL_F32), which covers these dots.
    def matvec(self, x):
        return self.mat @ x

    def rmatvec(self, y):
        return self.mat.T @ y

    def frobenius_norm(self):
        return jnp.sqrt(jnp.sum(self.mat * self.mat))

    def tree_flatten(self):
        return (self.mat,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class CooOp:
    """Padded COO operator; rows sorted ascending, padding has val=0.

    Padding entries point at row p+m-? -> we pad with (row=nrows-1... no:
    padding uses row=nrows, clipped by segment_sum's num_segments, and
    col=0 with val=0, so they contribute nothing to either product.
    """

    def __init__(self, rows, cols, vals, nrows: int, ncols: int):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.nrows = nrows
        self.ncols = ncols

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def matvec(self, x):
        prod = self.vals * x[self.cols]
        return jax.ops.segment_sum(
            prod, self.rows, num_segments=self.nrows, indices_are_sorted=True
        )

    def rmatvec(self, y):
        contrib = self.vals * y.at[self.rows].get(mode="fill", fill_value=0.0)
        out = jnp.zeros((self.ncols,), dtype=self.vals.dtype)
        return out.at[self.cols].add(contrib)

    def frobenius_norm(self):
        return jnp.sqrt(jnp.sum(self.vals * self.vals))

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (self.nrows, self.ncols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0], aux[1])


@jax.tree_util.register_pytree_node_class
class EllOp:
    """ELLPACK operator: per-row and per-column padded index/value tables.

    Both products are gather + dense reduction — no scatter, no
    segment-sum — for the very sparse constraint matrices SDP problems
    carry (diag(X)=1 rows have one nonzero).  Padding entries point at
    index 0 with value 0.
    """

    def __init__(self, row_cols, row_vals, col_rows, col_vals):
        self.row_cols = row_cols  # (nrows, r) int32
        self.row_vals = row_vals  # (nrows, r)
        self.col_rows = col_rows  # (ncols, c) int32
        self.col_vals = col_vals  # (ncols, c)

    @property
    def shape(self):
        return (self.row_cols.shape[0], self.col_rows.shape[0])

    def matvec(self, x):
        return jnp.sum(self.row_vals * x[self.row_cols], axis=1)

    def rmatvec(self, y):
        return jnp.sum(self.col_vals * y[self.col_rows], axis=1)

    def frobenius_norm(self):
        return jnp.sqrt(jnp.sum(self.row_vals * self.row_vals))

    def tree_flatten(self):
        return (self.row_cols, self.row_vals, self.col_rows, self.col_vals), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _build_ell(rows, cols, vals, nrows, ncols, dtype, max_width=32):
    """Build EllOp tables, or None if a row/col is too dense."""

    def tables(keys, others, vals, nkeys):
        counts = np.bincount(keys, minlength=nkeys)
        width = int(counts.max()) if len(counts) else 0
        width = max(width, 1)
        if width > max_width:
            return None
        idx = np.zeros((nkeys, width), np.int32)
        val = np.zeros((nkeys, width))
        # vectorized fill: sort by key, slot = rank within the key's run
        # (the Python-loop version cost seconds at SDPLIB-tail nnz ~1e6)
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        starts = np.searchsorted(ks, np.arange(nkeys), side="left")
        slot = np.arange(len(ks)) - starts[ks]
        idx[ks, slot] = others[order]
        val[ks, slot] = vals[order]
        return idx, val

    t_row = tables(rows, cols, vals, nrows)
    t_col = tables(cols, rows, vals, ncols)
    if t_row is None or t_col is None:
        return None
    return EllOp(
        jnp.asarray(t_row[0]),
        jnp.asarray(t_row[1], dtype=dtype),
        jnp.asarray(t_col[0]),
        jnp.asarray(t_col[1], dtype=dtype),
    )


def shard_linop(op, mesh, axis: str):
    """Lay the operator out over the mesh's tensor-parallel axis.

    The reference applies M with single-process BLAS/CSC ``mul!``
    (src/pdhg.jl:140-141,556,603,634); the equivalent under TP
    is to shard the operator's storage so matvec/rmatvec — and the
    linesearch norms computed from their outputs (pdhg.jl:562-566) —
    distribute over the mesh with GSPMD-inserted collectives:

    * ``DenseOp``: column-sharded (the n-sized variable axis).  ``M @ x``
      contracts over the sharded axis (partial products + psum);
      ``M' y`` emits an n-vector sharded the same way, so the
      linesearch's ``||M'(y - y_old)||`` becomes a sharded reduction.
    * ``EllOp``: row tables sharded over constraint rows, column tables
      over the n-sized variable axis — gather+reduce work splits R/ncols
      ways and the products' outputs stay sharded.
    * ``CooOp``: returned unchanged (scatter/segment-sum layouts do not
      distribute profitably; COO is only chosen for degenerate
      geometries — see build_linop).

    Uses device_put (committed layout), so the operands enter the jitted
    loop already distributed instead of being re-laid-out per chunk.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = int(mesh.shape[axis])

    def put(arr, spec):
        # device_put (unlike with_sharding_constraint/GSPMD) cannot pad:
        # a dimension that does not divide by the axis size is placed
        # replicated instead of failing the solve (real SDPLIB sides are
        # rarely multiples of the mesh size; the PSD-block sharding in
        # ops/cones.py — where the TP win lives — pads internally)
        for dim, name in enumerate(spec):
            if name is not None and arr.shape[dim] % n_shards:
                spec = P(*(None,) * len(spec))
                break
        return jax.device_put(arr, NamedSharding(mesh, spec))

    if isinstance(op, DenseOp):
        return DenseOp(put(op.mat, P(None, axis)))
    if isinstance(op, EllOp):
        return EllOp(
            put(op.row_cols, P(axis, None)),
            put(op.row_vals, P(axis, None)),
            put(op.col_rows, P(axis, None)),
            put(op.col_vals, P(axis, None)),
        )
    return op


def _to_coo(M):
    if _sp is not None and _sp.issparse(M):
        coo = M.tocoo()
        return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data.astype(np.float64)
    M = np.asarray(M)
    r, c = np.nonzero(M)
    return r.astype(np.int64), c.astype(np.int64), M[r, c].astype(np.float64)


def stack_vertical(A, G):
    """Host-side vertical stack of A (p,n) and G (m,n), dense or sparse."""
    if _sp is not None and (_sp.issparse(A) or _sp.issparse(G)):
        return _sp.vstack([_sp.csr_matrix(A), _sp.csr_matrix(G)]).tocsr()
    return np.vstack([np.asarray(A), np.asarray(G)])


def build_linop(A, G, dtype, force: str | None = None, dense_limit: int = 1 << 23):
    """Choose and build the device operator for M = [A; G].

    force: "dense" | "ell" | "coo" | None (auto).

    Auto policy: very sparse matrices (density < 2% and more than 2^16
    entries) use the gather-based ELLPACK form, whose traffic is
    proportional to nnz; otherwise dense when the matrix has at most
    ``dense_limit`` entries or is more than 25% full, else ELL.  The choice
    depends only on the matrix and dtype, never on the backend.  The
    crossovers are not yet measured on the H100.
    """
    M = stack_vertical(A, G)
    nrows, ncols = M.shape
    size = nrows * ncols
    if _sp is not None and _sp.issparse(M):
        nnz = M.nnz
    else:
        nnz = int(np.count_nonzero(M))
    density = nnz / max(size, 1)

    choice = force
    if choice is None:
        if density < 0.02 and size > (1 << 16):
            choice = "ell"
        else:
            choice = "dense" if (size <= dense_limit or density > 0.25) else "ell"

    if choice == "dense":
        dense = M.toarray() if (_sp is not None and _sp.issparse(M)) else np.asarray(M)
        return DenseOp(jnp.asarray(dense, dtype=dtype))

    rows, cols, vals = _to_coo(M)

    if choice == "ell":
        ell = _build_ell(rows, cols, vals, nrows, ncols, dtype)
        if ell is not None:
            return ell
        # a too-dense row/column (e.g. a variable pinned by thousands of
        # constraints): prefer dense when it fits, else COO
        if size <= dense_limit:
            dense = (
                M.toarray() if (_sp is not None and _sp.issparse(M)) else np.asarray(M)
            )
            return DenseOp(jnp.asarray(dense, dtype=dtype))
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    # pad to a power-of-two-ish bucket so minor nnz changes reuse compilations
    nnz = len(vals)
    pad = max(8, 1 << int(np.ceil(np.log2(max(nnz, 1)))))
    rows = np.concatenate([rows, np.full(pad - nnz, nrows, np.int64)])
    cols = np.concatenate([cols, np.zeros(pad - nnz, np.int64)])
    vals = np.concatenate([vals, np.zeros(pad - nnz)])
    return CooOp(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals, dtype=dtype), nrows, ncols
    )
