"""Triangle(svec) <-> square matrix maps as trace-time gathers.

The reference rebuilds dense symmetric matrices from the packed vector with
scalar loops every iteration (src/prox_operators.jl:1-31).  Here both
directions become a single gather with a static index map and a static scale
vector, fused by XLA into adjacent ops — O(n^2) memory traffic, no scalar
code.

Scaling convention (identical to reference): the packed vector stores
off-diagonal entries multiplied by sqrt(2) ("scaled triangle"), so
tri->square divides off-diagonals by sqrt(2) and square->tri multiplies back.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..utils.vech import offdiag_mask_tri, square_gather_index, sympackedlen, tri_ij

_SQRT2 = np.sqrt(2.0)


@functools.lru_cache(maxsize=None)
def _maps(side: int):
    gidx = square_gather_index(side)  # (side*side,) tri position per sq entry
    # scale applied when expanding tri -> square (off-diagonals / sqrt(2))
    I, J = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    offd_sq = (I != J).reshape(-1)
    in_scale = np.where(offd_sq, 1.0 / _SQRT2, 1.0)
    # tri extraction: square flat index of each tri position (upper, i<=j)
    i, j = tri_ij(side)
    sq_of_tri = i * side + j
    out_scale = np.where(offdiag_mask_tri(side), _SQRT2, 1.0)
    return gidx, in_scale, sq_of_tri, out_scale


def tri_to_square(v_block, side: int):
    """Packed scaled triangle (tri_len,) -> dense symmetric (side, side)."""
    gidx, in_scale, _, _ = _maps(side)
    gi = jnp.asarray(gidx)
    sc = jnp.asarray(in_scale, dtype=v_block.dtype)
    return (v_block[gi] * sc).reshape(side, side)


def square_to_tri(X, side: int):
    """Dense symmetric (side, side) -> packed scaled triangle (tri_len,)."""
    _, _, sq_of_tri, out_scale = _maps(side)
    si = jnp.asarray(sq_of_tri)
    sc = jnp.asarray(out_scale, dtype=X.dtype)
    return X.reshape(-1)[si] * sc


def tri_len(side: int) -> int:
    return sympackedlen(side)
