"""Static-shape Lanczos eigensolver for the low-rank PSD projection.

Static-shape redesign of the reference's reverse-communication ARPACK /
KrylovKit engines (src/eigsolver.jl): instead of a dynamic-size, early-exit
Krylov loop, we run a FIXED number of Lanczos steps (ncv) with full
reorthogonalization under ``lax.scan`` and diagonalize the small (ncv, ncv)
tridiagonal matrix with ``eigh``.  Everything is static-shape, so the whole
solver jits once per problem geometry; convergence is *checked* (per-Ritz
residual bounds) rather than iterated on, and the caller falls back to dense
eigh when the check fails — mirroring the reference's
Lanczos-then-full-eig fallback (src/prox_operators.jl:55-57).

Why full reorthogonalization: it turns the orthogonality maintenance into
two (ncv, n) x (n,) matmuls per step and makes the iteration
deterministic and robust without ARPACK's implicit restarts.

Warm start: the caller passes the previous iteration's dominant Ritz vector
as v0 (reference warm-starts ARPACK's resid similarly, eigsolver.jl:392-411,
options.jl:78).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .precision import full_f32


class LanczosResult(NamedTuple):
    vals: jax.Array  # (ncv,) Ritz values, sorted DESCENDING
    vecs: jax.Array  # (n, ncv) Ritz vectors (columns), same order
    resid: jax.Array  # (ncv,) residual-norm estimates |beta_ncv * s_last|
    beta_last: jax.Array  # final off-diagonal (breakdown indicator)


@partial(jax.jit, static_argnames=("ncv",))
@full_f32
def lanczos_topk(X, v0, *, ncv: int, tol: float = 1e-12) -> LanczosResult:
    """Top Ritz pairs of symmetric X via ncv Lanczos steps.

    X: (n, n) symmetric; v0: (n,) start vector (need not be normalized).
    Returns all ncv Ritz pairs sorted by value descending, plus standard
    residual bounds res_i = |beta_ncv * S[ncv-1, i]| (so the caller can
    decide which pairs are trustworthy).

    Traced under full-f32 matmul precision (ops/precision.py): Lanczos
    orthogonality and the Ritz residual bounds need true-f32 products or
    the caller's acceptance check rejects every run.
    """
    n = X.shape[0]
    dtype = X.dtype
    eps = jnp.asarray(1e-30, dtype)

    v0 = v0.astype(dtype)
    nrm = jnp.sqrt(jnp.sum(v0 * v0))
    # deterministic fallback basis vector if v0 is degenerate
    e0 = jnp.zeros((n,), dtype).at[0].set(1.0)
    q0 = jnp.where(nrm > eps, v0 / jnp.where(nrm > eps, nrm, 1.0), e0)

    def step(carry, i):
        V, q, beta_prev, q_prev = carry
        w = X @ q
        alpha = jnp.dot(q, w)
        w = w - alpha * q - beta_prev * q_prev
        # full reorthogonalization (twice is enough): V rows beyond the
        # current step are zero, so the masked matmul is safe
        w = w - V.T @ (V @ w)
        w = w - V.T @ (V @ w)
        beta = jnp.sqrt(jnp.sum(w * w))
        # on breakdown (invariant subspace), restart with a deterministic
        # vector orthogonalized against V
        rcount = jnp.asarray(i + 1, dtype)
        fresh = jnp.sin(jnp.arange(n, dtype=dtype) * (1.7 + 0.13 * rcount)) + 0.5
        fresh = fresh - V.T @ (V @ fresh) - jnp.dot(q, fresh) * q
        fresh_n = jnp.sqrt(jnp.sum(fresh * fresh))
        fresh = fresh / jnp.where(fresh_n > eps, fresh_n, 1.0)
        broke = beta <= 1e3 * tol
        q_next = jnp.where(broke, fresh, w / jnp.where(beta > eps, beta, 1.0))
        beta_eff = jnp.where(broke, 0.0, beta)
        V = V.at[i].set(q)
        return (V, q_next, beta_eff, q), (alpha, beta_eff)

    V0 = jnp.zeros((ncv, n), dtype)
    carry0 = (V0, q0, jnp.asarray(0.0, dtype), jnp.zeros((n,), dtype))
    (V, _, beta_last, _), (alphas, betas) = jax.lax.scan(
        step, carry0, jnp.arange(ncv)
    )

    # tridiagonal T from (alphas, betas[:-1])
    T = jnp.diag(alphas)
    if ncv > 1:
        off = betas[:-1]
        T = T + jnp.diag(off, 1) + jnp.diag(off, -1)
    theta, S = jnp.linalg.eigh(T)  # ascending
    order = jnp.argsort(-theta)
    theta = theta[order]
    S = S[:, order]
    ritz = V.T @ S  # (n, ncv)
    resid = jnp.abs(betas[-1] * S[-1, :])
    return LanczosResult(vals=theta, vecs=ritz, resid=resid, beta_last=betas[-1])
