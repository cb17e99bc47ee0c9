"""Screened-Poisson reconstructions for gradient-domain rendering.

Reference: src/integrators/gradient/recons.rs — Jacobi iterations combining
the primal estimate with forward-difference gradients:
  I[p] <- ( I[p] + sum_q (I[q] +- g[q,p]) ) / w
On the device the per-pixel loops become whole-image stencils (jnp.roll + edge
masks) inside a fori_loop — P8 in SURVEY.md §2.10.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _shift(img, dy, dx):
    """Shift image content by (dy, dx) with zero padding semantics handled by
    validity masks at the call site."""
    return jnp.roll(img, (dy, dx), axis=(0, 1))


def _edge_masks(h, w):
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w, 1), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w, 1), 1)
    return (xs > 0, xs < w - 1, ys > 0, ys < h - 1)  # has left/right/up/down


def uniform_poisson_reconstruction(primal, gx, gy, very_direct=None,
                                   iterations: int = 50):
    """Uniform Jacobi solve (recons.rs:266-357). All images [h, w, 3]."""
    h, w = primal.shape[:2]
    has_l, has_r, has_u, has_d = _edge_masks(h, w)

    def body(_, cur):
        c = cur
        wgt = jnp.ones((h, w, 1), jnp.float32)
        left = _shift(cur, 0, 1) + _shift(gx, 0, 1)     # I[x-1] + gx[x-1]
        c = c + jnp.where(has_l, left, 0.0)
        wgt = wgt + has_l
        right = _shift(cur, 0, -1) - gx                 # I[x+1] - gx[x]
        c = c + jnp.where(has_r, right, 0.0)
        wgt = wgt + has_r
        up = _shift(cur, 1, 0) + _shift(gy, 1, 0)       # I[y-1] + gy[y-1]
        c = c + jnp.where(has_u, up, 0.0)
        wgt = wgt + has_u
        down = _shift(cur, -1, 0) - gy                  # I[y+1] - gy[y]
        c = c + jnp.where(has_d, down, 0.0)
        wgt = wgt + has_d
        return c / wgt

    out = jax.lax.fori_loop(0, iterations, body, primal)
    if very_direct is not None:
        out = out + very_direct
    return out


def _mean_var(stack):
    """stack [k, h, w, 3] -> (mean, sample variance) across k replicates."""
    k = stack.shape[0]
    mean = jnp.mean(stack, axis=0)
    if k < 2:
        return mean, jnp.zeros_like(mean)
    var = jnp.sum((stack - mean[None]) ** 2, axis=0) / (k - 1)
    return mean, var


def weighted_poisson_reconstruction(primal_stack, gx_stack, gy_stack,
                                    very_direct=None, iterations: int = 50):
    """Variance-weighted Jacobi solve (recons.rs:85-265).

    *_stack: [k, h, w, 3] independent buffer replicates; weights are inverse
    variances (channel max), with the primal confidence annealed over
    iterations via coeff = 1/(1.01 + 4 * 0.5^iter)."""
    primal, var_p = _mean_var(primal_stack)
    gx, var_gx = _mean_var(gx_stack)
    gy, var_gy = _mean_var(gy_stack)
    h, w = primal.shape[:2]
    has_l, has_r, has_u, has_d = _edge_masks(h, w)

    vp = jnp.max(var_p, axis=-1, keepdims=True)
    vgx = jnp.max(var_gx, axis=-1, keepdims=True)
    vgy = jnp.max(var_gy, axis=-1, keepdims=True)

    def inv_or_1(v):
        return jnp.where(v > 0.0, 1.0 / jnp.maximum(v, 1e-30), 1.0)

    def body(it, cur):
        coeff = 1.0 / (0.01 + 1.0 + 4.0 * 0.5 ** it.astype(jnp.float32))
        var_pos = vp * coeff
        w0 = inv_or_1(var_pos)
        c = cur * w0
        wgt = w0
        wl = inv_or_1(var_pos + _shift(vgx, 0, 1))
        c = c + jnp.where(has_l, (_shift(cur, 0, 1) + _shift(gx, 0, 1)) * wl, 0.0)
        wgt = wgt + jnp.where(has_l, wl, 0.0)
        wr = inv_or_1(var_pos + vgx)
        c = c + jnp.where(has_r, (_shift(cur, 0, -1) - gx) * wr, 0.0)
        wgt = wgt + jnp.where(has_r, wr, 0.0)
        wu = inv_or_1(var_pos + _shift(vgy, 1, 0))
        c = c + jnp.where(has_u, (_shift(cur, 1, 0) + _shift(gy, 1, 0)) * wu, 0.0)
        wgt = wgt + jnp.where(has_u, wu, 0.0)
        wd = inv_or_1(var_pos + vgy)
        c = c + jnp.where(has_d, (_shift(cur, -1, 0) - gy) * wd, 0.0)
        wgt = wgt + jnp.where(has_d, wd, 0.0)
        return c / wgt

    out = jax.lax.fori_loop(0, iterations, body, primal)
    if very_direct is not None:
        out = out + very_direct
    return out


def bagging_poisson_reconstruction(primal_stack, gx_stack, gy_stack,
                                   very_direct=None, iterations: int = 50):
    """Leave-one-out bagging over weighted reconstructions (recons.rs:6-83).

    Returns (mean, variance, relative_error) AOVs."""
    k = primal_stack.shape[0]
    assert k >= 2, "bagging needs at least two buffers"
    recons = []
    for leave in range(k):
        keep = [i for i in range(k) if i != leave]
        r = weighted_poisson_reconstruction(
            primal_stack[jnp.asarray(keep)], gx_stack[jnp.asarray(keep)],
            gy_stack[jnp.asarray(keep)], very_direct, iterations)
        recons.append(r)
    stack = jnp.stack(recons, 0)
    mean, var = _mean_var(stack)
    relerr = var / (mean + 1e-3)
    return mean, var, relerr
