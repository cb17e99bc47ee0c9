"""Discrete/continuous distributions as flat CDF tables.

Array-native equivalent of the reference's `Distribution1D`/`Distribution2D`
(src/math.rs:396-532). Building happens once at scene-compile time; sampling is
a vectorized `searchsorted` over the wavefront, which XLA lowers to a
branch-free binary search.

CDF layout matches the reference: cdf has n+1 entries, cdf[0] = 0, cdf[n] = 1,
pdf(i) = cdf[i+1] - cdf[i], func_int = mean(func).
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from . import pytree
from ..ops.gather import table_take


@pytree.dataclass
class Distribution1D:
    cdf: Any   # [n+1] f32
    func: Any  # [n] f32
    func_int: Any  # scalar f32 (mean of func, as in the reference)


def build_distribution_1d_np(func) -> Distribution1D:
    """Host-side (numpy) build — used at scene-compile time so no device
    arrays (or readbacks) are created before the final device_put."""
    import numpy as np
    func = np.asarray(func, dtype=np.float32)
    n = func.shape[-1]
    csum = np.cumsum(func / n, axis=-1)
    cdf = np.concatenate([np.zeros_like(csum[..., :1]), csum], axis=-1)
    total = cdf[..., -1:]
    safe_total = np.where(total > 0.0, total, 1.0)
    cdf = cdf / safe_total
    cdf[..., -1] = 1.0
    return Distribution1D(cdf=cdf, func=func, func_int=total[..., 0])


def build_distribution_2d_np(f) -> Distribution2D:
    import numpy as np
    f = np.asarray(f, dtype=np.float32)
    cond = build_distribution_1d_np(f)
    row_int = cond.func_int
    marg = build_distribution_1d_np(row_int)
    return Distribution2D(
        marginal_cdf=marg.cdf, conditional_cdf=cond.cdf, func=f,
        marginal_func=row_int, marginal_int=marg.func_int)


def build_distribution_1d(func) -> Distribution1D:
    func = jnp.asarray(func, dtype=jnp.float32)
    n = func.shape[-1]
    csum = jnp.cumsum(func / n, axis=-1)
    cdf = jnp.concatenate([jnp.zeros_like(csum[..., :1]), csum], axis=-1)
    total = cdf[..., -1:]
    safe_total = jnp.where(total > 0.0, total, 1.0)
    cdf = cdf / safe_total
    # Force the final entry to exactly 1 (degenerate all-zero -> uniform last bin).
    cdf = cdf.at[..., -1].set(1.0)
    return Distribution1D(cdf=cdf, func=func, func_int=total[..., 0])


def sample_discrete_1d(dist: Distribution1D, u):
    """u [..., ] in [0,1) -> index [...] (int32)."""
    idx = jnp.searchsorted(dist.cdf, u, side="right") - 1
    return jnp.clip(idx, 0, dist.func.shape[-1] - 1).astype(jnp.int32)


def pdf_discrete_1d(dist: Distribution1D, idx):
    return table_take(dist.cdf, idx + 1) - table_take(dist.cdf, idx)


def sample_continuous_1d(dist: Distribution1D, u):
    """u [...] -> (continuous position in [0, n), index, remapped-u)."""
    idx = sample_discrete_1d(dist, u)
    c0 = table_take(dist.cdf, idx)
    p = pdf_discrete_1d(dist, idx)
    dv = u - c0
    dv = jnp.where(p > 0.0, dv / jnp.where(p > 0.0, p, 1.0), dv)
    return idx.astype(jnp.float32) + dv, idx, dv


@pytree.dataclass
class Distribution2D:
    """Marginal over rows x conditional over columns (reference src/math.rs:489-532)."""
    marginal_cdf: Any      # [h+1]
    conditional_cdf: Any   # [h, w+1]
    func: Any              # [h, w]
    marginal_func: Any     # [h] row integrals
    marginal_int: Any      # scalar


def build_distribution_2d(f) -> Distribution2D:
    """f [h, w] nonnegative (e.g. luminance of an envmap)."""
    f = jnp.asarray(f, dtype=jnp.float32)
    h, w = f.shape
    cond = build_distribution_1d(f)          # batched over rows
    row_int = cond.func_int                  # [h]
    marg = build_distribution_1d(row_int)
    return Distribution2D(
        marginal_cdf=marg.cdf,
        conditional_cdf=cond.cdf,
        func=f,
        marginal_func=row_int,
        marginal_int=marg.func_int,
    )


def sample_continuous_2d(d2: Distribution2D, uv):
    """uv [..., 2] -> (x, y) continuous positions in [0,w) x [0,h)."""
    h, w = d2.func.shape
    uy = uv[..., 1]
    ux = uv[..., 0]
    yi = jnp.clip(jnp.searchsorted(d2.marginal_cdf, uy, side="right") - 1, 0, h - 1)
    my0 = table_take(d2.marginal_cdf, yi)
    mp = table_take(d2.marginal_cdf, yi + 1) - my0
    dy = uy - my0
    dy = jnp.where(mp > 0.0, dy / jnp.where(mp > 0.0, mp, 1.0), dy)
    y = yi.astype(jnp.float32) + dy

    ccdf = table_take(d2.conditional_cdf, yi)  # gather rows [..., w+1]
    xi = jnp.clip(
        jnp.sum((ccdf <= ux[..., None]).astype(jnp.int32), axis=-1) - 1, 0, w - 1
    )
    cx0 = jnp.take_along_axis(ccdf, xi[..., None], axis=-1)[..., 0]
    cp = jnp.take_along_axis(ccdf, xi[..., None] + 1, axis=-1)[..., 0] - cx0
    dx = ux - cx0
    dx = jnp.where(cp > 0.0, dx / jnp.where(cp > 0.0, cp, 1.0), dx)
    x = xi.astype(jnp.float32) + dx
    return jnp.stack([x, y], axis=-1)


def pdf_2d(d2: Distribution2D, xi, yi):
    """Discrete cell pdf density: func[y,x] / marginal_int (reference pdf())."""
    v = d2.func[yi, xi]
    safe = jnp.where(d2.marginal_int > 0.0, d2.marginal_int, 1.0)
    return v / safe
