"""Welford online mean/variance estimator.

Reference: src/structure.rs:1062-1088 (`VarianceEstimator::add` incremental
update; `variance()` = M2/(n-1)). Wavefront form: the state is a pytree of
arrays so whole images of estimators update in one vectorized `add`, usable
both with numpy (host accumulation) and jax arrays (in-jit accumulation).
"""
from __future__ import annotations

from typing import Any, NamedTuple


class VarianceEstimator(NamedTuple):
    mean: Any   # running mean (any array shape)
    m2: Any     # sum of squared deviations
    n: Any      # sample count (scalar or per-element)


def variance_init(zeros) -> VarianceEstimator:
    """`zeros`: a zero array (or scalar) of the accumulated shape."""
    return VarianceEstimator(mean=zeros, m2=zeros, n=zeros * 0)


def variance_add(est: VarianceEstimator, x) -> VarianceEstimator:
    """One Welford step (structure.rs:1070-1078)."""
    n = est.n + 1
    delta = x - est.mean
    mean = est.mean + delta / n
    m2 = est.m2 + delta * (x - mean)
    return VarianceEstimator(mean=mean, m2=m2, n=n)


def variance_value(est: VarianceEstimator, eps: float = 0.0):
    """Unbiased sample variance M2/(n-1) (structure.rs:1083-1087)."""
    denom = est.n - 1
    try:
        import jax.numpy as jnp
        if any(hasattr(v, "aval") or hasattr(v, "device") for v in est):
            return jnp.where(denom > 0, est.m2 / jnp.maximum(denom, 1), eps)
    except Exception:
        pass
    import numpy as np
    denom = np.maximum(denom, 1)
    out = est.m2 / denom
    return np.where(est.n > 1, out, eps)
