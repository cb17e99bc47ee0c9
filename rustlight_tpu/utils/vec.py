"""Batched 3-vector / color helpers.

All geometry/transport math is float32 arrays with a trailing dimension of 3.
Mirrors the small-vector surface of the reference's `Color` + cgmath usage
(reference: src/structure.rs:104-381).
"""
from __future__ import annotations

import jax.numpy as jnp

# Rec.709 luminance weights (reference: src/structure.rs:173-177).
# Kept as python scalars: array literals inside jit would become XLA
# constants.
_LUM_R, _LUM_G, _LUM_B = 0.212671, 0.715160, 0.072169


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length2(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length2(v))


def normalize(v, eps: float = 0.0):
    n = length(v)[..., None]
    if eps > 0.0:
        n = jnp.maximum(n, eps)
    return v / n


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def luminance(c):
    return c[..., 0] * _LUM_R + c[..., 1] * _LUM_G + c[..., 2] * _LUM_B


def channel_max(c):
    return jnp.max(c, axis=-1)


def reflect_local(d):
    """Mirror reflection about the local +z axis (reference: src/bsdfs/mod.rs reflect)."""
    return jnp.stack([-d[..., 0], -d[..., 1], d[..., 2]], axis=-1)


def face_forward(n, d):
    """Flip n so that dot(n, d) >= 0."""
    s = jnp.where(dot(n, d) < 0.0, -1.0, 1.0)
    return n * s[..., None]
