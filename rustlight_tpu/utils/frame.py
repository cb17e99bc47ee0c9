"""Orthonormal shading frames (branchless Pixar ONB).

Vectorized equivalent of the reference's `Frame` (src/math.rs:356-384):
given a unit normal n build tangent/bitangent without branches so the whole
wavefront computes frames in lockstep across lanes.
"""
from __future__ import annotations

import jax.numpy as jnp


def make_frame(n):
    """Build an ONB from unit normals n [..., 3] -> (t, b, n) each [..., 3]."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    bt = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return t, bt, n


def to_world(frame, v):
    """v local [..., 3] -> world. frame = (t, b, n)."""
    t, b, n = frame
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def to_local(frame, v):
    """v world [..., 3] -> local (x=t, y=b, z=n)."""
    t, b, n = frame
    return jnp.stack(
        [jnp.sum(v * t, axis=-1), jnp.sum(v * b, axis=-1), jnp.sum(v * n, axis=-1)],
        axis=-1,
    )
