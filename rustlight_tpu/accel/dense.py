"""Dense ray-triangle intersection: the small-scene tier.

The reference's hot loop is a recursive SAH BVH walk per ray
(src/accel.rs:243-288) with a scalar Möller triangle test
(src/geometry.rs:358-410). For Cornell-box-class scenes a dense test of
every ray against every triangle beats any traversal: with per-triangle
plane/barycentric rows precomputed (Baldwin-Weber, see scene/geometry.py),
intersecting N rays against T triangles is exactly two matmuls

    [N, 4] @ [4, 3T] -> (n.o + d, u_o, v_o) and (n.d, u_d, v_d)

followed by elementwise resolve t = -No/Nd, u = Uo + t*Ud, v = Vo + t*Vd and
a min-reduction, with no divergence. The products ask for
Precision.HIGHEST: full f32, never TF32, to keep geometric precision.

Cost is linear in the padded triangle count. Triangle chunking (TRI_CHUNK,
not yet tuned on the H100) bounds the [N, 3T] intermediate. Scenes above
geometry.BVH_THRESHOLD triangles take the BVH walk (accel/bvh.py).
"""
from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .. import EPSILON

_PREC = lax.Precision.HIGHEST
TRI_CHUNK = 1024  # triangles per matmul chunk: [N, 3*TRI_CHUNK] intermediate


class RayHit(NamedTuple):
    t: Any       # [n] hit distance (inf if miss)
    tri: Any     # [n] int32 triangle id (-1 if miss)
    u: Any       # [n] barycentric of e1
    v: Any       # [n] barycentric of e2
    hit: Any     # [n] bool


def _chunk_test(rows_chunk, o4, d4, tnear, tfar):
    """Intersect all rays against one triangle chunk.

    rows_chunk [c, 3, 4]; o4/d4 [n, 4]. Returns (t [n, c], valid [n, c], ...).

    Layout note: the matmul output is kept as [n, 3c] with *contiguous blocks*
    N | U | V of c columns each, so no reshape puts the 3 in the minor
    dimension of the biggest intermediate in the renderer.
    """
    c = rows_chunk.shape[0]
    p = rows_chunk.transpose(1, 0, 2).reshape(3 * c, 4).T   # [4, N-blk|U-blk|V-blk]
    ao = jnp.dot(o4, p, precision=_PREC)        # [n, 3c]
    ad = jnp.dot(d4, p, precision=_PREC)
    no, uo, vo = ao[:, :c], ao[:, c:2 * c], ao[:, 2 * c:]
    nd, ud, vd = ad[:, :c], ad[:, c:2 * c], ad[:, 2 * c:]

    live = jnp.abs(nd) > 1e-20
    t = -no / jnp.where(live, nd, 1.0)
    u = uo + t * ud
    v = vo + t * vd
    valid = (
        live
        & (t > tnear[:, None]) & (t < tfar[:, None])
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    )
    return t, u, v, valid


@partial(jax.jit, static_argnames=("any_hit",))
def _intersect_impl(inter_rows, o, d, tnear, tfar, any_hit: bool):
    n = o.shape[0]
    t_pad = inter_rows.shape[0]
    o4 = jnp.concatenate([o, jnp.ones((n, 1), o.dtype)], axis=-1)
    d4 = jnp.concatenate([d, jnp.zeros((n, 1), d.dtype)], axis=-1)

    n_chunks = max(1, (t_pad + TRI_CHUNK - 1) // TRI_CHUNK)

    if n_chunks == 1:
        t, u, v, valid = _chunk_test(inter_rows, o4, d4, tnear, tfar)
        if any_hit:
            return jnp.any(valid, axis=1)
        # reduction-based winner selection: two min-reductions plus masked
        # sums, the lowest index winning exact ties
        t_masked = jnp.where(valid, t, jnp.inf)
        best_t = jnp.min(t_masked, axis=1)
        hit = jnp.isfinite(best_t)
        c = t.shape[1]
        iota = lax.broadcasted_iota(jnp.int32, t.shape, 1)
        idx = jnp.min(jnp.where(t_masked == best_t[:, None], iota, c), axis=1)
        idx = jnp.minimum(idx, c - 1)
        sel = iota == idx[:, None]
        best_u = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        best_v = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
        return RayHit(
            t=best_t,
            tri=jnp.where(hit, idx.astype(jnp.int32), -1),
            u=best_u, v=best_v, hit=hit,
        )

    pad = n_chunks * TRI_CHUNK - t_pad
    if pad:
        # degenerate pad rows (n = 0) never report hits
        inter_rows = jnp.concatenate(
            [inter_rows, jnp.zeros((pad, 3, 4), inter_rows.dtype)], axis=0)
    rows = inter_rows.reshape(n_chunks, TRI_CHUNK, 3, 4)

    if any_hit:
        def body(carry, rows_chunk):
            t, u, v, valid = _chunk_test(rows_chunk, o4, d4, tnear, tfar)
            return carry | jnp.any(valid, axis=1), None
        occ, _ = lax.scan(body, jnp.zeros(n, bool), rows)
        return occ

    def body(carry, rows_chunk):
        best_t, best_i, best_u, best_v, base = carry
        t, u, v, valid = _chunk_test(rows_chunk, o4, d4, tnear, tfar)
        t_masked = jnp.where(valid, t, jnp.inf)
        ct = jnp.min(t_masked, axis=1)
        c = t.shape[1]
        iota = lax.broadcasted_iota(jnp.int32, t.shape, 1)
        idx = jnp.min(jnp.where(t_masked == ct[:, None], iota, c), axis=1)
        idx = jnp.minimum(idx, c - 1)
        sel = iota == idx[:, None]
        cu = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        cv = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
        closer = ct < best_t
        return (
            jnp.where(closer, ct, best_t),
            jnp.where(closer, idx.astype(jnp.int32) + base, best_i),
            jnp.where(closer, cu, best_u),
            jnp.where(closer, cv, best_v),
            base + TRI_CHUNK,
        ), None

    init = (jnp.full(n, jnp.inf), jnp.full(n, -1, jnp.int32),
            jnp.zeros(n), jnp.zeros(n), jnp.int32(0))
    (best_t, best_i, best_u, best_v, _), _ = lax.scan(body, init, rows)
    hit = jnp.isfinite(best_t)
    return RayHit(t=best_t, tri=jnp.where(hit, best_i, -1),
                  u=best_u, v=best_v, hit=hit)


def intersect_rays(geom, o, d, tnear=None, tfar=None) -> RayHit:
    """Closest-hit for a ray wavefront. o, d [n, 3]. Scenes that carry BVH
    tables (above geometry.BVH_THRESHOLD) route to the BVH walk."""
    n = o.shape[0]
    if tnear is None:
        tnear = jnp.full(n, EPSILON, jnp.float32)
    if tfar is None:
        tfar = jnp.full(n, jnp.inf, jnp.float32)
    if getattr(geom, "bvh", None) is not None:
        from .bvh import intersect_bvh
        return intersect_bvh(geom.bvh, o, d, tnear, tfar)
    return _intersect_impl(geom.inter_rows, o, d, tnear, tfar, False)


def occluded_rays(geom, o, d, tnear, tfar):
    """Any-hit (shadow ray) test; True = blocked."""
    if getattr(geom, "bvh", None) is not None:
        from .bvh import occluded_bvh
        return occluded_bvh(geom.bvh, o, d, tnear, tfar)
    return _intersect_impl(geom.inter_rows, o, d, tnear, tfar, True)


def visible(geom, p0, p1, mask=None):
    """Mutual visibility p0 <-> p1 with the reference's shadow epsilons
    (Ray tnear=EPSILON, tfar slightly short of the target; src/accel.rs
    visible).

    mask [n] bool (optional): lanes where the caller will NOT consume the
    result (dead lanes, delta BSDFs, invalid light samples). They get
    tfar = 0 — an inert ray that cannot hit anything (the BVH walk retires
    it at the root). Masked lanes return True (unoccluded); callers must
    gate on their own mask."""
    delta = p1 - p0
    dist = jnp.linalg.norm(delta, axis=-1)
    d = delta / jnp.maximum(dist, 1e-20)[:, None]
    tnear = jnp.full(dist.shape, EPSILON, jnp.float32)
    tfar = dist * (1.0 - 1e-3)
    if mask is not None:
        tfar = jnp.where(mask, tfar, 0.0)
    return ~occluded_rays(geom, p0, d, tnear, tfar)
