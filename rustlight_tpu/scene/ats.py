"""Adaptive-tree-splitting (ATS) light BVH — PBRT-v4-style light hierarchy.

Reference: src/emitter.rs:782-1488. Per-triangle LightProxy bounds (aabb,
axis cone theta_o/theta_e, flux phi), DirectionCone unions, SAOH bucket build
(12 buckets, solid-angle measure momega), stochastic importance-driven
traversal for sampling and a parent-walk for pdfs. Enabled by `-x ats`.

Host/device split: the SAOH build runs on host (numpy, recursive — same algorithm as
the reference); sampling/pdf run on device as while_loops over flattened node
tables with one-hot gathers. The variance-based splitting traversal
(sample_split, emitter.rs:1401-1487) runs as a bounded explicit-stack
while_loop returning fixed-size light slots (`ats_sample_split`), and the
ray-segment importance (importance_ray, emitter.rs:975-1032) drives both it
and `ats_sample_ray`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import pytree
from ..ops.gather import table_take
from ..utils.vec import normalize

_PI = np.pi
EPSILON_ATS = 1e-4


# ----------------------------------------------------------------- host build

def _cone_union(wa, ca, wb, cb):
    """DirectionCone union (emitter.rs:857-898); inputs unit axes + cos."""
    ta, tb = np.arccos(np.clip(ca, -1, 1)), np.arccos(np.clip(cb, -1, 1))
    td = np.arccos(np.clip(np.dot(wa, wb), -1, 1))
    if min(td + tb, _PI) <= ta:
        return wa, ca
    if min(td + ta, _PI) <= tb:
        return wb, cb
    to = (ta + td + tb) / 2.0
    if to >= _PI:
        return np.array([0.0, 0.0, 1.0]), -1.0
    wr = np.cross(wa, wb)
    if np.dot(wr, wr) == 0.0:
        return np.array([0.0, 0.0, 1.0]), -1.0
    wr = wr / np.linalg.norm(wr)
    tr = to - ta
    c, s = np.cos(tr), np.sin(tr)
    # Rodrigues rotation of wa around wr by tr
    w = wa * c + np.cross(wr, wa) * s + wr * np.dot(wr, wa) * (1 - c)
    return w, np.cos(to)


class _LB:
    __slots__ = ("lo", "hi", "w", "phi", "phi_sqr", "cos_o", "cos_e", "nl")

    def __init__(self, lo, hi, w, phi, cos_o, cos_e, phi_sqr=None, nl=1):
        self.lo, self.hi, self.w = lo, hi, w
        self.phi = phi
        self.phi_sqr = phi * phi if phi_sqr is None else phi_sqr
        self.cos_o, self.cos_e = cos_o, cos_e
        self.nl = nl

    @staticmethod
    def union(a, b):
        if a.phi == 0.0:
            return b
        if b.phi == 0.0:
            return a
        w, cos_o = _cone_union(a.w, a.cos_o, b.w, b.cos_o)
        cos_e = min(a.cos_e, b.cos_e)
        return _LB(np.minimum(a.lo, b.lo), np.maximum(a.hi, b.hi), w,
                   a.phi + b.phi, cos_o, cos_e,
                   phi_sqr=a.phi_sqr + b.phi_sqr, nl=a.nl + b.nl)

    def area(self):
        d = np.maximum(self.hi - self.lo, 0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def momega(self):
        to = np.arccos(np.clip(self.cos_o, -1, 1))
        te = np.arccos(np.clip(self.cos_e, -1, 1))
        tw = min(to + te, _PI)
        return (2 * _PI * (1 - np.cos(to))
                + _PI / 2 * (2 * tw * np.sin(to) - np.cos(to - 2 * tw)
                             - 2 * to * np.sin(to) + np.cos(to)))


@pytree.dataclass
class AtsTables:
    n_nodes: int = pytree.field(static=True)
    root: int = pytree.field(static=True)
    left: Any       # [m] int32 (-1 leaf)
    right: Any      # [m]
    parent: Any     # [m]
    leaf_tri: Any   # [m] global triangle id (-1 internal)
    lo: Any         # [m, 3]
    hi: Any         # [m, 3]
    w: Any          # [m, 3]
    cos_o: Any      # [m]
    cos_e: Any      # [m]
    phi: Any        # [m]
    tri_leaf: Any   # [t_pad] leaf node of each emissive triangle (-1 else)
    tri_area_inv: Any  # [t_pad] 1/area (area pdf within the sampled triangle)
    phi_sqr: Any = None  # [m] sum of squared proxy fluxes (split variance)
    nl: Any = None       # [m] number of lights under the node


def build_ats(scene_geom, emitters) -> AtsTables:
    """Build from the flattened geometry + emitter tables (host, numpy)."""
    eid = np.asarray(scene_geom.emitter_id[: scene_geom.n_tris])
    tris = np.nonzero(eid >= 0)[0]
    assert len(tris) > 0, "ATS needs surface emitters"
    v0 = np.asarray(scene_geom.v0[: scene_geom.n_tris])
    e1 = np.asarray(scene_geom.e1[: scene_geom.n_tris])
    e2 = np.asarray(scene_geom.e2[: scene_geom.n_tris])
    ng = np.asarray(scene_geom.n_g[: scene_geom.n_tris])
    area = np.asarray(scene_geom.area[: scene_geom.n_tris])
    le = np.asarray(emitters.tri_emission[: scene_geom.n_tris])

    # per-triangle proxies (emitter.rs convert_light_proxy:731-780):
    # phi = channel_max(Le) * area, theta_o = 0, theta_e = pi/2
    proxies = []
    for t in tris:
        ps = np.stack([v0[t], v0[t] + e1[t], v0[t] + e2[t]])
        proxies.append((int(t), _LB(ps.min(0), ps.max(0), ng[t],
                                    float(le[t].max() * area[t]), 1.0, 0.0)))

    nodes = []  # dicts

    def build(items):
        if len(items) == 1:
            t, b = items[0]
            nodes.append(dict(left=-1, right=-1, parent=-1, tri=t, b=b))
            return len(nodes) - 1
        cent = np.stack([(it[1].lo + it[1].hi) * 0.5 for it in items])
        clo, chi = cent.min(0), cent.max(0)
        glo = np.min([it[1].lo for it in items], 0)
        ghi = np.max([it[1].hi for it in items], 0)
        gsize = np.maximum(ghi - glo, 1e-20)

        nb = 12
        best = (np.inf, -1, -1)
        for dim in range(3):
            if chi[dim] == clo[dim]:
                continue
            off = (cent[:, dim] - clo[dim]) / (chi[dim] - clo[dim])
            bidx = np.minimum((nb * off).astype(int), nb - 1)
            bucket = [None] * nb
            for i, it in enumerate(items):
                b = bucket[bidx[i]]
                bucket[bidx[i]] = it[1] if b is None else _LB.union(b, it[1])
            for i in range(nb - 1):
                l = r = None
                for j in range(i + 1):
                    if bucket[j] is not None:
                        l = bucket[j] if l is None else _LB.union(l, bucket[j])
                for j in range(i + 1, nb):
                    if bucket[j] is not None:
                        r = bucket[j] if r is None else _LB.union(r, bucket[j])
                if l is None or r is None:
                    continue
                kr = gsize.max() / gsize[dim]
                cost = kr * (l.phi * l.momega() * l.area()
                             + r.phi * r.momega() * r.area())
                if 0.0 < cost < best[0]:
                    best = (cost, dim, i)

        if best[1] < 0:
            mid = len(items) // 2
            items.sort(key=lambda it: (it[1].lo + it[1].hi)[0])
            l_items, r_items = items[:mid], items[mid:]
        else:
            dim, cut = best[1], best[2]
            off = (cent[:, dim] - clo[dim]) / (chi[dim] - clo[dim])
            bidx = np.minimum((nb * off).astype(int), nb - 1)
            l_items = [it for i, it in enumerate(items) if bidx[i] <= cut]
            r_items = [it for i, it in enumerate(items) if bidx[i] > cut]
            if not l_items or not r_items:
                mid = len(items) // 2
                l_items, r_items = items[:mid], items[mid:]

        li = build(l_items)
        ri = build(r_items)
        nodes.append(dict(
            left=li, right=ri, parent=-1, tri=-1,
            b=_LB.union(nodes[li]["b"], nodes[ri]["b"])))
        idx = len(nodes) - 1
        nodes[li]["parent"] = idx
        nodes[ri]["parent"] = idx
        return idx

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        root = build(list(proxies))
    finally:
        sys.setrecursionlimit(old)

    m = len(nodes)
    t_pad = scene_geom.n_pad
    tri_leaf = np.full(t_pad, -1, np.int32)
    for i, nd in enumerate(nodes):
        if nd["tri"] >= 0:
            tri_leaf[nd["tri"]] = i
    tri_area_inv = np.zeros(t_pad, np.float32)
    tri_area_inv[tris] = 1.0 / np.maximum(area[tris], 1e-20)

    def col(f, dtype=np.float32):
        return np.asarray([f(nd) for nd in nodes], dtype)

    return AtsTables(
        n_nodes=m, root=root,
        left=col(lambda nd: nd["left"], np.int32),
        right=col(lambda nd: nd["right"], np.int32),
        parent=col(lambda nd: nd["parent"], np.int32),
        leaf_tri=col(lambda nd: nd["tri"], np.int32),
        lo=col(lambda nd: nd["b"].lo), hi=col(lambda nd: nd["b"].hi),
        w=col(lambda nd: nd["b"].w),
        cos_o=col(lambda nd: nd["b"].cos_o), cos_e=col(lambda nd: nd["b"].cos_e),
        phi=col(lambda nd: nd["b"].phi),
        tri_leaf=tri_leaf,
        tri_area_inv=tri_area_inv,
        phi_sqr=col(lambda nd: nd["b"].phi_sqr),
        nl=col(lambda nd: nd["b"].nl),
    )


# --------------------------------------------------------------- device ops

def _node_importance(ats: AtsTables, node, p, n=None):
    """importance_point for gathered node ids (emitter.rs:1034-1107)."""
    take = lambda tab: table_take(tab, node)
    lo, hi = take(ats.lo), take(ats.hi)
    w = take(ats.w)
    phi = take(ats.phi)
    cos_o = take(ats.cos_o)
    cos_e = take(ats.cos_e)

    pc = 0.5 * (lo + hi)
    dvec = p - pc
    d2 = jnp.maximum(jnp.sum(dvec * dvec, -1), EPSILON_ATS)
    wi = dvec / jnp.sqrt(d2)[:, None]
    cos_t = jnp.sum(w * wi, -1)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t ** 2, 0.0))

    def cos_sub(sa, ca, sb, cb):
        return jnp.where(ca > cb, 1.0, ca * cb + sa * sb)

    def sin_sub(sa, ca, sb, cb):
        return jnp.where(ca > cb, 1.0, sa * cb - ca * sb)

    # subtended cone of the node bbox from p
    center = pc
    radius = 0.5 * jnp.linalg.norm(hi - lo, axis=-1)
    dist2 = jnp.sum((p - center) ** 2, -1)
    inside = dist2 < radius ** 2
    sin_u2 = jnp.clip(radius ** 2 / jnp.maximum(dist2, 1e-20), 0.0, 1.0)
    cos_u = jnp.where(inside, -1.0, jnp.sqrt(jnp.maximum(1.0 - sin_u2, 0.0)))
    sin_u = jnp.sqrt(jnp.maximum(1.0 - cos_u ** 2, 0.0))

    sin_o = jnp.sqrt(jnp.maximum(1.0 - cos_o ** 2, 0.0))
    cos_x = cos_sub(sin_t, cos_t, sin_o, cos_o)
    sin_x = sin_sub(sin_t, cos_t, sin_o, cos_o)
    cos_p = cos_sub(sin_x, cos_x, sin_u, cos_u)
    ok = cos_p > cos_e

    imp = phi * cos_p / d2
    if n is not None:
        cos_i = jnp.abs(jnp.sum(wi * n, -1))
        sin_i = jnp.sqrt(jnp.maximum(1.0 - cos_i ** 2, 0.0))
        imp = imp * cos_sub(sin_i, cos_i, sin_u, cos_u)
    return jnp.where(ok, jnp.maximum(imp, 0.0), 0.0)


def ats_sample(ats: AtsTables, p, n, u):
    """Stochastic descent (emitter.rs:1361-1399). Returns (tri, pdf_sel)."""
    lanes = p.shape[0]

    def cond(s):
        node, pdf, r = s
        return jnp.any(table_take(ats.leaf_tri, node) < 0)

    def body(s):
        node, pdf, r = s
        is_leaf = table_take(ats.leaf_tri, node) >= 0
        l = table_take(ats.left, node)
        rgt = table_take(ats.right, node)
        il = _node_importance(ats, jnp.maximum(l, 0), p, n)
        ir = _node_importance(ats, jnp.maximum(rgt, 0), p, n)
        tot = il + ir
        p_l = jnp.where(tot > 0.0, il / jnp.maximum(tot, 1e-30), 0.5)
        go_left = r < p_l
        r_new = jnp.where(go_left, r / jnp.maximum(p_l, 1e-20),
                          (r - p_l) / jnp.maximum(1.0 - p_l, 1e-20))
        r_new = jnp.clip(r_new, 0.0, 1.0 - 1e-7)
        node_new = jnp.where(go_left, l, rgt)
        pdf_new = pdf * jnp.where(go_left, p_l, 1.0 - p_l)
        keep = is_leaf
        return (jnp.where(keep, node, node_new),
                jnp.where(keep, pdf, pdf_new),
                jnp.where(keep, r, r_new))

    node0 = jnp.full(lanes, ats.root, jnp.int32)
    node, pdf, _ = jax.lax.while_loop(
        cond, body, (node0, jnp.ones(lanes), u))
    tri = table_take(ats.leaf_tri, node)
    return tri, pdf


def ats_pdf(ats: AtsTables, tri, p, n):
    """Parent-walk pdf of having sampled `tri` (emitter.rs:1319-1359)."""
    lanes = p.shape[0]
    leaf = table_take(ats.tri_leaf, jnp.maximum(tri, 0))
    valid = (tri >= 0) & (leaf >= 0)

    def cond(s):
        node, pdf = s
        return jnp.any(table_take(ats.parent, jnp.maximum(node, 0)) >= 0)

    def body(s):
        node, pdf = s
        par = table_take(ats.parent, jnp.maximum(node, 0))
        active = par >= 0
        l = table_take(ats.left, jnp.maximum(par, 0))
        rgt = table_take(ats.right, jnp.maximum(par, 0))
        il = _node_importance(ats, jnp.maximum(l, 0), p, n)
        ir = _node_importance(ats, jnp.maximum(rgt, 0), p, n)
        tot = il + ir
        p_l = jnp.where(tot > 0.0, il / jnp.maximum(tot, 1e-30), 0.5)
        was_left = l == node
        step = jnp.where(was_left, p_l, 1.0 - p_l)
        return (jnp.where(active, par, node),
                jnp.where(active, pdf * step, pdf))

    node, pdf = jax.lax.while_loop(cond, body, (leaf, jnp.ones(lanes)))
    return jnp.where(valid, pdf, 0.0)


# ----------------------------------------------- ray-segment importance

def _subtended_cos(lo, hi, p):
    """cos of the cone subtending the node's bounding sphere from p
    (DirectionCone::subtended_directions; -1 when p is inside)."""
    center = 0.5 * (lo + hi)
    radius = 0.5 * jnp.linalg.norm(hi - lo, axis=-1)
    dist2 = jnp.sum((p - center) ** 2, -1)
    inside = dist2 < radius ** 2
    sin_u2 = jnp.clip(radius ** 2 / jnp.maximum(dist2, 1e-20), 0.0, 1.0)
    return jnp.where(inside, -1.0, jnp.sqrt(jnp.maximum(1.0 - sin_u2, 0.0)))


def _node_importance_ray(ats: AtsTables, node, o, d, tmax):
    """importance_ray for gathered node ids (emitter.rs:975-1032): cluster
    importance for a whole camera-ray segment [o, o + d*tmax] — used by the
    single-scattering ATS samplers. Mirrors the reference's equiangular-plane
    construction; `tmax` is always finite here (scene hits cap it)."""
    take = lambda tab: table_take(tab, node)
    lo, hi = take(ats.lo), take(ats.hi)
    w = take(ats.w)
    phi = take(ats.phi)
    cos_o = take(ats.cos_o)
    cos_e = take(ats.cos_e)

    pc = 0.5 * (lo + hi)
    # closest point on the segment to the cluster center
    t = jnp.clip(jnp.sum(d * (pc - o), -1), 0.0, tmax)
    closest = o + d * t[:, None]
    d2 = jnp.maximum(jnp.sum((pc - closest) ** 2, -1), EPSILON_ATS)
    d_min = jnp.sqrt(d2)

    v0 = normalize(o - pc)
    v1 = normalize(o + d * tmax[:, None] - pc)
    up = jnp.cross(v0, v1)
    up_l = jnp.linalg.norm(up, axis=-1, keepdims=True)
    degenerate = up_l[:, 0] < 1e-12   # v0 ~ v1: zero-extent segment plane
    up = up / jnp.maximum(up_l, 1e-20)
    o0 = v0
    o1 = jnp.cross(up, v0)

    dot_o0 = jnp.sum(o0 * w, -1)
    dot_o1 = jnp.sum(o1 * w, -1)
    l1 = jnp.sqrt(jnp.maximum(dot_o0 ** 2 + dot_o1 ** 2, 1e-20))
    cos_phi0 = dot_o0 / l1
    sin_phi0 = jnp.sqrt(jnp.maximum(1.0 - cos_phi0 ** 2, 0.0))
    outside = (dot_o1 < 0.0) | (jnp.sum(v0 * v1, -1) < cos_phi0) | degenerate
    cos_tmin = jnp.where(
        outside,
        jnp.maximum(jnp.sum(v0 * w, -1), jnp.sum(v1 * w, -1)),
        jnp.sum((o0 * cos_phi0[:, None] + o1 * sin_phi0[:, None]) * w, -1))
    theta_min = jnp.arccos(jnp.clip(cos_tmin, -1.0, 1.0))

    theta_o = jnp.arccos(jnp.clip(cos_o, -1.0, 1.0))
    theta_e = jnp.arccos(jnp.clip(cos_e, -1.0, 1.0))
    theta_u = jnp.arccos(jnp.clip(_subtended_cos(lo, hi, closest), -1.0, 1.0))
    theta_p = jnp.maximum(theta_min - theta_o - theta_u, 0.0)
    imp = jnp.maximum(phi * jnp.cos(theta_p) / d_min, 0.0)
    return jnp.where(theta_p >= theta_e, 0.0, imp)


def _ats_descend(ats: AtsTables, imp_fn, u):
    """Stochastic importance descent shared by the point- and ray-based
    samplers (emitter.rs:1361-1399). Returns (tri, pdf_sel)."""
    lanes = u.shape[0]

    def cond(s):
        node, pdf, r = s
        return jnp.any(table_take(ats.leaf_tri, node) < 0)

    def body(s):
        node, pdf, r = s
        is_leaf = table_take(ats.leaf_tri, node) >= 0
        l = table_take(ats.left, node)
        rgt = table_take(ats.right, node)
        il = imp_fn(jnp.maximum(l, 0))
        ir = imp_fn(jnp.maximum(rgt, 0))
        tot = il + ir
        p_l = jnp.where(tot > 0.0, il / jnp.maximum(tot, 1e-30), 0.5)
        go_left = r < p_l
        r_new = jnp.where(go_left, r / jnp.maximum(p_l, 1e-20),
                          (r - p_l) / jnp.maximum(1.0 - p_l, 1e-20))
        r_new = jnp.clip(r_new, 0.0, 1.0 - 1e-7)
        node_new = jnp.where(go_left, l, rgt)
        pdf_new = pdf * jnp.where(go_left, p_l, 1.0 - p_l)
        return (jnp.where(is_leaf, node, node_new),
                jnp.where(is_leaf, pdf, pdf_new),
                jnp.where(is_leaf, r, r_new))

    node0 = jnp.full(lanes, ats.root, jnp.int32)
    node, pdf, _ = jax.lax.while_loop(cond, body, (node0, jnp.ones(lanes), u))
    return table_take(ats.leaf_tri, node), pdf


def ats_sample_ray(ats: AtsTables, o, d, tmax, u):
    """Ray-importance descent (random_sample_emitter_position_ray,
    emitter.rs:1731-1756)."""
    return _ats_descend(
        ats, lambda nd: _node_importance_ray(ats, nd, o, d, tmax), u)


def _variance_g_ray(ats: AtsTables, node, o, d, tmax):
    """Geometric expectation/variance of 1/d over the segment for a node's
    bounding sphere (emitter.rs:1679-1715): eg = (ln b - ln a)/(b - a),
    vg = 1/(a*b) with a/b the min/max sphere-surface distances (the reference
    clamps the far evaluation point at 10 units along the ray)."""
    take = lambda tab: table_take(tab, node)
    lo, hi = take(ats.lo), take(ats.hi)
    c = 0.5 * (lo + hi)
    r = 0.5 * jnp.linalg.norm(hi - lo, axis=-1)

    b1 = jnp.sum((o - c) ** 2, -1)
    p_far = o + d * jnp.minimum(tmax, 10.0)[:, None]
    b2 = jnp.sum((p_far - c) ** 2, -1)
    b = jnp.maximum(b1, b2)
    b = jnp.where(b < r ** 2, EPSILON_ATS,
                  jnp.maximum(jnp.sqrt(b) - r, EPSILON_ATS))

    t = jnp.clip(jnp.sum(d * (c - o), -1), 0.0, tmax)
    a2 = jnp.sum((o + d * t[:, None] - c) ** 2, -1)
    a = jnp.where(a2 < r ** 2, EPSILON_ATS,
                  jnp.maximum(jnp.sqrt(a2) - r, EPSILON_ATS))

    diff = b - a
    eg = jnp.where(jnp.abs(diff) > 1e-12,
                   (jnp.log(b) - jnp.log(a)) / jnp.where(
                       jnp.abs(diff) > 1e-12, diff, 1.0),
                   1.0 / jnp.maximum(a, EPSILON_ATS))
    vg = 1.0 / jnp.maximum(a * b, 1e-20)
    return eg, vg


def ats_sample_split(ats: AtsTables, o, d, tmax, u, u_stack,
                     splitting_factor: float, max_lights: int = 8):
    """Variance-driven splitting traversal (sample_split,
    emitter.rs:1401-1487): nodes whose combined energy+geometry variance
    measure falls below `splitting_factor` traverse BOTH children; others
    pick one child by ray importance. Returns fixed-size slots
    (tri [n,K], pdf_sel [n,K], valid [n,K]).

    Wavefront form: the reference's recursion + Vec become a bounded explicit
    stack ([n, D] node/pdf/r arrays) inside one lax.while_loop; extra
    branch randoms come from the pre-drawn `u_stack` [n, D]. Selection is
    capped at K = max_lights slots (the reference is unbounded; with the
    paper's factors the split set is small — overflow lanes drop extra
    lights and are reported by the returned `overflow` mask)."""
    n = u.shape[0]
    D = max_lights + 32   # stack bound: queued splits + tree depth
    K = max_lights

    imp = lambda nd: _node_importance_ray(ats, nd, o, d, tmax)

    out_tri = jnp.full((n, K), -1, jnp.int32)
    out_pdf = jnp.zeros((n, K), jnp.float32)
    st_node = jnp.zeros((n, D), jnp.int32)
    st_pdf = jnp.zeros((n, D), jnp.float32)
    st_r = jnp.zeros((n, D), jnp.float32)
    state = dict(node=jnp.full(n, ats.root, jnp.int32),
                 pdf=jnp.ones(n, jnp.float32), r=u,
                 sp=jnp.zeros(n, jnp.int32),      # stack size
                 cnt=jnp.zeros(n, jnp.int32),     # selected count
                 running=jnp.ones(n, bool), overflow=jnp.zeros(n, bool),
                 out_tri=out_tri, out_pdf=out_pdf,
                 st_node=st_node, st_pdf=st_pdf, st_r=st_r)

    d_iota = jax.lax.broadcasted_iota(jnp.int32, (n, D), 1)
    k_iota = jax.lax.broadcasted_iota(jnp.int32, (n, K), 1)

    def cond(s):
        return jnp.any(s["running"])

    def body(s):
        node = s["node"]
        leaf_tri = table_take(ats.leaf_tri, node)
        is_leaf = leaf_tri >= 0

        # ---------- leaf: emit a slot if importance > 0
        leaf_imp = imp(node)
        emit = s["running"] & is_leaf & (leaf_imp > 0.0)
        can = emit & (s["cnt"] < K)
        slot = (k_iota == s["cnt"][:, None]) & can[:, None]
        out_tri = jnp.where(slot, leaf_tri[:, None], s["out_tri"])
        out_pdf = jnp.where(slot, s["pdf"][:, None], s["out_pdf"])
        cnt = s["cnt"] + jnp.where(can, 1, 0)
        overflow = s["overflow"] | (emit & (s["cnt"] >= K))

        # ---------- internal: split or choose one child
        l = table_take(ats.left, node)
        rgt = table_take(ats.right, node)
        lmask = jnp.maximum(l, 0)
        rmask = jnp.maximum(rgt, 0)
        take = lambda tab: table_take(tab, node)
        phi = take(ats.phi)
        phi_sqr = take(ats.phi_sqr)
        nl = jnp.maximum(take(ats.nl), 1.0)
        ve = phi_sqr / nl - (phi / nl) ** 2
        eg, vg = _variance_g_ray(ats, node, o, d, tmax)
        sm = ve * vg + ve * eg ** 2 + phi ** 2 * vg
        split_measure = (1.0 / (1.0 + nl * nl * sm)) ** 0.25
        do_split = split_measure < splitting_factor

        il = imp(lmask)
        ir = imp(rmask)
        tot = il + ir
        dead_int = s["running"] & (~is_leaf) & (~do_split) & (tot <= 0.0)
        p_l = jnp.where(tot > 0.0, il / jnp.maximum(tot, 1e-30), 0.5)
        go_left = s["r"] < p_l
        ch_node = jnp.where(go_left, l, rgt)
        ch_pdf = s["pdf"] * jnp.where(go_left, p_l, 1.0 - p_l)
        ch_r = jnp.clip(jnp.where(go_left, s["r"] / jnp.maximum(p_l, 1e-20),
                                  (s["r"] - p_l) / jnp.maximum(1.0 - p_l,
                                                               1e-20)),
                        0.0, 1.0 - 1e-7)

        # split: push left on the stack (with a fresh random), descend right
        pushing = s["running"] & (~is_leaf) & do_split & (s["sp"] < D)
        sslot = (d_iota == s["sp"][:, None]) & pushing[:, None]
        st_node = jnp.where(sslot, l[:, None], s["st_node"])
        st_pdf = jnp.where(sslot, s["pdf"][:, None], s["st_pdf"])
        push_r = jnp.sum(jnp.where(sslot, u_stack, 0.0), -1)
        st_r = jnp.where(sslot, push_r[:, None], s["st_r"])
        sp = s["sp"] + jnp.where(pushing, 1, 0)

        node_n = jnp.where(is_leaf, node,
                           jnp.where(do_split, rgt, ch_node))
        pdf_n = jnp.where(is_leaf, s["pdf"],
                          jnp.where(do_split, s["pdf"], ch_pdf))
        r_n = jnp.where(is_leaf, s["r"],
                        jnp.where(do_split, s["r"], ch_r))

        # ---------- pop the stack after a leaf emit / dead branch
        want_pop = (s["running"] & is_leaf) | dead_int
        has_stack = sp > 0
        pop = want_pop & has_stack
        psel = (d_iota == (sp - 1)[:, None]) & pop[:, None]
        node_n = jnp.where(pop, jnp.sum(jnp.where(psel, st_node, 0), -1),
                           node_n)
        pdf_n = jnp.where(pop, jnp.sum(jnp.where(psel, st_pdf, 0.0), -1),
                          pdf_n)
        r_n = jnp.where(pop, jnp.sum(jnp.where(psel, st_r, 0.0), -1), r_n)
        sp = sp - jnp.where(pop, 1, 0)
        running = s["running"] & ~(want_pop & (~has_stack))

        return dict(node=node_n.astype(jnp.int32), pdf=pdf_n, r=r_n, sp=sp,
                    cnt=cnt, running=running, overflow=overflow,
                    out_tri=out_tri, out_pdf=out_pdf,
                    st_node=st_node, st_pdf=st_pdf, st_r=st_r)

    out = jax.lax.while_loop(cond, body, state)
    valid = out["out_tri"] >= 0
    return out["out_tri"], out["out_pdf"], valid, out["overflow"]
