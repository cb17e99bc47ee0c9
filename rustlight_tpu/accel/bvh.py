"""Flattened BVH: native C++ binned-SAH build + stackless device traversal.

Build (host): the C++ builder (accel/native/bvh_builder.cpp, compiled on
first use and loaded via ctypes) — the framework's native equivalent of the
reference's Rust SAH builder / Embree backend (src/accel.rs:79-344, 346-416).
A pure-numpy median-split fallback covers environments without a compiler.

Traversal (device): a preorder skip-link walk per ray, vmapped over the
wavefront inside one lax.while_loop — box hit -> next node (i+1), miss or
leaf -> skip link. Leaves test their primitive range with the same
Baldwin-Weber rows as the dense intersector, written as elementwise f32
products (exact f32, no matrix unit). Node and row fetches are per-lane
gathers. Closest-hit breaks exact ties in t by the lower original triangle
id, as the dense scan does; any-hit retires a lane at its first hit.

This is the large-scene tier (scenes above geometry.BVH_THRESHOLD); for
Cornell-box-class scenes the dense intersector (accel/dense.py) wins.
"""
from __future__ import annotations

import ctypes
import subprocess
from functools import partial
from pathlib import Path
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .. import EPSILON
from ..utils import pytree
from .dense import RayHit

_NATIVE_DIR = Path(__file__).parent / "native"
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _load_native():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    so = _NATIVE_DIR / "libbvh.so"
    src = _NATIVE_DIR / "bvh_builder.cpp"
    try:
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", str(so), str(src)],
                check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        sig = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
               ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        lib.rl_build_bvh.restype = ctypes.c_int
        lib.rl_build_bvh.argtypes = sig
        lib.rl_build_bvh_sweep.restype = ctypes.c_int
        lib.rl_build_bvh_sweep.argtypes = sig
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


def _build_numpy(aabbs: np.ndarray, max_leaf: int):
    """Median-split fallback builder (same node layout)."""
    n = aabbs.shape[0]
    cent = 0.5 * (aabbs[:, :3] + aabbs[:, 3:])
    order = np.arange(n, dtype=np.int32)
    nodes = []

    def recurse(begin, end):
        idx = len(nodes)
        sel = order[begin:end]
        lo = aabbs[sel, :3].min(0)
        hi = aabbs[sel, 3:].max(0)
        nodes.append([lo, hi, -1, begin, 0])
        count = end - begin
        if count <= max_leaf:
            nodes[idx][4] = count
            return idx
        axis = int(np.argmax(cent[sel].max(0) - cent[sel].min(0)))
        mid = begin + count // 2
        part = np.argsort(cent[sel, axis], kind="stable")
        order[begin:end] = sel[part]
        recurse(begin, mid)
        right = recurse(mid, end)
        nodes[idx][3] = right
        return idx

    def fix(idx, skip):
        nodes[idx][2] = skip
        if nodes[idx][4] > 0:
            return
        right = nodes[idx][3]
        nodes[idx][3] = 0
        fix(idx + 1, right)
        fix(right, skip)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        recurse(0, n)
        fix(0, -1)
    finally:
        sys.setrecursionlimit(old)
    out = np.zeros((len(nodes), 9), np.float32)
    for i, (lo, hi, skip, start, cnt) in enumerate(nodes):
        out[i, :3] = lo
        out[i, 3:6] = hi
        out[i, 6:9] = np.asarray([skip, start, cnt], np.int32).view(np.float32)
    return out, order


@pytree.dataclass
class BvhTables:
    n_nodes: int = pytree.field(static=True)
    leaf_size: int = pytree.field(static=True)
    bbox_lo: Any      # [m, 3]
    bbox_hi: Any      # [m, 3]
    skip: Any         # [m] int32 preorder skip link (-1 ends the walk)
    prim_start: Any   # [m] int32 first primitive of a leaf
    prim_count: Any   # [m] int32 primitives in a leaf (0 = inner node)
    # Baldwin-Weber rows reordered into leaf-contiguous order and flattened
    # ([t + leaf_size, 3, 4] -> 1-D); the zero tail keeps every leaf-wide
    # fetch in range
    rows: Any         # [(t + leaf_size) * 12] f32
    prim_index: Any   # [t + leaf_size] int32 original triangle ids


def build_bvh(geom, max_leaf: int = 8, builder: str = "binned") -> BvhTables:
    """Build from GeometryTables (uses only the real, unpadded triangles).

    builder: "binned" (16-bin SAH, the default) or "sweep" (full SAH sweep,
    the reference's exact algorithm src/accel.rs:115-199 — higher build
    cost, occasionally tighter trees). Returns numpy leaves; Scene.compile
    moves them to the device with the rest of the scene."""
    if hasattr(geom, "host") and geom.host is not None:  # SceneData passed
        geom = geom.host.data.geom
    v0 = np.asarray(geom.v0[: geom.n_tris])
    e1 = np.asarray(geom.e1[: geom.n_tris])
    e2 = np.asarray(geom.e2[: geom.n_tris])
    p1 = v0 + e1
    p2 = v0 + e2
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    aabbs = np.concatenate([lo, hi], -1).astype(np.float32)
    n = aabbs.shape[0]

    lib = _load_native()
    if lib is not None:
        nodes_buf = np.zeros((2 * n, 9), np.float32)
        order = np.zeros(n, np.int32)
        entry = (lib.rl_build_bvh_sweep if builder == "sweep"
                 else lib.rl_build_bvh)
        cnt = entry(
            aabbs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, max_leaf,
            nodes_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        nodes = nodes_buf[:cnt]
    else:
        nodes, order = _build_numpy(aabbs, max_leaf)

    ints = nodes[:, 6:9].view(np.int32)
    if ints[:, 2].max(initial=0) > max_leaf:
        # the walk tests leaf_size rows per leaf; a wider leaf would
        # silently drop triangles
        raise RuntimeError("BVH build produced a leaf wider than max_leaf")
    rows = np.asarray(geom.inter_rows[: geom.n_tris])[order]
    rows = np.concatenate(
        [rows, np.zeros((max_leaf, 3, 4), np.float32)], axis=0)
    prim_index = np.concatenate(
        [order.astype(np.int32), np.full(max_leaf, -1, np.int32)])
    return BvhTables(
        n_nodes=nodes.shape[0], leaf_size=max_leaf,
        bbox_lo=nodes[:, :3].copy(), bbox_hi=nodes[:, 3:6].copy(),
        skip=ints[:, 0].copy(), prim_start=ints[:, 1].copy(),
        prim_count=ints[:, 2].copy(),
        rows=rows.reshape(-1), prim_index=prim_index,
    )


_NO_ID = np.iinfo(np.int32).max
# widen each slab exit so rounding in (box - o) / d never drops a box that
# a hit point lies on (PBRT's 1 + 2*gamma(3) conservative traversal)
_EXIT_SCALE = 1.0 + 4e-7


@partial(jax.jit, static_argnames=("any_hit",))
def _bvh_impl(bvh: BvhTables, o, d, tnear, tfar, any_hit: bool):
    k = bvh.leaf_size
    j_iota = lax.iota(jnp.int32, k)
    row_iota = lax.iota(jnp.int32, 12 * k)

    def one_ray(o1, d1, tn, tf):
        inv_d = 1.0 / jnp.where(jnp.abs(d1) > 1e-12, d1,
                                jnp.where(d1 >= 0, 1e-12, -1e-12))

        def cond(s):
            go = s[0] >= 0
            if any_hit:
                go = go & ~jnp.isfinite(s[1])
            return go

        def body(s):
            node, best_t, best_i, best_u, best_v = s
            t0 = (bvh.bbox_lo[node] - o1) * inv_d
            t1 = (bvh.bbox_hi[node] - o1) * inv_d
            entry = jnp.maximum(jnp.max(jnp.minimum(t0, t1)), tn)
            exit_ = jnp.min(jnp.maximum(t0, t1)) * _EXIT_SCALE
            hit_box = (exit_ >= entry) & (entry <= jnp.minimum(best_t, tf))
            cnt = bvh.prim_count[node]
            leaf = cnt > 0
            start = bvh.prim_start[node]

            # leaf test; under vmap a lax.cond would run both sides anyway
            r = jnp.take(bvh.rows, start * 12 + row_iota).reshape(k, 3, 4)
            ao = (r[:, :, 0] * o1[0] + r[:, :, 1] * o1[1]
                  + r[:, :, 2] * o1[2] + r[:, :, 3])        # [k, (N, U, V)]
            ad = r[:, :, 0] * d1[0] + r[:, :, 1] * d1[1] + r[:, :, 2] * d1[2]
            live = jnp.abs(ad[:, 0]) > 1e-20
            t = -ao[:, 0] / jnp.where(live, ad[:, 0], 1.0)
            u = ao[:, 1] + t * ad[:, 1]
            v = ao[:, 2] + t * ad[:, 2]
            valid = (live & (t > tn) & (t < tf)
                     & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                     & (j_iota < cnt) & hit_box & leaf)
            ids = jnp.take(bvh.prim_index, start + j_iota)
            tm = jnp.where(valid, t, jnp.inf)
            ct = jnp.min(tm)
            cid = jnp.min(jnp.where(tm == ct, ids, _NO_ID))
            sel = (tm == ct) & (ids == cid)
            better = jnp.isfinite(ct) & (
                (ct < best_t) | ((ct == best_t) & (cid < best_i)))
            best_t = jnp.where(better, ct, best_t)
            best_i = jnp.where(better, cid, best_i)
            best_u = jnp.where(better, jnp.sum(jnp.where(sel, u, 0.0)),
                               best_u)
            best_v = jnp.where(better, jnp.sum(jnp.where(sel, v, 0.0)),
                               best_v)
            nxt = jnp.where(hit_box & ~leaf, node + 1, bvh.skip[node])
            return nxt, best_t, best_i, best_u, best_v

        init = (jnp.int32(0), jnp.float32(jnp.inf), jnp.int32(_NO_ID),
                jnp.float32(0.0), jnp.float32(0.0))
        _, bt, bi, bu, bv = lax.while_loop(cond, body, init)
        return bt, bi, bu, bv

    bt, bi, bu, bv = jax.vmap(one_ray)(o, d, tnear, tfar)
    hit = jnp.isfinite(bt)
    if any_hit:
        return hit
    return RayHit(t=bt, tri=jnp.where(hit, bi, -1), u=bu, v=bv, hit=hit)


def _default_range(n, tnear, tfar):
    if tnear is None:
        tnear = jnp.full(n, EPSILON, jnp.float32)
    if tfar is None:
        tfar = jnp.full(n, jnp.inf, jnp.float32)
    return tnear, tfar


def intersect_bvh(bvh: BvhTables, o, d, tnear=None, tfar=None) -> RayHit:
    """Closest hit of a ray wavefront o, d [n, 3] in (tnear, tfar)."""
    tnear, tfar = _default_range(o.shape[0], tnear, tfar)
    return _bvh_impl(bvh, o, d, tnear, tfar, False)


def occluded_bvh(bvh: BvhTables, o, d, tnear=None, tfar=None):
    """Any-hit (shadow ray) test; True = blocked. Each lane stops at its
    first hit."""
    tnear, tfar = _default_range(o.shape[0], tnear, tfar)
    return _bvh_impl(bvh, o, d, tnear, tfar, True)
