"""Single-scattering photon planes from rectangular lights (Deng et al. 2019).

Reference: src/integrators/explicit/plane_single.rs (+ the uncorrelated
variant, uncorrelated_plane_single.rs). Plane types:
  UV     — the whole light rectangle swept along the emission direction,
           weight pi*Le/sigma_s (distance importance-sampled)
  UT/VT  — one light edge x emission direction, weight pi*edge_len*Le
  UAlphaT— random oriented line through the rectangle x direction,
           weight pi*Le*area/line_len
Strategies: single-type, average (1/3 each), discrete MIS over {UV,UT,VT}
(inverse-contribution weights, plane_single.rs:493-560), and continuous MIS
for UAlphaT (closed form, plane_single.rs:567-584).

Wavefront form: plane pools are SoA arrays; camera rays intersect every plane in
chunked dense sweeps (same pattern as vol_primitives). The uncorrelated
variant generates one private plane per lane per sample instead of a pool.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..accel import intersect_rays, visible
from ..scene import generate_rays
from ..scene.volume import phase_eval, volume_sample_distance
from ..utils.frame import make_frame, to_world
from ..utils.rng import stream_next, stream_next2d, stream_fold
from ..utils.warps import cosine_sample_hemisphere
from .common import Integrator

_PI = jnp.pi

PLANE_UV = 0
PLANE_UT = 1
PLANE_VT = 2
PLANE_UALPHA = 3

STRATEGIES = ("uv", "ut", "vt", "average", "dmis", "ualpha", "cmis")


def extract_rect_lights(scene) -> Dict[str, np.ndarray]:
    """Recover rectangular emitters from the flattened geometry: each emissive
    mesh must be a quad (two triangles sharing v0), as the reference requires
    (plane_single.rs:37-75)."""
    geom = scene.geom
    eid = np.asarray(geom.emitter_id[: geom.n_tris])
    mid = np.asarray(geom.mesh_id[: geom.n_tris])
    v0 = np.asarray(geom.v0[: geom.n_tris])
    e1 = np.asarray(geom.e1[: geom.n_tris])
    e2 = np.asarray(geom.e2[: geom.n_tris])
    le = np.asarray(scene.emitters.tri_emission[: geom.n_tris])

    lights = {"o": [], "u": [], "v": [], "u_l": [], "v_l": [], "n": [], "e": []}
    for m in np.unique(mid[eid >= 0]):
        tris = np.nonzero((mid == m) & (eid >= 0))[0]
        assert len(tris) == 2, "plane_single supports rectangular emitters only"
        t0, t1 = tris
        o = v0[t0]
        u_vec = e1[t0]          # p1 - p0
        v_vec = e2[t1]          # p3 - p0 (make_quad layout)
        u_l = np.linalg.norm(u_vec)
        v_l = np.linalg.norm(v_vec)
        u_n = u_vec / u_l
        v_n = v_vec / v_l
        lights["o"].append(o)
        lights["u"].append(u_n)
        lights["v"].append(v_n)
        lights["u_l"].append(u_l)
        lights["v_l"].append(v_l)
        lights["n"].append(np.cross(u_n, v_n))
        lights["e"].append(le[t0])
    return {k: np.asarray(v, np.float32) for k, v in lights.items()}


class IntegratorSinglePlane(Integrator):
    def __init__(self, nb_primitive: int = 512, strategy: str = "average",
                 plane_chunk: int = 64, uncorrelated: bool = False):
        assert strategy in STRATEGIES
        self.nb_primitive = nb_primitive
        self.strategy = strategy
        self.plane_chunk = plane_chunk
        self.uncorrelated = uncorrelated

    # ------------------------------------------------------- plane sampling
    def _gen_planes(self, scene, rl, kinds, count, stream):
        """Generate `count` planes per kind in `kinds`; returns SoA dict."""
        vol = scene.volume
        n_lights = rl["o"].shape[0]
        u_sel, stream = stream_next(stream, (count,))
        lid = jnp.clip((u_sel * n_lights).astype(jnp.int32), 0, n_lights - 1)

        def g(field):
            return jnp.asarray(rl[field])[lid]

        lo, lu, lv, ln = g("o"), g("u"), g("v"), g("n")
        lul, lvl, lem = g("u_l"), g("v_l"), g("e")

        u_d, stream = stream_next2d(stream, (count,))
        d_loc = cosine_sample_hemisphere(u_d)
        d = to_world(make_frame(ln), d_loc)
        u_t, stream = stream_next(stream, (count,))
        sd = volume_sample_distance(vol, jnp.full(count, 1e8), u_t)
        t_sampled = sd.continued_t
        smp, stream = stream_next2d(stream, (count,))
        s_alpha, stream = stream_next(stream, (count,))

        out = {}
        for kind in kinds:
            if kind == PLANE_UV:
                o = lo + d * t_sampled[:, None]
                d0, d1 = lu, lv
                l0, l1 = lul, lvl
                w = _PI * lem / jnp.maximum(vol.sigma_s, 1e-20)[None, :]
            elif kind == PLANE_VT:
                o = lo + lu * (lul * smp[:, 0])[:, None]
                d0, d1 = lv, d
                l0, l1 = lvl, t_sampled
                w = _PI * lul[:, None] * lem
            elif kind == PLANE_UT:
                o = lo + lv * (lvl * smp[:, 1])[:, None]
                d0, d1 = lu, d
                l0, l1 = lul, t_sampled
                w = _PI * lvl[:, None] * lem
            else:  # UAlphaT: random line across the rectangle
                alpha = _PI * s_alpha
                o2 = jnp.stack([smp[:, 0] * lul, smp[:, 1] * lvl], -1)
                d2 = jnp.stack([jnp.cos(alpha), jnp.sin(alpha)], -1)

                def hit2d(d2_, o2_):
                    safe = jnp.where(jnp.abs(d2_) > 1e-12, d2_,
                                     jnp.where(d2_ >= 0, 1e-12, -1e-12))
                    t0_ = (-o2_) / safe
                    t1_ = (jnp.stack([lul, lvl], -1) - o2_) / safe
                    tmax = jnp.maximum(t0_, t1_)
                    return o2_ + d2_ * jnp.min(tmax, axis=-1, keepdims=True)

                p1 = hit2d(d2, o2)
                p2 = hit2d(-d2, o2)
                p1w = lo + lu * p1[:, 0:1] + lv * p1[:, 1:2]
                p2w = lo + lu * p2[:, 0:1] + lv * p2[:, 1:2]
                uvec = p2w - p1w
                ulen = jnp.maximum(jnp.linalg.norm(uvec, axis=-1), 1e-8)
                o = p1w
                d0 = uvec / ulen[:, None]
                d1 = d
                l0, l1 = ulen, t_sampled
                w = _PI * lem * (lul * lvl / ulen)[:, None]
            out[kind] = dict(o=o, d0=d0, d1=d1, l0=l0, l1=l1, w=w,
                             lid=lid, t0_smp=smp[:, 0], t1_smp=smp[:, 1],
                             valid=jnp.ones(count, bool))
        return out, stream

    def _plane_contrib(self, scene, rl, plane, kind, o, d, tfar, n):
        """Intersect all rays with one plane chunk and accumulate."""
        vol = scene.volume
        e0 = plane["d0"] * plane["l0"][:, None]
        e1 = plane["d1"] * plane["l1"][:, None]
        pvec = jnp.cross(d[:, None, :], e1[None])
        det = jnp.sum(e0[None] * pvec, -1)
        ok = jnp.abs(det) >= 1e-6
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tvec = o[:, None, :] - plane["o"][None]
        t0 = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, jnp.broadcast_to(e0[None], tvec.shape))
        t1 = jnp.sum(d[:, None, :] * qvec, -1) * inv_det
        t_cam = jnp.sum(e1[None] * qvec, -1) * inv_det
        ok = (ok & (t0 >= 0.0) & (t0 <= 1.0) & (t1 >= 0.0) & (t1 <= 1.0)
              & (t_cam > 1e-4) & (t_cam < tfar[:, None]) & plane["valid"][None])

        p_hit = o[:, None, :] + d[:, None, :] * t_cam[..., None]
        lid = plane["lid"]
        lo = jnp.asarray(rl["o"])[lid][None]
        lu = jnp.asarray(rl["u"])[lid][None]
        lv = jnp.asarray(rl["v"])[lid][None]
        if kind == PLANE_UV:
            p_light = (lo + lu * (t0 * plane["l0"][None])[..., None]
                       + lv * (t1 * plane["l1"][None])[..., None])
        else:
            p_light = plane["o"][None] + plane["d0"][None] \
                * (t0 * plane["l0"][None])[..., None]

        vc = plane["o"].shape[0]
        vis = visible(scene.geom, p_hit.reshape(-1, 3),
                      p_light.reshape(-1, 3)).reshape(n, vc)
        tr = jnp.exp(-vol.sigma_t[None, None, :] * t_cam[..., None])
        dl = p_light - p_hit
        dl = dl / jnp.maximum(jnp.linalg.norm(dl, axis=-1, keepdims=True), 1e-12)
        rho = phase_eval(vol.phase_g, -d[:, None, :], dl)

        jac = jnp.abs(jnp.sum(jnp.cross(plane["d1"], plane["d0"])[None]
                              * d[:, None, :], -1))
        flux = plane["w"][None] / jnp.maximum(jac, 1e-12)[..., None]

        if self.strategy == "average":
            w_mis = jnp.full_like(jac, 1.0 / 3.0)
        elif self.strategy == "dmis":
            # rebuild the three contribs for the hit pair (plane_single.rs:500+)
            lem = jnp.asarray(rl["e"])[lid][None]
            lul = jnp.asarray(rl["u_l"])[lid][None]
            lvl = jnp.asarray(rl["v_l"])[lid][None]
            sig = jnp.mean(vol.sigma_s)
            d_pl = -dl  # light -> hit direction
            j_uv = jnp.abs(jnp.sum(jnp.cross(d_pl, lu) * d[:, None, :], -1))
            j_ut = jnp.abs(jnp.sum(jnp.cross(d_pl, lu) * d[:, None, :], -1))
            j_vt = jnp.abs(jnp.sum(jnp.cross(d_pl, lv) * d[:, None, :], -1))
            lem_avg = jnp.mean(lem, -1)
            c_uv = _PI * lem_avg / jnp.maximum(sig, 1e-20) / jnp.maximum(
                jnp.abs(jnp.sum(jnp.cross(lv, lu)[0:1] * d[:, None, :], -1)), 1e-12)
            c_ut = _PI * lvl * lem_avg / jnp.maximum(j_ut, 1e-12)
            c_vt = _PI * lul * lem_avg / jnp.maximum(j_vt, 1e-12)
            inv = lambda c: jnp.where((c > 0) & jnp.isfinite(c), 1.0 / c, 0.0)
            c_self = {PLANE_UV: c_uv, PLANE_UT: c_ut, PLANE_VT: c_vt}[kind]
            w_mis = inv(c_self) / jnp.maximum(
                inv(c_uv) + inv(c_ut) + inv(c_vt), 1e-30)
            w_mis = jnp.where(jnp.isfinite(w_mis), w_mis, 0.0)
        elif self.strategy == "cmis":
            w_cmis = 1.0 / jnp.maximum(
                (2.0 / _PI) * jnp.sqrt(
                    jnp.sum(jnp.cross(lu, plane["d1"][None]) * d[:, None, :], -1) ** 2
                    + jnp.sum(jnp.cross(lv, plane["d1"][None]) * d[:, None, :], -1) ** 2),
                1e-12)
            flux = plane["w"][None] * w_cmis[..., None]
            w_mis = jnp.ones_like(jac)
        else:
            w_mis = jnp.ones_like(jac)

        contrib = (flux * tr * (w_mis * rho)[..., None]
                   * vol.sigma_s[None, None, :])
        return jnp.where((ok & vis)[..., None], contrib, 0.0).sum(1)

    # ---------------------------------------------------------------- main
    def compute_pixel(self, scene, pix, stream):
        assert scene.volume is not None, "plane_single needs a medium (-m)"
        rl = self._rect_lights(scene)
        n = pix.shape[0]
        n_lights = rl["o"].shape[0]

        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.astype(jnp.float32) + u_pix)
        rh = intersect_rays(scene.geom, o, d)
        tfar = jnp.where(rh.hit, rh.t, 1e8)

        kinds = {
            "uv": [PLANE_UV], "ut": [PLANE_UT], "vt": [PLANE_VT],
            "average": [PLANE_UV, PLANE_UT, PLANE_VT],
            "dmis": [PLANE_UV, PLANE_UT, PLANE_VT],
            "ualpha": [PLANE_UALPHA], "cmis": [PLANE_UALPHA],
        }[self.strategy]

        if self.uncorrelated:
            # one private plane (set) per lane (uncorrelated_plane_single.rs)
            planes, stream = self._gen_planes(scene, rl, kinds, n,
                                              stream_fold(stream, 5))
            li = jnp.zeros((n, 3))
            for kind in kinds:
                pl = planes[kind]
                li = li + self._contrib_private(scene, rl, pl, kind, o, d, tfar)
            return li * n_lights

        rounds = max(1, self.nb_primitive)
        planes, stream = self._gen_planes(scene, rl, kinds, rounds,
                                          stream_fold(stream, 5))
        li = jnp.zeros((n, 3))
        vc = self.plane_chunk
        for kind in kinds:
            pl = planes[kind]
            total = rounds
            n_chunks = (total + vc - 1) // vc
            pad = n_chunks * vc - total

            def padv(x):
                if pad == 0:
                    return x
                z = jnp.zeros((pad,) + x.shape[1:], x.dtype)
                return jnp.concatenate([x, z], 0)

            chunks = {k: padv(v).reshape(n_chunks, vc, *v.shape[1:])
                      for k, v in pl.items()}

            def body(acc, c):
                return acc + self._plane_contrib(scene, rl, c, kind, o, d,
                                                 tfar, n), None

            li_k, _ = lax.scan(body, jnp.zeros((n, 3)), chunks)
            li = li + li_k
        return li * (n_lights / rounds)

    def _contrib_private(self, scene, rl, pl, kind, o, d, tfar):
        """Per-lane single-plane contribution (uncorrelated variant)."""
        n = o.shape[0]
        chunk = {k: v[:, None] if v.ndim == 1 else v[:, None, :]
                 for k, v in pl.items()}
        # reuse the pairwise path with vc=1 by reshaping
        one = {k: v.reshape((n,) + v.shape[2:]) for k, v in chunk.items()}
        # build a [n, 1]-style evaluation by treating each lane's plane as its
        # own chunk: direct evaluation
        vol = scene.volume
        e0 = one["d0"] * one["l0"][:, None]
        e1 = one["d1"] * one["l1"][:, None]
        pvec = jnp.cross(d, e1)
        det = jnp.sum(e0 * pvec, -1)
        ok = jnp.abs(det) >= 1e-6
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tvec = o - one["o"]
        t0 = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, e0)
        t1 = jnp.sum(d * qvec, -1) * inv_det
        t_cam = jnp.sum(e1 * qvec, -1) * inv_det
        ok = (ok & (t0 >= 0) & (t0 <= 1) & (t1 >= 0) & (t1 <= 1)
              & (t_cam > 1e-4) & (t_cam < tfar))
        p_hit = o + d * t_cam[:, None]
        lid = one["lid"]
        lo = jnp.asarray(rl["o"])[lid]
        lu = jnp.asarray(rl["u"])[lid]
        lv = jnp.asarray(rl["v"])[lid]
        if kind == PLANE_UV:
            p_light = lo + lu * (t0 * one["l0"])[:, None] \
                + lv * (t1 * one["l1"])[:, None]
        else:
            p_light = one["o"] + one["d0"] * (t0 * one["l0"])[:, None]
        vis = visible(scene.geom, p_hit, p_light)
        tr = jnp.exp(-vol.sigma_t[None, :] * t_cam[:, None])
        dl = p_light - p_hit
        dl = dl / jnp.maximum(jnp.linalg.norm(dl, axis=-1, keepdims=True), 1e-12)
        rho = phase_eval(vol.phase_g, -d, dl)
        jac = jnp.abs(jnp.sum(jnp.cross(one["d1"], one["d0"]) * d, -1))
        flux = one["w"] / jnp.maximum(jac, 1e-12)[:, None]
        w_mis = 1.0 / 3.0 if self.strategy in ("average", "dmis") else 1.0
        contrib = flux * tr * (rho * w_mis)[:, None] * vol.sigma_s[None, :]
        return jnp.where((ok & vis)[:, None], contrib, 0.0)

    _rect_cache = None

    def prepare(self, scene):
        """Host-side setup (called by the render driver outside jit):
        extract rectangular light parametrizations from the geometry. Uses
        the scene's numpy host mirror, with no device readback."""
        src = scene.host.data if getattr(scene, "host", None) is not None else scene
        self._rect_cache = extract_rect_lights(src)

    def _rect_lights(self, scene):
        if self._rect_cache is None:
            raise RuntimeError(
                "IntegratorSinglePlane.prepare(scene) must run before tracing "
                "(the render drivers call it automatically)")
        return self._rect_cache
