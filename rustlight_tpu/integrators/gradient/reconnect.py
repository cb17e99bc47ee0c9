"""Gradient-domain path tracing with the reconnection shift mapping.

Reference: src/integrators/gradient/path.rs — the original GPT shift: each of
the four offset paths starts one pixel away, and at the first bounce where the
base path's current, next, and the offset's vertex are all rough, the offset
path *reconnects* to the base path's next vertex (geometry-ratio jacobian,
re-evaluated BSDF). The offset then rides the base path's decisions:

  NOT_CONNECTED -> (reconnect) -> RECENTLY_CONNECTED -> CONNECTED

RECENTLY_CONNECTED re-evaluates the base vertex's BSDF with the shifted
incoming direction once (path.rs:553-604); CONNECTED reuses the base path's
values scaled by the pdf ratio (path.rs:538-552). Delta chains use
half-vector copy (path.rs:706-829) — realized here as a same-randoms replay
of `bsdf_sample` at the offset vertex, which for delta lobes is exactly the
half-vector-mapped direction (hv == the local normal). Per-strategy MIS
between base and offset follows the reference's weight algebra verbatim,
including the 1e-4-regularized dead-shift denominator (path.rs:316-318) and
the no-light-MIS rule for half-vector shifts (path.rs:832-840).

Wavefront form: one lane per base pixel, the four offset states
carried as SoA pytrees through a `lax.while_loop`; every per-state branch is
evaluated for all lanes and mask-selected (the states are data, not control
flow). The `very_direct` (camera->light) buffer bypasses reconstruction as in
the reference (recons.rs:262).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...accel import intersect_rays, visible
from ...bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample, bsdf_is_smooth
from ...bsdfs.table import TRANSPORT_IMPORTANCE, KIND_GLASS, KIND_METAL
from ...scene import (
    fill_hit, generate_rays, sample_light, direct_pdf_tri, emitted_radiance,
)
from ...scene.scene import offset_ray_origin
from ...utils.frame import to_world, to_local
from ...utils.rng import make_stream, stream_fold, stream_next, stream_next2d
from ...utils.vec import channel_max
from ..common import _pixel_grid
from .path import _OFFSETS, _lane_constraint, _render_gradient_film, _shift2d

_DEAD, _NC, _RC, _CN = 0, 1, 2, 3
_TI = TRANSPORT_IMPORTANCE


class _OffState(NamedTuple):
    code: Any   # [n] int32 state
    thr: Any    # [n, 3]
    pdf: Any    # [n]
    its: Any    # Hit at the offset path's own last vertex (NOT_CONNECTED /
    #             the pre-connection vertex while RECENTLY_CONNECTED)


def _sel_hit(mask, a, b):
    """Per-lane select between two Hit pytrees."""
    def pick(x, y):
        m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(m, x, y)
    return jax.tree.map(pick, a, b)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def reconnection_jacobian(n2, wo_main, t_main, wo_shift, dist_sq_shift):
    """Solid-angle measure ratio |dω'/dω| of moving the predecessor vertex
    x1 -> x1' while pinning the reconnection vertex x2 (reference
    gradient/path.rs:616-626): G(x1'↔x2) / G(x1↔x2) with the shared cos at
    x1 cancelled, = |cos(n2, -wo')| t² / (|cos(n2, -wo)| d'²).

    n2: [n, 3] geometric normal at x2; wo_main/wo_shift: unit directions
    x1→x2 / x1'→x2; t_main: base distance |x2 - x1|; dist_sq_shift:
    |x2 - x1'|²."""
    return (jnp.abs(_dot(n2, -wo_shift)) * t_main ** 2
            / jnp.maximum(jnp.abs(_dot(n2, -wo_main)) * dist_sq_shift,
                          1e-20))


class IntegratorGradientPathReconnect:
    """`gradient-path` — reconnection-shift GDPT (gradient/path.rs)."""

    averaging = True

    def __init__(self, max_depth: Optional[int] = None,
                 min_depth: Optional[int] = None,
                 recons: str = "uniform", recons_iterations: int = 50,
                 nb_buffers: Optional[int] = None, hard_cap: int = 8):
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.recons = recons
        self.iterations = recons_iterations
        self.hard_cap = hard_cap if max_depth is None else min(hard_cap,
                                                               max_depth)
        if nb_buffers is None:
            nb_buffers = {"uniform": 1, "weighted": 2, "bagging": 4}[recons]
        self.nb_buffers = nb_buffers
        # capture_hlo hook: see gradient/path.py (SMCMC-style HLO assert)
        self.capture_hlo = False
        self.last_hlo = None

    # ------------------------------------------------------------- core
    def _trace_state(self, scene, pixf, dx, dy, w, h):
        """Primary-hit offset state for displacement (dx, dy)
        (RayState::new, path.rs:67-99)."""
        pixo = pixf + jnp.asarray([dx, dy], jnp.float32)
        inside = ((pixo[:, 0] >= 0) & (pixo[:, 0] <= w)
                  & (pixo[:, 1] >= 0) & (pixo[:, 1] <= h))
        o, d = generate_rays(scene.camera, pixo)
        rh = intersect_rays(scene.geom, o, d)
        hit = fill_hit(scene, o, d, rh)
        n = pixf.shape[0]
        code = jnp.where(inside & hit.valid & (hit.wi[:, 2] > 0),
                         _NC, _DEAD).astype(jnp.int32)
        return _OffState(code=code, thr=jnp.ones((n, 3), jnp.float32),
                         pdf=jnp.ones(n, jnp.float32), its=hit)

    def compute_pixel_gradient(self, scene, pix, stream, has_delta: bool):
        """One pass: returns (l_main, [4] l_off, [4] l_grad, very_direct),
        each [n,3] (ColorGradient of gradient/mod.rs:9-14)."""
        n = pix.shape[0]
        w, h = scene.camera.width, scene.camera.height
        mat = scene.materials
        em = scene.emitters
        geom = scene.geom

        u_pix, stream = stream_next2d(stream, (n,))
        pixf = pix.astype(jnp.float32) + u_pix
        o_m, d_m = generate_rays(scene.camera, pixf)
        rh = intersect_rays(geom, o_m, d_m)
        mh = fill_hit(scene, o_m, d_m, rh)
        m_alive = rh.hit & mh.valid & (mh.wi[:, 2] > 0)

        offs = [self._trace_state(scene, pixf, dx, dy, w, h)
                for (dy, dx, _, _) in _OFFSETS]

        zeros3 = jnp.zeros((n, 3), jnp.float32)
        carry = dict(
            depth=jnp.int32(1), stream=stream,
            mh=mh, m_d=d_m, m_thr=jnp.ones((n, 3), jnp.float32),
            m_pdf=jnp.ones(n, jnp.float32), m_alive=m_alive,
            offs=offs, l_main=zeros3, l_off=[zeros3] * 4,
            l_grad=[zeros3] * 4, vdirect=zeros3,
        )

        min_d = self.min_depth

        def cond(c):
            below = True if self.max_depth is None \
                else c["depth"] < self.max_depth
            return jnp.asarray(below) & (c["depth"] <= self.hard_cap) \
                & jnp.any(c["m_alive"])

        def body(c):
            depth, stream = c["depth"], c["stream"]
            mh, m_thr, m_pdf, m_alive = c["mh"], c["m_thr"], c["m_pdf"], c["m_alive"]
            offs = c["offs"]
            l_main, l_off, l_grad = c["l_main"], list(c["l_off"]), list(c["l_grad"])
            min_ok = True if min_d is None else depth >= min_d

            # ---- very direct (camera->light), depth==1 (path.rs:305-307)
            le0 = emitted_radiance(em, geom, mh.tri, c["m_d"], uv=mh.uv,
                                   attr=mh.attr)
            vdirect = c["vdirect"] + jnp.where(
                ((depth == 1) & m_alive & jnp.asarray(min_ok))[:, None],
                le0, 0.0)

            m_smooth = bsdf_is_smooth(mat, mh.mat)

            # =========================== NEE block (path.rs:309-457)
            u_sel, stream = stream_next(stream, (n,))
            u_pos, stream = stream_next2d(stream, (n,))
            ls_m = sample_light(em, geom, mh.p, u_sel, u_pos)
            vis_m = visible(geom, offset_ray_origin(mh.p, mh.n_g, ls_m.d),
                            ls_m.p)
            wo_lm = to_local(mh.frame, ls_m.d)
            f_m = bsdf_eval(mat, mh.mat, mh.uv, mh.wi, wo_lm, _TI)
            pdf_bm = jnp.where(vis_m,
                               bsdf_pdf(mat, mh.mat, mh.uv, mh.wi, wo_lm, _TI),
                               0.0)
            pm = ls_m.pdf
            rad_m = jnp.where((vis_m & ls_m.valid)[:, None], ls_m.weight, 0.0)
            num = pm
            dem = pm + pdf_bm
            main_contrib = m_thr * f_m * rad_m
            cos_lm = _dot(ls_m.n, ls_m.d)
            dsq_m = jnp.sum((mh.p - ls_m.p) ** 2, -1)
            nee_on = m_alive & (~m_smooth) & ls_m.valid & (pm > 0.0) \
                & jnp.asarray(min_ok)

            for i, s in enumerate(offs):
                ratio = s.pdf / jnp.maximum(m_pdf, 1e-30)
                # CONNECTED: reuse base values (path.rs:322-331)
                dem_cn = ratio * (pm + pdf_bm)
                ctb_cn = s.thr * f_m * rad_m
                # RECENTLY_CONNECTED: re-evaluate incoming dir (rs:332-365)
                d_in = _normalize(s.its.p - mh.p)
                wi_l = to_local(mh.frame, d_in)
                ok_rc = (wi_l[:, 2] > 0.0) & vis_m
                f_rc = bsdf_eval(mat, mh.mat, mh.uv, wi_l, wo_lm, _TI)
                pdf_rc = bsdf_pdf(mat, mh.mat, mh.uv, wi_l, wo_lm, _TI)
                dem_rc = jnp.where(ok_rc, ratio * (pm + pdf_rc), 0.0)
                ctb_rc = jnp.where(ok_rc[:, None], s.thr * f_rc * rad_m, 0.0)
                # NOT_CONNECTED: own light sample + jacobian (rs:366-441)
                s_smooth = bsdf_is_smooth(mat, s.its.mat)
                ls_s = sample_light(em, geom, s.its.p, u_sel, u_pos)
                vis_s = visible(
                    geom, offset_ray_origin(s.its.p, s.its.n_g, ls_s.d),
                    ls_s.p)
                rad_s = jnp.where(
                    (vis_s & ls_s.valid)[:, None],
                    ls_s.weight * (ls_s.pdf / jnp.maximum(pm, 1e-30))[:, None],
                    0.0)
                wo_ls = to_local(s.its.frame, ls_s.d)
                f_nc = bsdf_eval(mat, s.its.mat, s.its.uv, s.its.wi, wo_ls, _TI)
                pdf_ncb = jnp.where(
                    vis_s, bsdf_pdf(mat, s.its.mat, s.its.uv, s.its.wi,
                                    wo_ls, _TI), 0.0)
                cos_ls = _dot(ls_s.n, ls_s.d)
                dsq_s = jnp.sum((s.its.p - ls_s.p) ** 2, -1)
                jac = (jnp.abs(cos_ls * dsq_m)
                       / jnp.maximum(jnp.abs(cos_lm * dsq_s), 1e-20))
                ok_nc = ~s_smooth
                dem_nc = jnp.where(ok_nc,
                                   jac * ratio * (ls_s.pdf + pdf_ncb), 0.0)
                ctb_nc = jnp.where(ok_nc[:, None],
                                   jac[:, None] * s.thr * f_nc * rad_s, 0.0)
                # dead-shift regularized denominator (path.rs:316-318)
                dem_dead = num / (1e-4 + dem)

                is_cn = s.code == _CN
                is_rc = s.code == _RC
                is_nc = s.code == _NC
                dem_s = jnp.where(is_cn, dem_cn,
                                  jnp.where(is_rc, dem_rc,
                                            jnp.where(is_nc, dem_nc,
                                                      dem_dead)))
                ctb_s = jnp.where(is_cn[:, None], ctb_cn,
                                  jnp.where(is_rc[:, None], ctb_rc,
                                            jnp.where(is_nc[:, None], ctb_nc,
                                                      0.0)))
                wgt = jnp.where(nee_on,
                                num / jnp.maximum(dem + dem_s, 1e-30), 0.0)
                # masked-out lanes may carry inf/NaN garbage: select, then add
                gate = (wgt > 0.0)[:, None]
                l_main = l_main + jnp.where(gate, main_contrib * wgt[:, None], 0.0)
                l_off[i] = l_off[i] + jnp.where(gate, ctb_s * wgt[:, None], 0.0)
                l_grad[i] = l_grad[i] + jnp.where(
                    gate, (ctb_s - main_contrib) * wgt[:, None], 0.0)

            # =========================== BSDF bounce (path.rs:459-871)
            u_b, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(mat, mh.mat, mh.uv, mh.wi, u_b, _TI)
            wo_w = to_world(mh.frame, bs.wo)
            o_new = offset_ray_origin(mh.p, mh.n_g, wo_w)
            rh2 = intersect_rays(geom, o_new, wo_w)
            nh = fill_hit(scene, o_new, wo_w, rh2)
            hit_ok = rh2.hit & nh.valid

            is_l = nh.is_light & (nh.wi[:, 2] > 0.0) & hit_ok
            light_pdf = jnp.where(
                is_l, direct_pdf_tri(em, nh.tri, mh.p, nh.p, nh.n_g, wo_w,
                                     attr=nh.attr),
                0.0)
            rad = jnp.where(is_l[:, None],
                            emitted_radiance(em, geom, nh.tri, wo_w,
                                             uv=nh.uv, attr=nh.attr), 0.0)

            m_pdf_new = m_pdf * bs.pdf
            m_thr_new = m_thr * bs.weight
            m_ok = (m_alive & bs.valid & hit_ok & (m_pdf_new > 0.0)
                    & (channel_max(m_thr_new) > 0.0))
            num_b = bs.pdf
            main_contrib_b = m_thr_new * rad
            next_smooth = bsdf_is_smooth(mat, nh.mat)

            new_offs = []
            for i, s in enumerate(offs):
                ratio = s.pdf / jnp.maximum(m_pdf, 1e-30)  # pred ratio
                is_cn = s.code == _CN
                is_rc = s.code == _RC
                is_nc = s.code == _NC

                # CONNECTED (path.rs:538-552)
                thr_cn = s.thr * bs.weight
                pdf_cn = s.pdf * bs.pdf
                dem_cn = ratio * (bs.pdf + light_pdf)
                ctb_cn = thr_cn * rad

                # RECENTLY_CONNECTED (path.rs:553-604)
                d_in = _normalize(s.its.p - mh.p)
                wi_l = to_local(mh.frame, d_in)
                ok_rc = (~m_smooth) & (wi_l[:, 2] > 0.0)
                f_rc = bsdf_eval(mat, mh.mat, mh.uv, wi_l, bs.wo, _TI)
                pdf_rcb = bsdf_pdf(mat, mh.mat, mh.uv, wi_l, bs.wo, _TI)
                thr_rc = s.thr * f_rc / jnp.maximum(bs.pdf, 1e-30)[:, None]
                pdf_rc = s.pdf * pdf_rcb
                dem_rc = jnp.where(ok_rc, ratio * (pdf_rcb + light_pdf), 0.0)
                ctb_rc = jnp.where(ok_rc[:, None], thr_rc * rad, 0.0)

                # NOT_CONNECTED -> reconnection (path.rs:605-698)
                s_smooth = bsdf_is_smooth(mat, s.its.mat)
                reconn = (~m_smooth) & (~next_smooth) & (~s_smooth) & hit_ok
                dir_sc = nh.p - s.its.p
                dsq = jnp.maximum(jnp.sum(dir_sc ** 2, -1), 1e-20)
                wo_s = dir_sc / jnp.sqrt(dsq)[:, None]
                vis_r = visible(
                    geom, offset_ray_origin(s.its.p, s.its.n_g, wo_s), nh.p)
                jac = reconnection_jacobian(nh.n_g, wo_w, rh2.t, wo_s, dsq)
                wo_s_l = to_local(s.its.frame, wo_s)
                f_re = bsdf_eval(mat, s.its.mat, s.its.uv, s.its.wi, wo_s_l,
                                 _TI)
                pdf_reb = bsdf_pdf(mat, s.its.mat, s.its.uv, s.its.wi, wo_s_l,
                                   _TI)
                thr_re = s.thr * f_re * (
                    jac / jnp.maximum(bs.pdf, 1e-30))[:, None]
                pdf_re = s.pdf * pdf_reb * jac
                sh_em_pdf = jnp.where(
                    is_l, direct_pdf_tri(em, nh.tri, s.its.p, nh.p, nh.n_g,
                                         wo_s, attr=nh.attr), 0.0)
                dem_re = ratio * (pdf_reb + sh_em_pdf)
                ctb_re = thr_re * rad   # rad already 0 when main missed light
                ok_re = reconn & vis_r

                # NOT_CONNECTED -> half-vector copy via same-randoms replay
                # (path.rs:699-829; exact for delta lobes: hv == local normal)
                hv_ok = is_nc & (~reconn) & m_smooth & s_smooth
                if has_delta:
                    bs_s = bsdf_sample(mat, s.its.mat, s.its.uv, s.its.wi,
                                       u_b, _TI)
                    thr_hv = s.thr * bs_s.weight * bs_s.pdf[:, None]
                    pdf_hv = s.pdf * bs_s.pdf
                    wo_sw = to_world(s.its.frame, bs_s.wo)
                    o_s = offset_ray_origin(s.its.p, s.its.n_g, wo_sw)
                    rh_s = intersect_rays(geom, o_s, wo_sw)
                    sh = fill_hit(scene, o_s, wo_sw, rh_s)
                    hv_live = hv_ok & bs_s.valid & rh_s.hit & sh.valid
                    rad_hv = jnp.where(
                        (sh.is_light & hv_live)[:, None],
                        emitted_radiance(em, geom, sh.tri, wo_sw,
                                         uv=sh.uv, attr=sh.attr), 0.0)
                    ctb_hv = jnp.where(hv_live[:, None], thr_hv * rad_hv, 0.0)
                    dem_hv = jnp.where(hv_live, pdf_hv, 0.0)
                else:
                    hv_live = jnp.zeros(n, bool)
                    thr_hv, pdf_hv, sh = s.thr, s.pdf, s.its
                    ctb_hv = jnp.zeros((n, 3), jnp.float32)
                    dem_hv = jnp.zeros(n, jnp.float32)

                half_vec = is_nc & (~reconn)
                dem_s = jnp.where(
                    is_cn, dem_cn,
                    jnp.where(is_rc, dem_rc,
                              jnp.where(is_nc & reconn,
                                        jnp.where(ok_re, dem_re, 0.0),
                                        jnp.where(half_vec, dem_hv, 0.0))))
                ctb_s = jnp.where(
                    is_cn[:, None], ctb_cn,
                    jnp.where(is_rc[:, None], ctb_rc,
                              jnp.where((is_nc & reconn & ok_re)[:, None],
                                        ctb_re,
                                        jnp.where(half_vec[:, None], ctb_hv,
                                                  0.0))))
                # half-vector shifts do not MIS against the light strategy
                main_dem = jnp.where(half_vec, num_b, num_b + light_pdf)
                wgt = jnp.where(m_ok & jnp.asarray(min_ok),
                                num_b / jnp.maximum(main_dem + dem_s, 1e-30),
                                0.0)
                gate = (wgt > 0.0)[:, None]
                l_main = l_main + jnp.where(gate, main_contrib_b * wgt[:, None], 0.0)
                l_off[i] = l_off[i] + jnp.where(gate, ctb_s * wgt[:, None], 0.0)
                l_grad[i] = l_grad[i] + jnp.where(
                    gate, (ctb_s - main_contrib_b) * wgt[:, None], 0.0)

                # ---- state transitions
                new_code = jnp.where(
                    is_cn, _CN,
                    jnp.where(is_rc, jnp.where(ok_rc, _CN, _DEAD),
                              jnp.where(is_nc & reconn,
                                        jnp.where(ok_re, _RC, _DEAD),
                                        jnp.where(hv_live, _NC, _DEAD))))
                new_code = jnp.where(m_ok, new_code, _DEAD).astype(jnp.int32)
                pick_rc = is_rc & ok_rc
                pick_re = is_nc & reconn & ok_re
                pick_hv = is_nc & (~reconn) & hv_live
                new_thr = jnp.where(
                    is_cn[:, None], thr_cn,
                    jnp.where(pick_rc[:, None], thr_rc,
                              jnp.where(pick_re[:, None], thr_re,
                                        jnp.where(pick_hv[:, None], thr_hv,
                                                  s.thr))))
                new_pdf = jnp.where(
                    is_cn, pdf_cn,
                    jnp.where(pick_rc, pdf_rc,
                              jnp.where(pick_re, pdf_re,
                                        jnp.where(pick_hv, pdf_hv, s.pdf))))
                new_its = _sel_hit(pick_hv, sh, s.its) if has_delta else s.its
                live = new_code != _DEAD
                new_thr = jnp.where(live[:, None],
                                    jnp.nan_to_num(new_thr, posinf=0.0), 0.0)
                new_pdf = jnp.where(live,
                                    jnp.nan_to_num(new_pdf, posinf=0.0), 0.0)
                new_offs.append(_OffState(code=new_code, thr=new_thr,
                                          pdf=new_pdf, its=new_its))

            # ---- Russian roulette on the base path (path.rs:858-868)
            u_rr, stream = stream_next(stream, (n,))
            rr_p = jnp.minimum(channel_max(m_thr_new), 0.95)
            keep = u_rr <= rr_p
            inv = 1.0 / jnp.maximum(rr_p, 1e-8)
            m_thr_new = m_thr_new * inv[:, None]
            new_offs = [o._replace(thr=o.thr * inv[:, None])
                        for o in new_offs]
            m_alive_new = m_ok & keep

            return dict(
                depth=depth + 1, stream=stream,
                mh=_sel_hit(m_alive_new, nh, mh), m_d=jnp.where(
                    m_alive_new[:, None], wo_w, c["m_d"]),
                m_thr=jnp.where(m_alive_new[:, None], m_thr_new, m_thr),
                m_pdf=jnp.where(m_alive_new, m_pdf_new, m_pdf),
                m_alive=m_alive_new, offs=new_offs,
                l_main=l_main, l_off=l_off, l_grad=l_grad, vdirect=vdirect,
            )

        out = jax.lax.while_loop(cond, body, carry)
        return out["l_main"], out["l_off"], out["l_grad"], out["vdirect"]

    # ------------------------------------------------------------ driver
    def render(self, scene, spp: int, seed: int = 0, verbose: bool = False,
               mesh=None):
        cam = scene.camera
        w, h = cam.width, cam.height
        n = w * h
        base = make_stream(seed)
        pix = jnp.asarray(_pixel_grid(w, h))
        px, py = pix[:, 0], pix[:, 1]
        pid = py * w + px
        host = getattr(scene, "host", None)
        if host is not None and hasattr(host, "materials"):
            kinds = np.asarray(host.materials.kind)
            has_delta = bool(np.any(np.isin(kinds, [KIND_GLASS, KIND_METAL])))
        else:
            has_delta = True

        # scene closed over: compile-time constants; RNG base as argument so
        # avg-mode passes reuse the executable
        from ..common import _BLOCK_CACHE, _cache_put
        ck = (id(scene), id(self), w, h, "gdpt-reconnect",
              id(mesh) if mesh is not None else None)
        one_pass_c = _BLOCK_CACHE.get(ck)
        if one_pass_c is None:
            one_pass_c = self._make_pass(scene, pix, px, py, pid, w, h, n,
                                         has_delta, mesh)
            _cache_put(ck, one_pass_c)
        if self.capture_hlo:
            self.last_hlo = one_pass_c.lower(
                base, jnp.int32(0)).compile().as_text()
        one_pass = lambda s: one_pass_c(base, s)

        return _render_gradient_film(scene, spp, one_pass, self.nb_buffers,
                                     self.recons, self.iterations, w, h)

    def _make_pass(self, scene, pix, px, py, pid, w, h, n, has_delta,
                   mesh=None):
        constrain = _lane_constraint(mesh)

        @jax.jit
        def one_pass(base, s):
            stream = stream_fold(base, s)
            l_main, l_off, l_grad, vdir = self.compute_pixel_gradient(
                scene, constrain(pix), stream, has_delta)
            # film assembly by 2D shifts (see gradient/path.py): scatter at
            # the fixed ±1-pixel offset == roll of the (h, w, 3) source grid
            # with edge lanes zeroed; shards over a row-banded mesh with the
            # y-halo lowered to collective-permute
            # main contributes at the pixel for each of the 4 strategies,
            # offsets land at their displaced pixel (compute_gradients,
            # path.rs:131-206); 0.25 primal scale applied below
            primal = constrain(l_main.reshape(h, w, 3))
            gxb = jnp.zeros((h, w, 3), jnp.float32)
            gyb = jnp.zeros((h, w, 3), jnp.float32)
            for i, (dy, dx, axis, sign) in enumerate(_OFFSETS):
                ox, oy = px + dx, py + dy
                inside = ((ox >= 0) & (ox < w) & (oy >= 0) & (oy < h)
                          ).reshape(h, w, 1)
                offv = jnp.where(inside, l_off[i].reshape(h, w, 3), 0.0)
                primal = primal + _shift2d(offv, dy, dx)
                gbuf = gxb if axis == "x" else gyb
                if sign > 0:
                    gbuf = gbuf + l_grad[i].reshape(h, w, 3)
                else:
                    gbuf = gbuf - _shift2d(
                        jnp.where(inside, l_grad[i].reshape(h, w, 3), 0.0),
                        dy, dx)
                if axis == "x":
                    gxb = gbuf
                else:
                    gyb = gbuf
            return (primal.reshape(n, 3) * 0.25, gxb.reshape(n, 3),
                    gyb.reshape(n, 3), vdir)

        return one_pass
