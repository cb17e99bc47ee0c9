"""Virtual point lights (instant radiosity).

Reference: src/integrators/explicit/vpl.rs — phase 1 shoots light paths and
deposits Emitter/Surface(/Volume) VPLs; phase 2 gathers every VPL at every
shading point.

Wavefront redesign (P7 in SURVEY.md §2.10): the shoot pass is a light-path
wavefront depositing VPLs into fixed [paths, bounces] slots; the gather pass
is a *dense pairwise* [pixels x VPL-chunk] evaluation — visibility rays and
BSDF products over the full cartesian product, scanned over VPL chunks.
That shape (every pixel against every light) is one dense batched product.

`clamping_factor` is declared but never applied in the reference
(vpl.rs:20); here it optionally clamps the 1/dist^2 geometry term
(dist^2 >= clamping_factor) — leave None for reference behavior.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..accel import intersect_rays, visible
from ..bsdfs import bsdf_eval, bsdf_sample, bsdf_is_smooth
from ..bsdfs.table import TRANSPORT_IMPORTANCE, TRANSPORT_RADIANCE
from ..scene import (
    fill_hit, generate_rays, sample_position, sample_emission_direction,
    emitted_radiance, env_radiance,
)
from ..scene.emitters import ATOM_TRI, ATOM_DIR
from ..scene.scene import offset_ray_origin
from ..scene.volume import (
    volume_sample_distance, phase_sample, phase_eval, transmittance,
)
from ..utils.frame import to_world, to_local, make_frame
from ..utils.rng import stream_next, stream_next2d, stream_fold, make_stream
from ..utils.vec import channel_max, normalize
from .common import Integrator

_PI = jnp.pi

VPL_NONE = 0
VPL_EMITTER = 1
VPL_EMITTER_INF = 2
VPL_SURFACE = 3
VPL_VOLUME = 4


class VplSet(NamedTuple):
    kind: Any      # [v] int32
    pos: Any       # [v, 3]
    n: Any         # [v, 3] (emitter normal / shading normal; direction for inf)
    frame_t: Any   # [v, 3]
    frame_b: Any   # [v, 3]
    wi: Any        # [v, 3] local incoming at surface VPLs
    uv: Any        # [v, 2]
    mat: Any       # [v] int32
    radiance: Any  # [v, 3] accumulated flux
    norm: Any      # scalar 1/paths_shot


class IntegratorVPL(Integrator):
    def __init__(self, nb_vpl: int = 128, max_depth: Optional[int] = None,
                 rr_depth: Optional[int] = 0,
                 clamping_factor: Optional[float] = None,
                 vpl_chunk: int = 16, hard_cap: int = 8):
        self.nb_vpl = nb_vpl
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.clamping = clamping_factor
        self.vpl_chunk = vpl_chunk
        self.cap = hard_cap if max_depth is None else min(hard_cap, max_depth)

    # ------------------------------------------------------------ shoot pass
    def generate_vpls(self, scene, stream) -> VplSet:
        """Shoot ceil(nb_vpl/(cap+1)) light paths, depositing one VPL slot per
        vertex. Bounces use Transport::Radiance (vpl.rs:317)."""
        n = max(1, self.nb_vpl // (self.cap + 1))
        u_sel, stream = stream_next(stream, (n,))
        u_pos, stream = stream_next2d(stream, (n,))
        ps = sample_position(scene.emitters, scene.geom, u_sel, u_pos)
        flux = ps.weight

        zero3 = jnp.zeros((n, 3), jnp.float32)
        # slot 0: emitter VPL
        is_inf = ps.kind == ATOM_DIR
        kind0 = jnp.where(ps.valid,
                          jnp.where(is_inf, VPL_EMITTER_INF, VPL_EMITTER),
                          VPL_NONE)
        slot0 = dict(kind=kind0, pos=ps.p, n=ps.n, frame_t=zero3, frame_b=zero3,
                     wi=zero3, uv=jnp.zeros((n, 2)), mat=jnp.zeros(n, jnp.int32),
                     radiance=flux)

        u_dir, stream = stream_next2d(stream, (n,))
        d, pdf_dir, w_dir = sample_emission_direction(scene.emitters, ps, u_dir)
        throughput = flux * w_dir
        o = offset_ray_origin(ps.p, ps.n, d)
        alive = ps.valid & (pdf_dir > 0.0)
        has_med = scene.volume is not None

        def body(carry, k):
            o, d, throughput, alive, stream = carry
            rh = intersect_rays(scene.geom, o, d)
            hit = fill_hit(scene, o, d, rh)
            if has_med:
                u_med, stream = stream_next(stream, (n,))
                tfar = jnp.where(rh.hit, rh.t, 1e8)
                sdm = volume_sample_distance(scene.volume, tfar, u_med)
                scattered = alive & (~sdm.exited)
                throughput = throughput * sdm.w
                p_scatter = o + d * sdm.t[:, None]
            else:
                scattered = jnp.zeros(n, bool)
                p_scatter = o
            lane = alive & hit.valid & (~scattered)
            smooth = bsdf_is_smooth(scene.materials, hit.mat)
            t, b, nn = hit.frame
            deposit = lane & (~smooth)
            kind = jnp.where(deposit, VPL_SURFACE, VPL_NONE)
            if has_med:
                kind = jnp.where(scattered, VPL_VOLUME, kind)
            slot = dict(
                kind=kind,
                pos=jnp.where(scattered[:, None], p_scatter, hit.p),
                n=jnp.where(scattered[:, None], -d, hit.n_s),  # d_in for volume
                frame_t=t, frame_b=b, wi=hit.wi,
                uv=hit.uv, mat=hit.mat, radiance=throughput)

            u_b, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_b,
                             TRANSPORT_RADIANCE)
            wo_world = to_world(hit.frame, bs.wo)
            weight = bs.weight
            valid_dir = bs.valid
            if has_med:
                d_ph, w_ph, pdf_ph = phase_sample(scene.volume.phase_g, -d, u_b)
                wo_world = jnp.where(scattered[:, None], d_ph, wo_world)
                weight = jnp.where(scattered[:, None], w_ph, weight)
                valid_dir = jnp.where(scattered, pdf_ph > 0.0, valid_dir)
            new_thr = throughput * weight
            u_rr, stream = stream_next(stream, (n,))
            if self.rr_depth is None:
                keep = jnp.ones(n, bool); rr_w = jnp.ones(n)
            else:
                do_rr = (k + 1) >= self.rr_depth
                rr_p = jnp.minimum(channel_max(new_thr), 0.95)
                keep = jnp.where(do_rr, u_rr < rr_p, True)
                rr_w = jnp.where(do_rr & keep, 1.0 / jnp.maximum(rr_p, 1e-8), 1.0)
            new_thr = new_thr * rr_w[:, None]
            expand = (self.max_depth is None) | (k + 1 < (self.max_depth or 0))
            alive_new = (lane | scattered) & valid_dir & keep & jnp.asarray(expand) \
                & (channel_max(new_thr) > 0.0)
            o_new = jnp.where(scattered[:, None], p_scatter,
                              offset_ray_origin(hit.p, hit.n_g, wo_world))
            return ((jnp.where(alive_new[:, None], o_new, o),
                     jnp.where(alive_new[:, None], wo_world, d),
                     jnp.where(alive_new[:, None], new_thr, throughput),
                     alive_new, stream), slot)

        ks = lax.broadcasted_iota(jnp.int32, (self.cap,), 0)
        _, slots = lax.scan(body, (o, d, throughput, alive, stream), ks)

        def cat(key):
            return jnp.concatenate([slot0[key][None], slots[key]], 0).reshape(
                (self.cap + 1) * n, *slot0[key].shape[1:])

        return VplSet(kind=cat("kind"), pos=cat("pos"), n=cat("n"),
                      frame_t=cat("frame_t"), frame_b=cat("frame_b"),
                      wi=cat("wi"), uv=cat("uv"), mat=cat("mat"),
                      radiance=cat("radiance"),
                      norm=jnp.float32(1.0 / n))

    # ----------------------------------------------------------- gather pass
    def _gather_surface(self, scene, hit, front, vpls: VplSet,
                        recv_scattered=None, recv_p=None, recv_d=None):
        """Gather at surface hits; lanes flagged in recv_scattered gather at
        the volume point recv_p with phase receiver along camera dir recv_d
        (reference gathering_volume, vpl.rs:384-458)."""
        n = hit.p.shape[0]
        vc = self.vpl_chunk
        v_total = vpls.kind.shape[0]
        n_chunks = (v_total + vc - 1) // vc
        pad = n_chunks * vc - v_total

        def padv(x):
            if pad == 0:
                return x
            return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], 0)

        fields = vpls._asdict()
        fields.pop("norm")
        chunks = {k: padv(v).reshape(n_chunks, vc, *v.shape[1:])
                  for k, v in fields.items()}

        smooth = bsdf_is_smooth(scene.materials, hit.mat)

        def body(acc, chunk):
            # pairwise [n, vc] -> flattened [n*vc]
            def bc_p(x):   # pixel-side broadcast
                return jnp.repeat(x, vc, axis=0)
            def bc_v(x):   # vpl-side broadcast
                return jnp.tile(x, (n,) + (1,) * (x.ndim - 1))

            if recv_scattered is not None:
                p_here = jnp.where(recv_scattered[:, None], recv_p, hit.p)
            else:
                p_here = hit.p
            p_pix = bc_p(p_here)
            n_pix = bc_p(hit.n_g)
            delta = bc_v(chunk['pos']) - p_pix
            dist2 = jnp.sum(delta * delta, axis=-1)
            dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
            dir_ = delta / dist[:, None]
            kind = bc_v(chunk['kind'])
            inf_vpl = kind == VPL_EMITTER_INF
            dir_ = jnp.where(inf_vpl[:, None], -bc_v(chunk['n']), dir_)

            # shading-point BSDF (Transport::Importance)
            frame_pix = (bc_p(hit.frame[0]), bc_p(hit.frame[1]), bc_p(hit.frame[2]))
            wo_loc = jnp.stack([jnp.sum(dir_ * frame_pix[0], -1),
                                jnp.sum(dir_ * frame_pix[1], -1),
                                jnp.sum(dir_ * frame_pix[2], -1)], -1)
            f_pix = bsdf_eval(scene.materials, bc_p(hit.mat), bc_p(hit.uv),
                              bc_p(hit.wi), wo_loc, TRANSPORT_IMPORTANCE)
            if recv_scattered is not None and scene.volume is not None:
                ph_recv = phase_eval(scene.volume.phase_g, bc_p(-recv_d), dir_)
                f_pix = jnp.where(bc_p(recv_scattered)[:, None],
                                  ph_recv[:, None], f_pix)

            # VPL-side emission toward the shading point
            # emitter VPL: Le * cos / pi ; surface VPL: f(wi, -dir) Radiance
            cos_e = jnp.maximum(jnp.sum(bc_v(chunk['n']) * (-dir_), -1), 0.0)
            rad_emit = bc_v(chunk['radiance']) * (cos_e / _PI)[:, None]
            md = jnp.stack([jnp.sum(-dir_ * bc_v(chunk['frame_t']), -1),
                            jnp.sum(-dir_ * bc_v(chunk['frame_b']), -1),
                            jnp.sum(-dir_ * bc_v(chunk['n']), -1)], -1)
            f_vpl = bsdf_eval(scene.materials, bc_v(chunk['mat']), bc_v(chunk['uv']),
                              bc_v(chunk['wi']), md, TRANSPORT_RADIANCE)
            rad_surf = bc_v(chunk['radiance']) * f_vpl

            # volume VPL: phase at the VPL (vpl.rs:333-352)
            if scene.volume is not None:
                ph_vpl = phase_eval(scene.volume.phase_g, bc_v(chunk['n']), dir_)
                rad_vol = bc_v(chunk['radiance']) * ph_vpl[:, None]
                tr_con = transmittance(scene.volume, jnp.sqrt(dist2))
            else:
                rad_vol = jnp.zeros_like(rad_surf)
                tr_con = 1.0

            g = 1.0 / jnp.maximum(dist2, self.clamping or 1e-20)
            contrib = jnp.where(
                (kind == VPL_SURFACE)[:, None], rad_surf * g[:, None],
                jnp.where((kind == VPL_EMITTER)[:, None], rad_emit * g[:, None],
                          jnp.where(inf_vpl[:, None], bc_v(chunk['radiance']),
                                    jnp.where((kind == VPL_VOLUME)[:, None],
                                              rad_vol * g[:, None], 0.0))))
            contrib = contrib * f_pix * tr_con

            # visibility
            o_shadow = offset_ray_origin(p_pix, n_pix, dir_)
            if recv_scattered is not None:
                o_shadow = jnp.where(bc_p(recv_scattered)[:, None], p_pix, o_shadow)
            target = jnp.where(inf_vpl[:, None],
                               p_pix + dir_ * 1e7, bc_v(chunk['pos']))
            recv_ok = front & (~smooth)
            if recv_scattered is not None:
                recv_ok = recv_ok | recv_scattered
            vis = visible(scene.geom, o_shadow, target,
                          mask=bc_p(recv_ok) & (kind != VPL_NONE))
            ok = (bc_p(recv_ok) & vis & (kind != VPL_NONE))
            contrib = jnp.where(ok[:, None], contrib, 0.0)
            return acc + contrib.reshape(n, vc, 3).sum(axis=1), None

        li, _ = lax.scan(body, jnp.zeros((n, 3), jnp.float32), chunks)
        return li * vpls.norm

    def compute_pixel(self, scene, pix, stream):
        n = pix.shape[0]
        vpls = self.generate_vpls(scene, stream_fold(stream, 999))
        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.astype(jnp.float32) + u_pix)
        rh = intersect_rays(scene.geom, o, d)
        hit = fill_hit(scene, o, d, rh)

        li = jnp.zeros((n, 3), jnp.float32)
        if scene.volume is not None:
            # camera-segment medium interaction (vpl.rs:460-533)
            u_med, stream = stream_next(stream, (n,))
            tfar = jnp.where(rh.hit, rh.t, 1e8)
            sdm = volume_sample_distance(scene.volume, tfar, u_med)
            scattered = ~sdm.exited
            p_scatter = o + d * sdm.t[:, None]
            front = hit.valid & (hit.wi[..., 2] > 0.0) & (~scattered)
            li = li + jnp.where(front[:, None],
                                emitted_radiance(scene.emitters, scene.geom,
                                                 hit.tri, d, uv=hit.uv,
                                                 attr=hit.attr)
                                * sdm.w, 0.0)
            gath = self._gather_surface(scene, hit, front, vpls,
                                        recv_scattered=scattered,
                                        recv_p=p_scatter, recv_d=d)
            return li + gath * sdm.w
        esc = ~hit.valid
        li = li + jnp.where(esc[:, None], env_radiance(scene.emitters, d), 0.0)
        front = hit.valid & (hit.wi[..., 2] > 0.0)
        li = li + jnp.where(front[:, None],
                            emitted_radiance(scene.emitters, scene.geom, hit.tri, d,
                                             uv=hit.uv, attr=hit.attr), 0.0)
        li = li + self._gather_surface(scene, hit, front, vpls)
        return li
