"""Adjoint particle tracing (light tracing) with camera splatting.

Reference: src/integrators/explicit/light.rs. Light paths start on an emitter
(`sample_position`, flux weight Le*pi/pdf), bounce with BSDF sampling, and at
every vertex connect to the pinhole camera: splat
flux * W_e * f(wi, w_cam; Radiance) * shading-normal-correction into the film
(emitter vertices splat flux * W_e * cos/pi). The film is scatter-added — the
wavefront version of the reference's mutex-merged per-job buffers (P2 in SURVEY.md
§2.10) — and scaled by W*H/total_paths.

Faithful quirk: bounces use Transport::Importance while splat connections use
Transport::Radiance + the explicit adjoint correction factor, mirroring
light.rs:252 + light.rs:96-110.
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
    fill_hit, sample_position, sample_emission_direction,
)
from ..scene.camera import sample_direct
from ..scene.emitters import ATOM_TRI
from ..scene.scene import offset_ray_origin
from ..scene.volume import (
    transmittance, volume_sample_distance, phase_eval, phase_sample,
)
from ..utils.frame import to_world, to_local
from ..utils.rng import stream_next, stream_next2d
from ..utils.vec import channel_max, dot, normalize
from .common import SplattingIntegrator

_PI = jnp.pi


class IntegratorLightTracing(SplattingIntegrator):
    def __init__(self, max_depth: Optional[int] = None,
                 min_depth: Optional[int] = None,
                 rr_depth: Optional[int] = 0,
                 render_surface: bool = True,
                 render_volume: bool = False,
                 hard_cap: int = 32):
        self.max_depth = max_depth
        self.min_depth = min_depth or 0
        self.rr_depth = rr_depth
        self.render_surface = render_surface
        self.render_volume = render_volume
        self.cap = hard_cap if max_depth is None else min(hard_cap, max_depth)

    def trace_paths(self, scene, n, stream):
        """Trace n light paths; returns (pixel_ids [(cap+1)*n], values)."""
        cam = scene.camera
        cam_pos = cam.position
        width = cam.width

        def splat_from(p, n_vec, value_rgb, active):
            """Connect p to the camera; returns (pid, val) with val zeroed
            when invalid/occluded."""
            w_e, pixel = sample_direct(cam, p)
            d_cam = normalize(cam_pos[None, :] - p)
            o = offset_ray_origin(p, n_vec, d_cam)
            vis = visible(scene.geom, o, jnp.broadcast_to(cam_pos, p.shape),
                          mask=active & (w_e > 0.0))
            if scene.volume is not None:
                dist = jnp.linalg.norm(cam_pos[None, :] - p, axis=-1)
                tr = transmittance(scene.volume, dist)
            else:
                tr = 1.0
            val = value_rgb * (w_e[:, None] * tr)
            ok = active & vis & (w_e > 0.0)
            px = jnp.clip(pixel[:, 0].astype(jnp.int32), 0, cam.width - 1)
            py = jnp.clip(pixel[:, 1].astype(jnp.int32), 0, cam.height - 1)
            pid = py * width + px
            return jnp.where(ok, pid, 0), jnp.where(ok[:, None], val, 0.0)

        # ---- emitter vertex (depth 0)
        u_sel, stream = stream_next(stream, (n,))
        u_pos, stream = stream_next2d(stream, (n,))
        ps = sample_position(scene.emitters, scene.geom, u_sel, u_pos)
        flux = ps.weight

        d_cam0 = normalize(cam_pos[None, :] - ps.p)
        cosl = jnp.maximum(jnp.sum(ps.n * d_cam0, axis=-1), 0.0)
        surface_atom = ps.kind == ATOM_TRI
        v0 = flux * (cosl / _PI)[:, None]
        splat_ok0 = (ps.valid & surface_atom & (self.min_depth <= 0)
                     & jnp.asarray(self.render_surface))
        pid0, val0 = splat_from(ps.p, ps.n, v0, splat_ok0)

        # ---- emission direction
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
                sd = volume_sample_distance(scene.volume, tfar, u_med)
                scattered = alive & (~sd.exited)
                throughput = throughput * sd.w
                p_scatter = o + d * sd.t[:, None]
            else:
                scattered = jnp.zeros(n, bool)
                p_scatter = o
            lane = alive & hit.valid & (~scattered)

            # ---- splat surface vertex (depth k+1)
            d_cam = normalize(cam_pos[None, :] - hit.p)
            wo_cam = to_local(hit.frame, d_cam)
            f_cam = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi, wo_cam,
                              TRANSPORT_RADIANCE)
            wi_world = to_world(hit.frame, hit.wi)
            # adjoint shading-normal correction (light.rs:105-110)
            num = hit.wi[:, 2] * jnp.sum(d_cam * hit.n_g, axis=-1)
            den = wo_cam[:, 2] * jnp.sum(wi_world * hit.n_g, axis=-1)
            corr = jnp.where(jnp.abs(den) > 1e-12, num / den, 0.0)
            smooth = bsdf_is_smooth(scene.materials, hit.mat)
            splat_ok = (lane & (~smooth) & ((k + 1) >= self.min_depth)
                        & jnp.asarray(self.render_surface))
            pid, val = splat_from(hit.p, hit.n_g, throughput * f_cam * corr[:, None],
                                  splat_ok)

            # ---- splat volume vertex (light.rs:52-85): phase instead of BSDF
            if has_med:
                d_cam_v = normalize(cam_pos[None, :] - p_scatter)
                ph = phase_eval(scene.volume.phase_g, -d, d_cam_v)
                splat_ok_v = (scattered & ((k + 1) >= self.min_depth)
                              & jnp.asarray(self.render_volume))
                pid_v, val_v = splat_from(p_scatter, d_cam_v,
                                          throughput * ph[:, None], splat_ok_v)
                pid = jnp.where(scattered, pid_v, pid)
                val = jnp.where(scattered[:, None], val_v, val)

            # ---- bounce (Transport::Importance per light.rs:252)
            u_b, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_b,
                             TRANSPORT_IMPORTANCE)
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
                keep = jnp.ones(n, bool)
                rr_w = jnp.ones(n, jnp.float32)
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
                     alive_new, stream), (pid, val))

        init = (o, d, throughput, alive, stream)
        ks = lax.broadcasted_iota(jnp.int32, (self.cap,), 0)
        (_, _, _, _, _), (pids, vals) = lax.scan(body, init, ks)

        all_pids = jnp.concatenate([pid0[None], pids], axis=0).reshape(-1)
        all_vals = jnp.concatenate([val0[None], vals], axis=0).reshape(-1, 3)
        return all_pids, all_vals
