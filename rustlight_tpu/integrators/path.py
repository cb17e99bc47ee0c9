"""Wavefront (bounce-synchronous) path tracer with NEE + MIS.

Reference: src/integrators/explicit/path.rs + the path-graph strategies
(src/paths/strategies/{directional,emitters}.rs). The reference's recursive
per-pixel graph evaluation becomes a `lax.while_loop` over SoA lane state —
the reference's own breadth-first `generate()` driver
(src/paths/strategies/mod.rs:35-80) is exactly this shape.

Semantics mirrored:
  - two strategies per vertex: BSDF-directional and light-NEE, combined with
    the *balance* heuristic over strategy pdfs (path.rs:77-106);
  - `strategy` = all | bsdf | emitter filters contributions by the sampling
    strategy id (path.rs:50-66) — sensor-edge (directly visible light) always
    contributes;
  - emission with k edges gated by min_depth <= k-1; expansion stops at
    max_depth edges; RR from rr_depth with survival min(throughput_max, 0.95)
    (directional.rs:77-87);
  - delta vertices (smooth BSDFs) skip NEE and get MIS weight 1 on hits.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..accel import intersect_rays, visible
from ..bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample, bsdf_is_smooth
from ..bsdfs.table import TRANSPORT_IMPORTANCE
from ..scene import (
    fill_hit, generate_rays, sample_light, direct_pdf_tri, emitted_radiance,
    env_radiance, env_direction_pdf,
)
from ..scene.scene import offset_ray_origin
from ..scene.volume import (
    volume_sample_distance, phase_eval, phase_sample, transmittance,
)
from ..utils.frame import to_world, to_local
from ..utils.rng import stream_next, stream_next2d
from ..utils.vec import channel_max, dot
from .common import Integrator, mis_balance

STRATEGY_ALL = "all"
STRATEGY_BSDF = "bsdf"
STRATEGY_EMITTER = "emitter"
# ground-truth cosine-hemisphere sampling, no BSDF IS and no NEE — the
# IS-correctness oracle (reference NaiveSamplingStrategy,
# src/paths/strategies/naive.rs:9-293)
STRATEGY_NAIVE = "naive"


class _PathState(NamedTuple):
    k: Any            # iteration (edges completed so far)
    stream: Any
    o: Any            # [n, 3] current ray origin (previous vertex position)
    d: Any            # [n, 3] current ray direction
    throughput: Any   # [n, 3]
    radiance: Any     # [n, 3]
    alive: Any        # [n]
    prev_pdf: Any     # [n] solid-angle pdf of the directional strategy
    prev_delta: Any   # [n] previous bounce was a delta lobe (or sensor)
    prev_nee: Any     # [n] NEE was *possible* at the previous vertex


class _PersistentState(NamedTuple):
    """Pixel-pinned persistent-wavefront state: each lane renders its own
    pixel's samples back to back, respawning the moment its path dies, so
    dead lanes never idle through the bounce loop (the classic wavefront/
    persistent-threads scheduling, impossible to express in the reference's
    recursive per-path form). `depth` replaces the global iteration counter
    as a per-lane edge count."""
    it: Any           # global iteration (safety cap only)
    stream: Any
    o: Any
    d: Any
    throughput: Any
    rad_path: Any     # [n, 3] radiance of the path in flight
    accum: Any        # [n, 3] sum over finished samples of this lane's pixel
    alive: Any        # [n] path in flight
    done: Any         # [n] int32 samples completed
    depth: Any        # [n] int32 edges completed on the current path
    prev_pdf: Any
    prev_delta: Any
    prev_nee: Any


class IntegratorPathTracing(Integrator):
    def __init__(self, min_depth: Optional[int] = None,
                 max_depth: Optional[int] = None,
                 rr_depth: Optional[int] = 0,
                 strategy: str = STRATEGY_ALL,
                 single_scattering: bool = False,
                 hard_cap: int = 64):
        self.min_depth = min_depth or 0
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.strategy = strategy
        self.single_scattering = single_scattering
        # safety bound for the while_loop when max_depth is None (RR terminates
        # lanes geometrically; 64 bounces leaves ~1e-? of energy for albedo .95)
        self.hard_cap = hard_cap if max_depth is None else min(hard_cap, max_depth)

    def _naive_bounce(self, scene, hit, smooth, u_bsdf, bs):
        """STRATEGY_NAIVE: cosine-hemisphere sampling on the wi side, weight
        = f·cos/pdf with pdf = |cosθ|/π (naive.rs:9-293). Delta materials
        keep BSDF sampling — a cosine draw can never land on a delta lobe."""
        from ..utils.warps import cosine_sample_hemisphere
        wo_n = cosine_sample_hemisphere(u_bsdf)
        sz = jnp.where(hit.wi[:, 2] < 0.0, -1.0, 1.0)
        wo_n = jnp.concatenate([wo_n[:, :2], wo_n[:, 2:3] * sz[:, None]], -1)
        pdf_n = jnp.abs(wo_n[:, 2]) / jnp.pi
        f_n = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi, wo_n,
                        TRANSPORT_IMPORTANCE)
        w_n = f_n / jnp.maximum(pdf_n, 1e-12)[:, None]
        use_n = ~smooth
        return (jnp.where(use_n[:, None], wo_n, bs.wo),
                jnp.where(use_n[:, None], w_n, bs.weight),
                jnp.where(use_n, pdf_n, bs.pdf),
                jnp.where(use_n, False, bs.is_delta),
                jnp.where(use_n, pdf_n > 0.0, bs.valid))

    # ----------------------------------------------------------------- core
    def compute_pixel(self, scene, pix, stream, guide=None, collect=False):
        """`guide` (a guiding.GuideGrid, traced) switches the directional
        bounce on rough surfaces to a defensive one-sample-MIS mixture of
        BSDF and learned distributions; `collect=True` additionally returns
        a flat [g^3 * N_BINS] deposit accumulator of incident-radiance
        estimates (emission hits, env escapes and NEE contributions binned
        by the direction they arrived from). Unbiased for ANY table: the
        mixture pdf keeps a uniform prior floor (guiding.py)."""
        n = pix.shape[0]
        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.astype(jnp.float32) + u_pix)

        use_nee = self.strategy in (STRATEGY_ALL, STRATEGY_EMITTER)
        mis_on = self.strategy == STRATEGY_ALL
        keep_bsdf_hits = self.strategy in (STRATEGY_ALL, STRATEGY_BSDF,
                                           STRATEGY_NAIVE)
        if guide is not None:
            from . import guiding as _gd
            g_alpha = getattr(self, "guide_alpha", 0.5)
            n_cells = guide.table.shape[0] * guide.table.shape[1]
        dep0 = jnp.zeros(n_cells if (guide is not None and collect) else 1,
                         jnp.float32)

        state = _PathState(
            k=jnp.int32(0), stream=stream, o=o, d=d,
            throughput=jnp.ones((n, 3), jnp.float32),
            radiance=jnp.zeros((n, 3), jnp.float32),
            alive=jnp.ones(n, bool),
            prev_pdf=jnp.ones(n, jnp.float32),
            prev_delta=jnp.ones(n, bool),   # sensor: single strategy, weight 1
            prev_nee=jnp.zeros(n, bool),
        )

        def cond(sd_):
            s = sd_[0]
            return (s.k < self.hard_cap) & jnp.any(s.alive)

        has_med = scene.volume is not None

        def body(sd_):
            s, dep = sd_
            k = s.k
            stream = s.stream
            # dead lanes trace inert (tfar=0) rays: they cannot hit
            rh = intersect_rays(scene.geom, s.o, s.d,
                                tfar=jnp.where(s.alive, jnp.inf, 0.0))
            hit = fill_hit(scene, s.o, s.d, rh)

            # ---- medium: free-flight sampling along the segment
            if has_med:
                u_med, stream = stream_next(stream, (n,))
                tfar = jnp.where(rh.hit, rh.t, 1e8)
                sd = volume_sample_distance(scene.volume, tfar, u_med)
                scattered = s.alive & (~sd.exited)
                thr = s.throughput * sd.w
                p_scatter = s.o + s.d * sd.t[:, None]
            else:
                scattered = jnp.zeros(n, bool)
                thr = s.throughput
                p_scatter = s.o

            lane_hit = s.alive & hit.valid & (~scattered)

            # ---- emission picked up through the BSDF/sensor edge (k+1 edges)
            min_ok = k >= self.min_depth
            le = emitted_radiance(scene.emitters, scene.geom, hit.tri, s.d,
                                  uv=hit.uv, attr=hit.attr)
            # MIS vs the NEE strategy pdf at the previous vertex
            if scene.ats is not None:
                from ..scene.emitters import direct_pdf_tri_ats
                pdf_light = direct_pdf_tri_ats(scene.emitters, scene.geom,
                                               scene.ats, hit.tri, s.o, hit.p,
                                               hit.n_g, s.d)
            else:
                pdf_light = direct_pdf_tri(scene.emitters, hit.tri, s.o,
                                           hit.p, hit.n_g, s.d, attr=hit.attr)
            w_hit = jnp.where(
                s.prev_delta | (~s.prev_nee) | (~jnp.asarray(mis_on)),
                1.0, mis_balance(s.prev_pdf, pdf_light))
            senses = keep_bsdf_hits | (k == 0)  # sensor edge always contributes
            contrib = thr * le * w_hit[:, None]
            add = lane_hit & min_ok & senses
            radiance = s.radiance + jnp.where(add[:, None], contrib, 0.0)
            if guide is not None and collect:
                # incident radiance along the PREVIOUS bounce direction s.d,
                # seen from s.o. Deposits arrive with frequency ~ the bounce
                # pdf, so the VALUE divides by s.prev_pdf — bin mass then
                # estimates the integral of L over the bin independent of
                # how the current guide samples (without this, mass feeds
                # back on sampling frequency and the table collapses onto
                # its own peak — measured: a near-black render at decay=1).
                inv_p = 1.0 / jnp.maximum(s.prev_pdf, 1e-4)
                dep = _gd.deposit(dep, guide, s.o, s.d,
                                  jnp.mean(le, -1) * w_hit * inv_p,
                                  add & (k > 0) & (~s.prev_delta))

            # ---- escaped rays: environment light
            esc = s.alive & (~hit.valid) & (~scattered)
            if scene.emitters.has_env:
                le_env = env_radiance(scene.emitters, s.d)
                pdf_env = env_direction_pdf(scene.emitters, s.d)
                w_env = jnp.where(
                    s.prev_delta | (~s.prev_nee) | (~jnp.asarray(mis_on)),
                    1.0, mis_balance(s.prev_pdf, pdf_env))
                radiance = radiance + jnp.where(
                    (esc & min_ok & senses)[:, None],
                    thr * le_env * w_env[:, None], 0.0)
                if guide is not None and collect:
                    dep = _gd.deposit(
                        dep, guide, s.o, s.d,
                        jnp.mean(le_env, -1) * w_env
                        / jnp.maximum(s.prev_pdf, 1e-4),
                        esc & min_ok & senses & (k > 0) & (~s.prev_delta))

            smooth = bsdf_is_smooth(scene.materials, hit.mat)
            # single_scattering: surface vertices contribute nothing further
            # (reference path.rs:120-124) — their lanes die after the emission
            if self.single_scattering:
                lane_surface = jnp.zeros(n, bool)
            else:
                lane_surface = lane_hit
            vertex = lane_surface | scattered
            can_expand = (self.max_depth is None) | (k + 1 < (self.max_depth or 0))
            can_expand = jnp.asarray(can_expand) & vertex

            p_v = jnp.where(scattered[:, None], p_scatter, hit.p)

            # ---- NEE (light strategy), path of k+2 edges
            u_sel, stream = stream_next(stream, (n,))
            u_pos, stream = stream_next2d(stream, (n,))
            if use_nee:
                if scene.ats is not None:
                    from ..scene.emitters import sample_light_ats
                    ls = sample_light_ats(scene.emitters, scene.geom, scene.ats,
                                          p_v, hit.n_s, u_sel, u_pos)
                else:
                    ls = sample_light(scene.emitters, scene.geom, p_v, u_sel, u_pos)
                wo_l = to_local(hit.frame, ls.d)
                f_s = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi, wo_l,
                                TRANSPORT_IMPORTANCE)
                pdf_s = bsdf_pdf(scene.materials, hit.mat, hit.uv, hit.wi, wo_l,
                                 TRANSPORT_IMPORTANCE)
                if has_med:
                    g = scene.volume.phase_g
                    ph = phase_eval(g, -s.d, ls.d)
                    f = jnp.where(scattered[:, None], ph[:, None], f_s)
                    pdf_other = jnp.where(scattered, ph, pdf_s)
                    tr_sh = transmittance(scene.volume, ls.dist)
                else:
                    f = f_s
                    pdf_other = pdf_s
                    tr_sh = 1.0
                if guide is not None:
                    # the directional strategy on rough surfaces is the
                    # bsdf/guide MIXTURE — its pdf enters the NEE MIS weight
                    vox_nee = _gd.voxel_of(guide, p_v)
                    pdf_other = jnp.where(
                        lane_surface & (~smooth),
                        g_alpha * _gd.guide_pdf(guide, vox_nee, ls.d)
                        + (1.0 - g_alpha) * pdf_s, pdf_other)
                p_shadow = jnp.where(
                    scattered[:, None], p_v,
                    offset_ray_origin(hit.p, hit.n_g, ls.d))
                pre_ok = (can_expand & (scattered | (lane_surface & (~smooth)))
                          & ls.valid & ((k + 1) >= self.min_depth))
                # lanes that cannot contribute shoot an inert (tfar=0)
                # shadow ray (bit-identical: nee_ok gates on pre_ok)
                vis = visible(scene.geom, p_shadow, ls.p, mask=pre_ok)
                w_nee = jnp.where(
                    ls.is_delta | (~jnp.asarray(mis_on)),
                    1.0, mis_balance(ls.pdf, pdf_other))
                nee_ok = pre_ok & vis
                radiance = radiance + jnp.where(
                    nee_ok[:, None],
                    thr * f * tr_sh * ls.weight * w_nee[:, None], 0.0)
                if guide is not None and collect:
                    # ls.weight = Le*G/pdf: the incident-radiance estimate
                    # along ls.d (f excluded — the grid learns L_i, not the
                    # product); w_nee keeps emission-hit deposits disjoint
                    dep = _gd.deposit(
                        dep, guide, p_v, ls.d,
                        jnp.mean(ls.weight * tr_sh, -1) * w_nee, nee_ok)
                    # one-bounce lookahead: the same event, seen from the
                    # PREVIOUS vertex along its bounce direction (radiance
                    # into s.o along s.d includes f_here * NEE_here). This
                    # is what lets hard-visibility paths bootstrap: a wall
                    # facing a doorway learns that the door direction glows
                    # even though its own NEE is occluded. 1/prev_pdf for
                    # the same frequency-normalization as the deposits above.
                    dep = _gd.deposit(
                        dep, guide, s.o, s.d,
                        jnp.mean(f * tr_sh * ls.weight, -1) * w_nee
                        / jnp.maximum(s.prev_pdf, 1e-4),
                        nee_ok & (k > 0) & (~s.prev_delta))

            # ---- directional bounce: BSDF at surfaces, phase in the medium
            u_bsdf, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_bsdf,
                             TRANSPORT_IMPORTANCE)
            if self.strategy == STRATEGY_NAIVE:
                bs_wo, weight, pdf_dir, is_delta, valid_dir = \
                    self._naive_bounce(scene, hit, smooth, u_bsdf, bs)
            else:
                bs_wo, weight, pdf_dir, is_delta, valid_dir = (
                    bs.wo, bs.weight, bs.pdf, bs.is_delta, bs.valid)
            wo_world = to_world(hit.frame, bs_wo)
            if guide is not None:
                # defensive one-sample MIS: with prob alpha draw from the
                # learned distribution, else from the BSDF; either way the
                # realized direction is weighted by f*cos / pdf_mixture
                u_gsel, stream = stream_next(stream, (n,))
                u_gdir, stream = stream_next2d(stream, (n,))
                vox_b = _gd.voxel_of(guide, p_v)
                d_guided, _ = _gd.guide_sample(guide, vox_b, u_gdir)
                mixable = lane_surface & (~smooth) & (
                    ~jnp.asarray(self.strategy == STRATEGY_NAIVE))
                take_g = mixable & (u_gsel < g_alpha)
                wo_world = jnp.where(take_g[:, None], d_guided, wo_world)
                wo_loc = to_local(hit.frame, wo_world)
                f_mix = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi,
                                  wo_loc, TRANSPORT_IMPORTANCE)
                pdf_b = bsdf_pdf(scene.materials, hit.mat, hit.uv, hit.wi,
                                 wo_loc, TRANSPORT_IMPORTANCE)
                pdf_mix = (g_alpha * _gd.guide_pdf(guide, vox_b, wo_world)
                           + (1.0 - g_alpha) * pdf_b)
                w_mix = f_mix / jnp.maximum(pdf_mix, 1e-20)[:, None]
                weight = jnp.where(mixable[:, None], w_mix, weight)
                pdf_dir = jnp.where(mixable, pdf_mix, pdf_dir)
                valid_dir = jnp.where(mixable, pdf_mix > 0.0, valid_dir)
                is_delta = jnp.where(mixable, False, is_delta)
            if has_med:
                d_ph, w_ph, pdf_ph = phase_sample(scene.volume.phase_g, -s.d, u_bsdf)
                wo_world = jnp.where(scattered[:, None], d_ph, wo_world)
                weight = jnp.where(scattered[:, None], w_ph, weight)
                pdf_dir = jnp.where(scattered, pdf_ph, pdf_dir)
                is_delta = jnp.where(scattered, False, is_delta)
                valid_dir = jnp.where(scattered, pdf_ph > 0.0, valid_dir)
            throughput = thr * weight

            # Russian roulette (directional.rs:77-87)
            u_rr, stream = stream_next(stream, (n,))
            if self.rr_depth is None:
                rr_keep = jnp.ones(n, bool)
                rr_w = jnp.ones(n, jnp.float32)
            else:
                do_rr = (k + 1) >= self.rr_depth
                rr_p = jnp.minimum(channel_max(throughput), 0.95)
                if guide is not None:
                    # guided bounces legitimately carry small f/pdf_mix
                    # throughput into BRIGHT regions; plain throughput-RR
                    # would kill >90% of exactly the learned paths and
                    # leave rare huge-weight survivors (measured: a 9x-dark
                    # 64spp render). Floor survival for mixture lanes.
                    rr_p = jnp.where(mixable, jnp.maximum(rr_p, 0.6), rr_p)
                rr_keep = jnp.where(do_rr, u_rr < rr_p, True)
                rr_w = jnp.where(do_rr & rr_keep, 1.0 / jnp.maximum(rr_p, 1e-8), 1.0)
            throughput = throughput * rr_w[:, None]

            alive = (can_expand & valid_dir & rr_keep
                     & (channel_max(throughput) > 0.0))
            o_new = jnp.where(scattered[:, None], p_v,
                              offset_ray_origin(hit.p, hit.n_g, wo_world))

            nee_possible = jnp.asarray(use_nee) & (scattered | (~smooth))
            return _PathState(
                k=k + 1, stream=stream,
                o=jnp.where(alive[:, None], o_new, s.o),
                d=jnp.where(alive[:, None], wo_world, s.d),
                throughput=jnp.where(alive[:, None], throughput, s.throughput),
                radiance=radiance,
                alive=alive,
                prev_pdf=jnp.where(alive, pdf_dir, s.prev_pdf),
                prev_delta=jnp.where(alive, is_delta, s.prev_delta),
                prev_nee=jnp.where(alive, nee_possible, s.prev_nee),
            ), dep

        final, dep = lax.while_loop(cond, body, (state, dep0))
        if guide is not None and collect:
            return final.radiance, dep
        return final.radiance

    # ------------------------------------------------- persistent wavefront
    def compute_block(self, scene, pix, stream, spp: int):
        """All `spp` samples of every pixel in ONE while_loop with
        pixel-pinned lane respawn (see _PersistentState): a lane whose path
        terminates immediately starts its pixel's next sample, so the
        wavefront stays ~full instead of thinning out with Russian roulette
        (~2x fewer wasted lane-bounces at cbox depths). Returns the per-pixel
        SUM over spp samples, [n, 3]."""
        n = pix.shape[0]
        pixf = pix.astype(jnp.float32)
        use_nee = self.strategy in (STRATEGY_ALL, STRATEGY_EMITTER)
        mis_on = self.strategy == STRATEGY_ALL
        keep_bsdf_hits = self.strategy in (STRATEGY_ALL, STRATEGY_BSDF,
                                           STRATEGY_NAIVE)
        has_med = scene.volume is not None
        zero3 = jnp.zeros((n, 3), jnp.float32)

        state = _PersistentState(
            it=jnp.int32(0), stream=stream, o=zero3,
            d=jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1)),
            throughput=zero3, rad_path=zero3, accum=zero3,
            alive=jnp.zeros(n, bool), done=jnp.zeros(n, jnp.int32),
            depth=jnp.zeros(n, jnp.int32),
            prev_pdf=jnp.ones(n, jnp.float32),
            prev_delta=jnp.ones(n, bool), prev_nee=jnp.zeros(n, bool),
        )
        it_cap = spp * self.hard_cap + 4

        def cond(s):
            return (s.it < it_cap) & jnp.any(s.alive | (s.done < spp))

        def body(s):
            stream = s.stream
            # ---- respawn: dead lanes with samples left start a new path
            u_pix, stream = stream_next2d(stream, (n,))
            o0, d0 = generate_rays(scene.camera, pixf + u_pix)
            need = (~s.alive) & (s.done < spp)
            nm = need[:, None]
            o = jnp.where(nm, o0, s.o)
            d = jnp.where(nm, d0, s.d)
            thr0 = jnp.where(nm, 1.0, s.throughput)
            rad_path = jnp.where(nm, 0.0, s.rad_path)
            depth = jnp.where(need, 0, s.depth)
            prev_pdf = jnp.where(need, 1.0, s.prev_pdf)
            prev_delta = jnp.where(need, True, s.prev_delta)
            prev_nee = jnp.where(need, False, s.prev_nee)
            alive = s.alive | need

            rh = intersect_rays(scene.geom, o, d,
                                tfar=jnp.where(alive, jnp.inf, 0.0))
            hit = fill_hit(scene, o, d, rh)

            if has_med:
                u_med, stream = stream_next(stream, (n,))
                tfar = jnp.where(rh.hit, rh.t, 1e8)
                sd = volume_sample_distance(scene.volume, tfar, u_med)
                scattered = alive & (~sd.exited)
                thr = thr0 * sd.w
                p_scatter = o + d * sd.t[:, None]
            else:
                scattered = jnp.zeros(n, bool)
                thr = thr0
                p_scatter = o

            lane_hit = alive & hit.valid & (~scattered)
            min_ok = depth >= self.min_depth
            le = emitted_radiance(scene.emitters, scene.geom, hit.tri, d,
                                  uv=hit.uv, attr=hit.attr)
            if scene.ats is not None:
                from ..scene.emitters import direct_pdf_tri_ats
                pdf_light = direct_pdf_tri_ats(scene.emitters, scene.geom,
                                               scene.ats, hit.tri, o, hit.p,
                                               hit.n_g, d)
            else:
                pdf_light = direct_pdf_tri(scene.emitters, hit.tri, o, hit.p,
                                           hit.n_g, d, attr=hit.attr)
            w_hit = jnp.where(
                prev_delta | (~prev_nee) | (~jnp.asarray(mis_on)),
                1.0, mis_balance(prev_pdf, pdf_light))
            senses = jnp.asarray(keep_bsdf_hits) | (depth == 0)
            add = lane_hit & min_ok & senses
            rad_path = rad_path + jnp.where(add[:, None],
                                            thr * le * w_hit[:, None], 0.0)

            esc = alive & (~hit.valid) & (~scattered)
            if scene.emitters.has_env:
                le_env = env_radiance(scene.emitters, d)
                pdf_env = env_direction_pdf(scene.emitters, d)
                w_env = jnp.where(
                    prev_delta | (~prev_nee) | (~jnp.asarray(mis_on)),
                    1.0, mis_balance(prev_pdf, pdf_env))
                rad_path = rad_path + jnp.where(
                    (esc & min_ok & senses)[:, None],
                    thr * le_env * w_env[:, None], 0.0)

            smooth = bsdf_is_smooth(scene.materials, hit.mat)
            lane_surface = (jnp.zeros(n, bool) if self.single_scattering
                            else lane_hit)
            vertex = lane_surface | scattered
            if self.max_depth is None:
                # mirror compute_pixel's hard_cap (cond at :159): without a
                # per-lane cap an rr_depth=None path could still be alive at
                # it_cap and silently DROP its radiance (the film divides by
                # full spp) — truncating at hard_cap banks the partial sum
                can_expand = vertex & (depth + 1 < self.hard_cap)
            else:
                can_expand = vertex & (depth + 1 < self.max_depth)
            p_v = jnp.where(scattered[:, None], p_scatter, hit.p)

            u_sel, stream = stream_next(stream, (n,))
            u_pos, stream = stream_next2d(stream, (n,))
            if use_nee:
                if scene.ats is not None:
                    from ..scene.emitters import sample_light_ats
                    ls = sample_light_ats(scene.emitters, scene.geom,
                                          scene.ats, p_v, hit.n_s, u_sel,
                                          u_pos)
                else:
                    ls = sample_light(scene.emitters, scene.geom, p_v, u_sel,
                                      u_pos)
                wo_l = to_local(hit.frame, ls.d)
                f_s = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi,
                                wo_l, TRANSPORT_IMPORTANCE)
                pdf_s = bsdf_pdf(scene.materials, hit.mat, hit.uv, hit.wi,
                                 wo_l, TRANSPORT_IMPORTANCE)
                if has_med:
                    g = scene.volume.phase_g
                    ph = phase_eval(g, -d, ls.d)
                    f = jnp.where(scattered[:, None], ph[:, None], f_s)
                    pdf_other = jnp.where(scattered, ph, pdf_s)
                    tr_sh = transmittance(scene.volume, ls.dist)
                else:
                    f = f_s
                    pdf_other = pdf_s
                    tr_sh = 1.0
                p_shadow = jnp.where(
                    scattered[:, None], p_v,
                    offset_ray_origin(hit.p, hit.n_g, ls.d))
                pre_ok = (can_expand & (scattered | (lane_surface & (~smooth)))
                          & ls.valid & ((depth + 1) >= self.min_depth))
                # inert shadow rays for non-contributing lanes (see
                # compute_pixel)
                vis = visible(scene.geom, p_shadow, ls.p, mask=pre_ok)
                w_nee = jnp.where(
                    ls.is_delta | (~jnp.asarray(mis_on)),
                    1.0, mis_balance(ls.pdf, pdf_other))
                nee_ok = pre_ok & vis
                rad_path = rad_path + jnp.where(
                    nee_ok[:, None],
                    thr * f * tr_sh * ls.weight * w_nee[:, None], 0.0)

            u_bsdf, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_bsdf,
                             TRANSPORT_IMPORTANCE)
            if self.strategy == STRATEGY_NAIVE:
                bs_wo, weight, pdf_dir, is_delta, valid_dir = \
                    self._naive_bounce(scene, hit, smooth, u_bsdf, bs)
            else:
                bs_wo, weight, pdf_dir, is_delta, valid_dir = (
                    bs.wo, bs.weight, bs.pdf, bs.is_delta, bs.valid)
            wo_world = to_world(hit.frame, bs_wo)
            if has_med:
                d_ph, w_ph, pdf_ph = phase_sample(scene.volume.phase_g, -d,
                                                  u_bsdf)
                wo_world = jnp.where(scattered[:, None], d_ph, wo_world)
                weight = jnp.where(scattered[:, None], w_ph, weight)
                pdf_dir = jnp.where(scattered, pdf_ph, pdf_dir)
                is_delta = jnp.where(scattered, False, is_delta)
                valid_dir = jnp.where(scattered, pdf_ph > 0.0, valid_dir)
            throughput = thr * weight

            u_rr, stream = stream_next(stream, (n,))
            if self.rr_depth is None:
                rr_keep = jnp.ones(n, bool)
                rr_w = jnp.ones(n, jnp.float32)
            else:
                do_rr = (depth + 1) >= self.rr_depth
                rr_p = jnp.minimum(channel_max(throughput), 0.95)
                rr_keep = jnp.where(do_rr, u_rr < rr_p, True)
                rr_w = jnp.where(do_rr & rr_keep,
                                 1.0 / jnp.maximum(rr_p, 1e-8), 1.0)
            throughput = throughput * rr_w[:, None]

            alive_new = (can_expand & valid_dir & rr_keep
                         & (channel_max(throughput) > 0.0))
            o_new = jnp.where(scattered[:, None], p_v,
                              offset_ray_origin(hit.p, hit.n_g, wo_world))
            nee_possible = jnp.asarray(use_nee) & (scattered | (~smooth))

            # ---- sample bookkeeping: paths that just ended bank their sum
            finished = alive & (~alive_new)
            accum = s.accum + jnp.where(finished[:, None], rad_path, 0.0)
            done = s.done + finished.astype(jnp.int32)

            return _PersistentState(
                it=s.it + 1, stream=stream,
                o=jnp.where(alive_new[:, None], o_new, o),
                d=jnp.where(alive_new[:, None], wo_world, d),
                throughput=jnp.where(alive_new[:, None], throughput, thr),
                rad_path=rad_path, accum=accum,
                alive=alive_new, done=done, depth=depth + 1,
                prev_pdf=jnp.where(alive_new, pdf_dir, prev_pdf),
                prev_delta=jnp.where(alive_new, is_delta, prev_delta),
                prev_nee=jnp.where(alive_new, nee_possible, prev_nee),
            )

        final = lax.while_loop(cond, body, state)
        return final.accum
