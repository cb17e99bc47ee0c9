"""Energy-redistribution path tracing (ERPT).

Reference: src/integrators/mcmc/erpt.rs — per pixel, `nb_mc` exploration
samples; each contributive sample spawns a Poisson-ish number of small-step
MCMC chains (floor(mean + u)) that redistribute its energy under the
equal-deposit rule w0 = b / (chains_per_pixel * chain_samples).

Wavefront adaptation (P5 in SURVEY.md §2.10): chain spawning is data-dependent, so
the wavefront uses fixed-budget *weighted* spawning: each exploration lane
runs at most one chain, spawned with probability p = min(1, mean_chains) and
deposit weight scaled by mean_chains / p — identical expectation, fully
static shapes. The optional image-plane stratification with random-number
remapping (erpt.rs:209-226) is mirrored exactly.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...samplers.pss import kelemen_mutate
from ...utils.film import Film
from ...utils.rng import make_stream, stream_fold, ArrayStream
from .pssmlt import _uniform


class IntegratorERPT:
    averaging = True

    def __init__(self, integrator, nb_mc: int = 1, chain_samples: int = 100,
                 stratified: bool = True, nb_samples_norm: int = 65536,
                 pss_dims: Optional[int] = None, poisson_slots: int = 1):
        self.integrator = integrator
        self.nb_mc = nb_mc
        self.chain_samples = chain_samples
        self.stratified = stratified
        self.nb_samples_norm = nb_samples_norm
        # chain slots per exploration lane. The reference spawns
        # floor(mean + u) chains (erpt.rs:180-208); slot s runs an exact
        # Bernoulli P(count > s) = clip(mean - s, 0, 1) chain with the plain
        # equal-deposit weight, and the LAST slot absorbs the tail with the
        # weighted spawn (expectation-exact truncation). poisson_slots=1
        # reduces to the fixed-budget weighted spawning.
        self.poisson_slots = max(1, poisson_slots)
        cap = getattr(integrator, "hard_cap", 16)
        self.pss_dims = pss_dims or (4 + 6 * cap)

    def _sample_fn(self, scene, u):
        cam = scene.camera
        x = jnp.clip((u[:, 0] * cam.width).astype(jnp.int32), 0, cam.width - 1)
        y = jnp.clip((u[:, 1] * cam.height).astype(jnp.int32), 0, cam.height - 1)
        pix = jnp.stack([x, y], axis=-1)
        stream = ArrayStream(values=u, counter=jnp.int32(2))
        li = self.integrator.compute_pixel(scene, pix, stream)
        li = jnp.where(jnp.all(jnp.isfinite(li), -1, keepdims=True), li, 0.0)
        return y * cam.width + x, li, jnp.mean(li, axis=-1)

    def render(self, scene, spp: int, seed: int = 0, verbose: bool = False,
               mesh=None) -> Film:
        """`mesh` (1-axis Mesh over 'd'): exploration lanes and their spawned
        chains shard over devices, each splatting a private full-resolution
        film merged by one psum per round (the reference's per-pixel chain
        spawning P5 + mutex merge P6, erpt.rs:109-263)."""
        cam = scene.camera
        w, h = cam.width, cam.height
        n = w * h
        d = self.pss_dims
        base = make_stream(seed)
        spp_mcmc = max(1, spp - self.nb_mc)
        chains_per_pixel = spp_mcmc / self.chain_samples

        # normalization constant b (average_lum, mcmc/mod.rs:105-118)
        @jax.jit
        def norm_batch(i):
            u, _ = _uniform(stream_fold(base, 900 + i), (n, d))
            _, _, tf = self._sample_fn(scene, u)
            return jnp.mean(tf)
        n_b = max(1, self.nb_samples_norm // n)
        b = float(np.mean([float(norm_batch(jnp.int32(i)))
                           for i in range(n_b)]))
        if b <= 0:
            raise RuntimeError("ERPT normalization is zero")

        px = jnp.remainder(
            jax.lax.broadcasted_iota(jnp.int32, (n,), 0), w).astype(jnp.float32)
        py = (jax.lax.broadcasted_iota(jnp.int32, (n,), 0) // w).astype(jnp.float32)

        def round_body(stream, px, py, live):
            nl = px.shape[0]
            u, stream = _uniform(stream, (nl, d))
            if self.stratified:
                # force the exploration pixel to the lane's own pixel, keeping
                # the draw as sub-pixel position — the same remapping the
                # reference applies before spawning chains (erpt.rs:209-226)
                u = u.at[:, 0].set((u[:, 0] + px) / w)
                u = u.at[:, 1].set((u[:, 1] + py) / h)
            pid0, col0, tf0 = self._sample_fn(scene, u)

            mean_chains = (tf0 / b) * (chains_per_pixel / self.nb_mc)
            w_base = b / (chains_per_pixel * self.chain_samples)

            def run_chain(spawn, w0, film, stream):
                """One MCMC chain per spawned lane, redistributing the
                exploration sample's energy (equal-deposit rule)."""
                def step(s, carry):
                    uv, tf, pid, col, wgt, film, stream = carry
                    um, stream = _uniform(stream, (nl, d))
                    ua, stream = _uniform(stream, (nl,))
                    u_prop = kelemen_mutate(uv, um)       # small steps only
                    pid_p, col_p, tf_p = self._sample_fn(scene, u_prop)
                    a = jnp.minimum(1.0, tf_p / jnp.maximum(tf, 1e-30))
                    a = jnp.where(tf_p > 0.0, a, 0.0)
                    w_cur = wgt + (1.0 - a)
                    accept = ua < a
                    spl_pid = jnp.where(accept, pid, pid_p)
                    spl_col = jnp.where(accept[:, None], col, col_p)
                    spl_tf = jnp.where(accept, tf, tf_p)
                    spl_w = jnp.where(accept, w_cur, a)
                    val = spl_col * (
                        w0 * spl_w / jnp.maximum(spl_tf, 1e-30))[:, None]
                    val = jnp.where((spawn & (spl_tf > 0.0))[:, None], val,
                                    0.0)
                    film = film.at[spl_pid].add(val, mode="drop")
                    return (jnp.where(accept[:, None], u_prop, uv),
                            jnp.where(accept, tf_p, tf),
                            jnp.where(accept, pid_p, pid),
                            jnp.where(accept[:, None], col_p, col),
                            jnp.where(accept, a, w_cur), film, stream)

                wgt = jnp.zeros((nl,), jnp.float32)
                uv, tf, pid, col, wgt, film, stream = jax.lax.fori_loop(
                    0, self.chain_samples, step,
                    (u, tf0, pid0, col0, wgt, film, stream))
                # flush
                val = col * (w0 * wgt / jnp.maximum(tf, 1e-30))[:, None]
                val = jnp.where((spawn & (tf > 0.0))[:, None], val, 0.0)
                return film.at[pid].add(val, mode="drop"), stream

            # chain slots: the reference spawns floor(mean + u) chains
            # (erpt.rs:180-208). Slots 0..k-2 are exact Bernoulli draws
            # P(count > s) = clip(mean - s, 0, 1) with the plain deposit
            # weight; the last slot absorbs the tail with the weighted
            # spawn so the truncated count keeps the exact expectation.
            film = jnp.zeros((w * h, 3), jnp.float32)
            slots = self.poisson_slots
            for s in range(slots):
                u_spawn, stream = _uniform(stream, (nl,))
                if s < slots - 1:
                    p_s = jnp.clip(mean_chains - s, 0.0, 1.0)
                    w_sp = 1.0
                else:
                    rest = jnp.maximum(mean_chains - s, 0.0)
                    p_s = jnp.clip(rest, 0.0, 1.0)
                    w_sp = jnp.where(p_s > 0,
                                     rest / jnp.maximum(p_s, 1e-20), 0.0)
                spawn_s = (u_spawn < p_s) & (tf0 > 0.0) & live
                film, stream = run_chain(spawn_s, w_base * w_sp, film, stream)
            return film

        if mesh is None:
            live = jnp.ones(n, bool)

            @jax.jit
            def mc_round(round_idx):
                return round_body(stream_fold(base, round_idx), px, py, live)
        else:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            def device_fn(round_idx, px_, py_, live_):
                dev = jax.lax.axis_index("d")
                stream = stream_fold(stream_fold(base, dev), round_idx)
                return jax.lax.psum(round_body(stream, px_, py_, live_), "d")

            fn = shard_map(device_fn, mesh=mesh,
                           in_specs=(P(), P("d"), P("d"), P("d")),
                           out_specs=P(), check_vma=False)
            # pad lanes to a multiple of the device count; dead lanes carry
            # live=False so they can never spawn chains or deposit energy
            pad = (-n) % mesh.shape["d"]
            pxp = jnp.concatenate([px, jnp.zeros(pad, jnp.float32)])
            pyp = jnp.concatenate([py, jnp.zeros(pad, jnp.float32)])
            live = jnp.concatenate([jnp.ones(n, bool), jnp.zeros(pad, bool)])
            mc_round = jax.jit(lambda r: fn(r, pxp, pyp, live))

        acc = jnp.zeros((n, 3), jnp.float32)
        for r in range(self.nb_mc):
            acc = acc + mc_round(jnp.int32(r))
        acc.block_until_ready()

        film = Film(w, h)
        film.buffers["primal"] = np.asarray(acc).reshape(h, w, 3)
        return film
