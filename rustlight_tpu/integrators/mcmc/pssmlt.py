"""Primary-sample-space Metropolis light transport (PSSMLT / Kelemen MLT).

Reference: src/integrators/mcmc/pssmlt.rs + mcmc/mod.rs:67-103. The target
function is any pixel integrator evaluated at a PSS vector: the first two
dims choose the pixel, the rest drive the path sampling.

Wavefront redesign (P3 in SURVEY.md §2.10): instead of `total/100k` rayon chains
with lazily-replayed RNG, thousands of chains advance in lockstep, one dense
PSS array per chain. Seeding keeps the explicit seed *arrays* (no RNG-replay
reconstruction, which the reference itself flags as fragile, pssmlt.rs:68-74).
Algorithm mirrored exactly: normalization estimate b over N samples, seed CDF
proportional to tf, stratified seed selection, large-step probability,
Kelemen mutations, waste recycling, final b/avg_luminance rescale.
"""
from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...samplers.pss import kelemen_mutate, KelemenParams
from ...utils.distribution import build_distribution_1d
from ...utils.film import Film
from ...utils.rng import (
    RngStream, make_stream, stream_fold, make_array_stream, ArrayStream,
)


def _uniform(stream: RngStream, shape):
    u = jax.random.uniform(jax.random.fold_in(stream.key, stream.counter),
                           shape, dtype=jnp.float32)
    return u, stream.replace(counter=stream.counter + 1)


class IntegratorPSSMLT:
    """Wraps a pixel integrator (the `IntegratorMC` analogue) as MCMC target."""

    averaging = True

    # nb_chains default fills the device with full-width wavefronts
    # (shorter chains); not yet tuned on the H100.
    # The reference sizes chains as total/100k on CPU threads
    # (pssmlt.rs:34-38); lane count is the analogous resource here.
    def __init__(self, integrator, large_prob: float = 0.3,
                 nb_samples_norm: int = 100_000,
                 nb_chains: int = 65536,
                 pss_dims: Optional[int] = None):
        self.integrator = integrator
        self.large_prob = large_prob
        self.nb_samples_norm = nb_samples_norm
        self.nb_chains = nb_chains
        cap = getattr(integrator, "hard_cap", 16)
        # 2 pixel dims + 2 jitter + 6 per bounce (NEE 3, bsdf 2, rr 1)
        self.pss_dims = pss_dims or (4 + 6 * cap)

    # target function: PSS vector -> (pixel id, color, tf)
    def _sample_fn(self, scene, u):
        cam = scene.camera
        x = jnp.clip((u[:, 0] * cam.width).astype(jnp.int32), 0, cam.width - 1)
        y = jnp.clip((u[:, 1] * cam.height).astype(jnp.int32), 0, cam.height - 1)
        pix = jnp.stack([x, y], axis=-1)
        stream = ArrayStream(values=u, counter=jnp.int32(2))
        li = self.integrator.compute_pixel(scene, pix, stream)
        li = jnp.where(jnp.all(jnp.isfinite(li), -1, keepdims=True), li, 0.0)
        tf = jnp.mean(li, axis=-1)   # (r+g+b)/3 (mcmc/mod.rs:26)
        return y * cam.width + x, li, tf

    def render(self, scene, spp: int, seed: int = 0, verbose: bool = False,
               mesh=None) -> Film:
        """When `mesh` (a 1-axis jax.sharding.Mesh over axis 'd') is given,
        the chain population is split evenly over its devices — the reference
        runs `total/100k` chains as independent rayon tasks
        (pssmlt.rs:34-108); here each device evolves its chain shard into a
        private film and one psum merges the films (P3+P6)."""
        cam = scene.camera
        w, h = cam.width, cam.height
        c = self.nb_chains
        if mesh is not None:
            n_dev = mesh.shape["d"]
            c = max(1, c // n_dev) * n_dev   # even chain shards
        d = self.pss_dims
        total = spp * w * h
        steps = max(1, total // c)
        base = make_stream(seed)

        # executables cached per (scene, config); the RNG base is an argument
        # so repeated avg-mode passes with fresh seeds reuse the compilation
        from ..common import _BLOCK_CACHE, _cache_put

        # ---------------- normalization + seed pool
        n_batches = max(1, (self.nb_samples_norm + c - 1) // c)

        nk = (id(scene), id(self), c, d, "pssmlt-norm")
        norm_batch = _BLOCK_CACHE.get(nk)
        if norm_batch is None:
            @jax.jit
            def norm_batch(base, i):
                u, _ = _uniform(stream_fold(base, 1000 + i), (c, d))
                _, _, tf = self._sample_fn(scene, u)
                return u, tf
            _cache_put(nk, norm_batch)

        seeds_u, seeds_tf = [], []
        for i in range(n_batches):
            u, tf = norm_batch(base, jnp.int32(i))
            seeds_u.append(u)
            seeds_tf.append(tf)
        seeds_u = jnp.concatenate(seeds_u, 0)
        seeds_tf = jnp.concatenate(seeds_tf, 0)
        b = float(jnp.mean(seeds_tf))
        if b <= 0.0:
            raise RuntimeError("PSSMLT normalization is zero — no light found")

        cdf = build_distribution_1d(seeds_tf)
        # stratified seed selection (pssmlt.rs:60-66)
        idv = (jnp.arange(c, dtype=jnp.float32) + 0.5) / c
        sidx = jnp.clip(jnp.searchsorted(cdf.cdf, idv, side="right") - 1,
                        0, seeds_tf.shape[0] - 1)
        u0 = seeds_u[sidx]
        tf0 = seeds_tf[sidx]
        pid0, col0, _ = self._sample_fn(scene, u0)

        # ---------------- chain evolution
        rk = (id(scene), id(self), c, d, steps, w, h, id(mesh), "pssmlt-run")
        run = _BLOCK_CACHE.get(rk)
        if run is None:
            run = self._make_run(scene, c, d, steps, w, h, mesh=mesh)
            _cache_put(rk, run)

        t0 = time.time()
        film_dev = run(base, u0, tf0, pid0, col0)
        film_dev.block_until_ready()
        if verbose:
            print(f"pssmlt: {c} chains x {steps} steps in {time.time()-t0:.2f}s")

        img = np.asarray(film_dev).reshape(h, w, 3)
        # final rescale to absolute units (pssmlt.rs:114-118)
        avg_lum = img.mean()
        if avg_lum > 0:
            img = img * (b / avg_lum)
        film = Film(w, h)
        film.buffers["primal"] = img
        return film

    def _make_run(self, scene, c, d, steps, w, h, mesh=None):
        def evolve(stream0, u0, tf0, pid0, col0):
            """Evolve a chain block for `steps`, returning its film."""
            cc = u0.shape[0]

            def step(s, carry):
                u, tf, pid, col, wgt, film, stream = carry
                ul, stream = _uniform(stream, (cc,))
                uf, stream = _uniform(stream, (cc, d))
                um, stream = _uniform(stream, (cc, d))
                ua, stream = _uniform(stream, (cc,))

                large = ul < self.large_prob
                u_prop = jnp.where(large[:, None], uf, kelemen_mutate(u, um))
                pid_p, col_p, tf_p = self._sample_fn(scene, u_prop)

                a = jnp.minimum(1.0, tf_p / jnp.maximum(tf, 1e-30))
                a = jnp.where(tf_p > 0.0, a, 0.0)
                w_cur = wgt + (1.0 - a)
                w_prop = a
                accept = ua < a

                # splat the state being discarded (waste recycling)
                spl_pid = jnp.where(accept, pid, pid_p)
                spl_col = jnp.where(accept[:, None], col, col_p)
                spl_tf = jnp.where(accept, tf, tf_p)
                spl_w = jnp.where(accept, w_cur, w_prop)
                val = spl_col * (spl_w / jnp.maximum(spl_tf, 1e-30))[:, None]
                val = jnp.where((spl_tf > 0.0)[:, None], val, 0.0)
                film = film.at[spl_pid].add(val, mode="drop")

                u = jnp.where(accept[:, None], u_prop, u)
                tf = jnp.where(accept, tf_p, tf)
                pid = jnp.where(accept, pid_p, pid)
                col = jnp.where(accept[:, None], col_p, col)
                wgt = jnp.where(accept, w_prop, w_cur)
                return u, tf, pid, col, wgt, film, stream

            film = jnp.zeros((h * w, 3), jnp.float32)
            wgt = jnp.zeros((cc,), jnp.float32)
            u, tf, pid, col, wgt, film, stream = jax.lax.fori_loop(
                0, steps, step, (u0, tf0, pid0, col0, wgt, film, stream0))
            # flush final states
            val = col * (wgt / jnp.maximum(tf, 1e-30))[:, None]
            val = jnp.where((tf > 0.0)[:, None], val, 0.0)
            film = film.at[pid].add(val, mode="drop")
            return film

        if mesh is None:
            @jax.jit
            def run(base, u0, tf0, pid0, col0):
                return evolve(stream_fold(base, 77), u0, tf0, pid0, col0)
            return run

        # chain-parallel over the mesh: each device evolves its chain shard
        # into a private film; one psum merges (reference: independent rayon
        # chains + mutex film merge, pssmlt.rs:34-108 — P3/P6 as one psum)
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        def device_fn(base, u0, tf0, pid0, col0):
            dev = jax.lax.axis_index("d")
            stream0 = stream_fold(stream_fold(base, dev), 77)
            film = evolve(stream0, u0, tf0, pid0, col0)
            return jax.lax.psum(film, "d")

        fn = shard_map(device_fn, mesh=mesh,
                       in_specs=(P(), P("d", None), P("d"), P("d"),
                                 P("d", None)),
                       out_specs=P(), check_vma=False)
        return jax.jit(fn)
