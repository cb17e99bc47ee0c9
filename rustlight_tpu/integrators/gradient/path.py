"""Gradient-domain path tracing, random-replay shift mapping.

Reference: src/integrators/gradient/explicit.rs + shiftmapping/random_replay.rs
— the base path renders pixel p with a recorded random sequence; the four
offset pixels re-render with the *same* sequence; each shift contributes
  base 0.5*L_b, offset 0.5*L_o, gradient 0.5*(L_o - L_b)
with primal[p] += main, primal[p+off] += offset, gradient buffers signed by
direction, and a final 0.25 primal scale (explicit.rs:127-199).

On the wavefront, "replaying the random sequence" is free: the PSS vector is
an explicit array (ArrayStream), so the offset paths simply reuse it — the
natural wavefront form of the shift. `min_survival` implements the adaptive path
survival (explicit.rs:246-257) as a weighted evaluation instead of a skip.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...utils.film import Film
from ...utils.rng import make_stream, stream_fold, ArrayStream
from ...utils.vec import luminance
from ..common import _pixel_grid
from ..path import IntegratorPathTracing
from .recons import (
    uniform_poisson_reconstruction, weighted_poisson_reconstruction,
    bagging_poisson_reconstruction,
)

# (dy, dx) offsets and their gradient buffer/sign (gradient/mod.rs:31-42)
_OFFSETS = [(1, 0, "y", +1), (-1, 0, "y", -1), (0, 1, "x", +1), (0, -1, "x", -1)]


def _uniform(stream, shape):
    u = jax.random.uniform(jax.random.fold_in(stream.key, stream.counter),
                           shape, dtype=jnp.float32)
    return u, stream.replace(counter=stream.counter + 1)


def _lane_constraint(mesh):
    """Row-band sharding annotation for lane/film arrays. GDPT's mesh mode
    is pure GSPMD (the reference parallelizes GDPT over rayon blocks with a
    1-px apron, gradient/mod.rs:58-135): lanes and (h, w, 3) films carry a
    `with_sharding_constraint` on the leading axis, XLA partitions the
    per-lane transport and lowers the 1-pixel film shifts (`_shift2d`) to
    collective-permute halo exchanges — the same roll-based
    pattern SMCMC's replica exchange uses."""
    if mesh is None:
        return lambda x: x
    from jax.sharding import NamedSharding, PartitionSpec as P

    def constrain(x):
        spec = P("d", *([None] * (x.ndim - 1)))
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
    return constrain


def _shift2d(img, dy, dx):
    """Scatter lane (y, x)'s value to (y+dy, x+dx): out[q] = img[q - o].
    Callers zero the lanes whose target falls outside the film, so the
    wrap-around rows/columns carry zeros and a plain roll is exact."""
    return jnp.roll(img, (dy, dx), axis=(0, 1))


class IntegratorGradientPath:
    averaging = True

    def __init__(self, max_depth: Optional[int] = None,
                 recons: str = "uniform", recons_iterations: int = 50,
                 min_survival: Optional[float] = None,
                 nb_buffers: Optional[int] = None,
                 hard_cap: int = 8, pss_dims: Optional[int] = None):
        self.max_depth = max_depth
        self.recons = recons
        self.iterations = recons_iterations
        self.min_survival = min_survival
        # reference: rr disabled inside GDPT paths (explicit.rs:226)
        self.inner = IntegratorPathTracing(max_depth=max_depth, rr_depth=None,
                                           hard_cap=hard_cap)
        self.pss_dims = pss_dims or (2 + 6 * self.inner.hard_cap)
        if nb_buffers is None:
            nb_buffers = {"uniform": 1, "weighted": 2, "bagging": 4}[recons]
        self.nb_buffers = nb_buffers
        # capture_hlo=True stashes the compiled HLO of the production pass
        # in self.last_hlo on the next render() (same hook as SMCMC's) —
        # used to assert the sharded y-halo lowers to a collective-permute
        self.capture_hlo = False
        self.last_hlo = None

    def _eval(self, scene, pix, u):
        stream = ArrayStream(values=u, counter=jnp.int32(0))
        li = self.inner.compute_pixel(scene, pix, stream)
        return jnp.where(jnp.all(jnp.isfinite(li), -1, keepdims=True), li, 0.0)

    def render(self, scene, spp: int, seed: int = 0, verbose: bool = False,
               mesh=None) -> Film:
        cam = scene.camera
        w, h = cam.width, cam.height
        n = w * h
        d = self.pss_dims
        base = make_stream(seed)
        pix = jnp.asarray(_pixel_grid(w, h))
        px = pix[:, 0]
        py = pix[:, 1]
        pid = py * w + px

        # scene closed over: compile-time constants;
        # the RNG base is an argument so avg-mode passes reuse the executable
        from ..common import _BLOCK_CACHE, _cache_put
        ck = (id(scene), id(self), w, h, "gdpt-replay",
              id(mesh) if mesh is not None else None)
        one_pass_c = _BLOCK_CACHE.get(ck)
        if one_pass_c is None:
            one_pass_c = self._make_pass(scene, pix, px, py, pid, w, h, n, d,
                                         mesh)
            _cache_put(ck, one_pass_c)
        if self.capture_hlo:
            self.last_hlo = one_pass_c.lower(
                base, jnp.int32(0)).compile().as_text()
        one_pass = lambda s: one_pass_c(base, s)

        return _render_gradient_film(scene, spp, one_pass, self.nb_buffers,
                                     self.recons, self.iterations, w, h)

    def _make_pass(self, scene, pix, px, py, pid, w, h, n, d, mesh=None):
        constrain = _lane_constraint(mesh)

        @jax.jit
        def one_pass(base, s):
            stream = stream_fold(base, s)
            u, stream = _uniform(stream, (n, d))
            u = constrain(u)
            lb = self._eval(scene, constrain(pix), u)

            if self.min_survival is not None:
                u_s, stream = _uniform(stream, (n,))
                prob = jnp.clip(luminance(lb) / 0.1, self.min_survival, 1.0)
                keep = (prob >= 1.0) | (constrain(u_s) < prob)
                w_surv = jnp.where(keep, 1.0 / prob, 0.0)
            else:
                w_surv = jnp.ones(n, jnp.float32)

            # film assembly by 2D shifts: the scatter targets are fixed
            # ±1-pixel displacements, so scatter-at-(p+o) == roll-by-o of
            # the source grid (zero at the film edge via the inside mask) —
            # elementwise + roll shards cleanly over a row-banded mesh
            primal = constrain(jnp.zeros((h, w, 3), jnp.float32))
            gxb = jnp.zeros_like(primal)
            gyb = jnp.zeros_like(primal)
            for (dy, dx, axis, sign) in _OFFSETS:
                ox = px + dx
                oy = py + dy
                inside = ((ox >= 0) & (ox < w) & (oy >= 0) & (oy < h)
                          ).reshape(h, w, 1)
                opix = jnp.stack([jnp.clip(ox, 0, w - 1),
                                  jnp.clip(oy, 0, h - 1)], -1)
                lo = self._eval(scene, constrain(opix), u)
                main = (0.5 * lb * w_surv[:, None]).reshape(h, w, 3)
                offv = (0.5 * lo * w_surv[:, None]).reshape(h, w, 3)
                grad = (0.5 * (lo - lb) * w_surv[:, None]).reshape(h, w, 3)
                primal = primal + jnp.where(inside, main, 0.0)
                primal = primal + _shift2d(jnp.where(inside, offv, 0.0),
                                           dy, dx)
                g = jnp.where(inside, grad, 0.0)
                gbuf = gxb if axis == "x" else gyb
                if sign > 0:
                    gbuf = gbuf + g
                else:
                    gbuf = gbuf - _shift2d(g, dy, dx)
                if axis == "x":
                    gxb = gbuf
                else:
                    gyb = gbuf
            return (primal.reshape(n, 3) * 0.25, gxb.reshape(n, 3),
                    gyb.reshape(n, 3))

        return one_pass


def _render_gradient_film(scene, spp, one_pass, nb, recons, iterations, w, h):
    """Shared GDPT film driver: per-pass buffer rotation (for weighted/bagging
    reconstructions), Poisson reconstruction, very_direct add-back
    (gradient/path.rs compute_gradients:103-216 + recons.rs:151-292)."""
    primal_acc = np.zeros((nb, h * w, 3), np.float32)
    gx_acc = np.zeros((nb, h * w, 3), np.float32)
    gy_acc = np.zeros((nb, h * w, 3), np.float32)
    vd_acc = np.zeros((h * w, 3), np.float32)
    counts = np.zeros(nb, np.int64)
    for s in range(spp):
        out = one_pass(jnp.int32(s))
        p_, gx_, gy_ = out[:3]
        vd_ = out[3] if len(out) > 3 else None
        b = s % nb
        primal_acc[b] += np.asarray(p_)
        gx_acc[b] += np.asarray(gx_)
        gy_acc[b] += np.asarray(gy_)
        if vd_ is not None:
            vd_acc += np.asarray(vd_)
        counts[b] += 1
    counts = np.maximum(counts, 1)[:, None, None]
    primal_acc /= counts
    gx_acc /= counts
    gy_acc /= counts
    vd_acc /= spp

    shape = (nb, h, w, 3)
    ps = jnp.asarray(primal_acc.reshape(shape))
    gxs = jnp.asarray(gx_acc.reshape(shape))
    gys = jnp.asarray(gy_acc.reshape(shape))
    vd = vd_acc.reshape(h, w, 3)

    film = Film(w, h)
    film.buffers["primal_raw"] = np.asarray(ps.mean(0)) + vd
    film.buffers["very_direct"] = vd
    film.buffers["gradient_x"] = np.asarray(gxs.mean(0))
    film.buffers["gradient_y"] = np.asarray(gys.mean(0))

    if recons == "uniform":
        out = uniform_poisson_reconstruction(
            ps.mean(0), gxs.mean(0), gys.mean(0), iterations=iterations)
    elif recons == "weighted":
        out = weighted_poisson_reconstruction(ps, gxs, gys,
                                              iterations=iterations)
    elif recons == "bagging":
        out, var, relerr = bagging_poisson_reconstruction(
            ps, gxs, gys, iterations=iterations)
        film.buffers["primal_variance"] = np.asarray(var)
        film.buffers["relerr"] = np.asarray(relerr)
    else:
        raise ValueError(recons)
    film.buffers["primal"] = np.asarray(out) + vd
    return film
