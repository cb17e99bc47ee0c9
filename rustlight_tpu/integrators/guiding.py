"""Practical path guiding on the wavefront (beyond the reference).

A world-space voxel grid stores per-voxel directional radiance histograms
(equal-solid-angle bins); path vertices deposit their incident-radiance
estimates, and the directional bounce samples a defensive one-sample-MIS
mixture of the BSDF and the learned distribution. The wavefront makes both
halves cheap table ops: deposits are one scatter-add per bounce, guided
sampling is a 128-lane categorical draw per lane (the histogram row rides a
gather), and the mixture pdf keeps the estimator unbiased for ANY table
contents because every bin keeps a uniform prior mass.

Design after "Practical Path Guiding" (Mueller et al. 2017) simplified for
lockstep lanes: regular grid instead of an adaptive SD-tree, equal-solid-
angle binning so pdf(d) = w_bin * B / (4pi * sum_w) with no per-bin area
table. Retrieved-paper context: PAPERS.md (wavefront path guiding)."""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import pytree

_PI = np.pi
N_THETA = 8          # cos-theta slabs (equal solid angle)
N_PHI = 16
N_BINS = N_THETA * N_PHI          # 128 bins
# Per-bin prior mass: only needs to make cold-start rows samplable — the
# DEFENSIVE MIXTURE is what bounds weights (pdf_mix >= (1-alpha)*pdf_bsdf,
# so a tiny guide pdf can at most double the BSDF-only weight). A large
# prior (1.0/bin = 128/row) was measured to swamp the learned mass entirely.
UNIFORM_PRIOR = 0.01


@pytree.dataclass
class GuideGrid:
    g: int = pytree.field(static=True)          # voxels per axis
    lo: Any = None                                    # [3] world bounds
    inv_extent: Any = None                            # [3] 1/(hi-lo)
    table: Any = None                                 # [g^3, N_BINS] weights


def make_guide_grid(scene, g: int = 16) -> GuideGrid:
    geom = scene.host.data.geom if getattr(scene, "host", None) else scene.geom
    v0 = np.asarray(geom.v0[: geom.n_tris])
    p1 = v0 + np.asarray(geom.e1[: geom.n_tris])
    p2 = v0 + np.asarray(geom.e2[: geom.n_tris])
    lo = np.minimum(np.minimum(v0.min(0), p1.min(0)), p2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), p1.max(0)), p2.max(0))
    ext = np.maximum(hi - lo, 1e-6)
    return GuideGrid(
        g=g,
        lo=jnp.asarray(lo - 1e-4 * ext, jnp.float32),
        inv_extent=jnp.asarray(1.0 / (ext * (1 + 2e-4)), jnp.float32),
        table=jnp.zeros((g ** 3, N_BINS), jnp.float32),
    )


def voxel_of(grid: GuideGrid, p):
    """[n, 3] world points -> [n] flat voxel ids (clipped into the grid)."""
    f = (p - grid.lo[None, :]) * grid.inv_extent[None, :]
    i = jnp.clip((f * grid.g).astype(jnp.int32), 0, grid.g - 1)
    return (i[:, 0] * grid.g + i[:, 1]) * grid.g + i[:, 2]


def bin_of(d):
    """[n, 3] unit directions -> [n] equal-solid-angle bin ids."""
    ct = jnp.clip(d[:, 2], -1.0, 1.0)
    ti = jnp.clip(((ct + 1.0) * (N_THETA / 2.0)).astype(jnp.int32),
                  0, N_THETA - 1)
    phi = jnp.arctan2(d[:, 1], d[:, 0])
    phi = jnp.where(phi < 0, phi + 2 * _PI, phi)
    pi_ = jnp.clip((phi * (N_PHI / (2 * _PI))).astype(jnp.int32),
                   0, N_PHI - 1)
    return ti * N_PHI + pi_


def _row_weights(grid: GuideGrid, vox):
    row = jnp.take(grid.table, vox, axis=0) + UNIFORM_PRIOR   # [n, B]
    return row, jnp.sum(row, axis=1)


def guide_pdf(grid: GuideGrid, vox, d):
    """Solid-angle pdf of the learned distribution at directions d [n, 3]."""
    row, tot = _row_weights(grid, vox)
    w = jnp.take_along_axis(row, bin_of(d)[:, None], axis=1)[:, 0]
    return w * (N_BINS / (4.0 * _PI)) / jnp.maximum(tot, 1e-30)


def guide_sample(grid: GuideGrid, vox, u):
    """Sample d ~ learned distribution; u [n, 2]. Returns (d, pdf)."""
    row, tot = _row_weights(grid, vox)
    cdf = jnp.cumsum(row, axis=1)
    target = u[:, 0:1] * cdf[:, -1:]
    b = jnp.sum((cdf < target).astype(jnp.int32), axis=1)
    b = jnp.clip(b, 0, N_BINS - 1)
    ti = b // N_PHI
    pi_ = b - ti * N_PHI
    # uniform within the bin: cos-theta uniform in the slab, phi uniform.
    # reuse the CDF residual as a fresh uniform for cos-theta (exact: the
    # within-bin offset of an inverse-CDF draw is U[0,1) given the bin)
    lo_c = cdf[jnp.arange(b.shape[0]), b] - row[jnp.arange(b.shape[0]), b]
    u_in = (target[:, 0] - lo_c) / jnp.maximum(
        row[jnp.arange(b.shape[0]), b], 1e-30)
    u_in = jnp.clip(u_in, 0.0, 1.0 - 1e-7)
    ct = -1.0 + (ti.astype(jnp.float32) + u_in) * (2.0 / N_THETA)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    phi = (pi_.astype(jnp.float32) + u[:, 1]) * (2 * _PI / N_PHI)
    d = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    w = row[jnp.arange(b.shape[0]), b]
    pdf = w * (N_BINS / (4.0 * _PI)) / jnp.maximum(tot, 1e-30)
    return d, pdf


def deposit(acc, grid: GuideGrid, p, d, value, ok):
    """Scatter incident-radiance estimates into the [g^3 * N_BINS] flat
    accumulator: value [n] at (voxel(p), bin(d)) where ok."""
    idx = voxel_of(grid, p) * N_BINS + bin_of(d)
    idx = jnp.where(ok, idx, acc.shape[0])          # OOB -> dropped
    return acc.at[idx].add(jnp.where(ok, value, 0.0), mode="drop")


def render_guided(scene, integrator, spp: int, seed: int = 0, g: int = 16,
                  alpha: float = 0.5, decay: float = 0.8,
                  verbose: bool = False, grid: "GuideGrid" = None,
                  return_grid: bool = False, mesh=None):
    """Guided progressive render: every 1-spp pass renders with the current
    grid (traced as a jit ARGUMENT — updating it never recompiles) and
    deposits incident-radiance estimates that train the next pass. Each pass
    is individually unbiased (its grid depends only on EARLIER passes), so
    all passes accumulate with equal weight.

    `grid` continues training from an existing table (pass persistence —
    see IntegratorGuidedPath); `return_grid` also returns the trained grid.
    `mesh` shards the pixel wavefront over the device mesh ('d' axis) with
    the grid replicated: per-device deposits psum so every device
    trains the SAME table (padding lanes re-deposit one pixel's estimate —
    training signal, not a film estimate, so no bias). The compiled pass is
    cached per (scene, integrator, mesh), so -a passes never retrace."""
    import time as _time
    from ..utils.film import Film
    from ..utils.rng import make_stream, stream_fold
    from .common import (_BLOCK_CACHE, _cache_put, _device_scene,
                         _pixel_grid, _scene_as_arg)

    cam = scene.camera
    w, h = cam.width, cam.height
    pix = jnp.asarray(_pixel_grid(w, h))
    n = pix.shape[0]
    if grid is None:
        grid = make_guide_grid(scene, g)
    integrator.guide_alpha = alpha

    ck = (id(scene), id(integrator), w, h, alpha,
          id(mesh) if mesh is not None else 0, "guided")
    one_pass = _BLOCK_CACHE.get(ck)
    if one_pass is None:
        if mesh is None:
            @jax.jit
            def one_pass(sd, gr, stream):
                rad, dep = integrator.compute_pixel(sd, pix, stream,
                                                    guide=gr, collect=True)
                ok = jnp.all(jnp.isfinite(rad), axis=-1) & jnp.all(
                    rad >= 0.0, axis=-1)
                return jnp.where(ok[:, None], rad, 0.0), dep
        else:
            from jax.sharding import PartitionSpec as P
            from jax import shard_map
            n_dev = mesh.shape["d"]
            pad = (-n) % n_dev
            pix_pad = (jnp.concatenate([pix, jnp.tile(pix[-1:], (pad, 1))], 0)
                       if pad else pix)

            def device_fn(sd_, gr_, pix_, base_):
                dev = jax.lax.axis_index("d")
                stream = stream_fold(base_, dev)
                rad, dep = integrator.compute_pixel(sd_, pix_, stream,
                                                    guide=gr_, collect=True)
                ok = jnp.all(jnp.isfinite(rad), axis=-1) & jnp.all(
                    rad >= 0.0, axis=-1)
                return (jnp.where(ok[:, None], rad, 0.0),
                        jax.lax.psum(dep, "d"))

            sharded = shard_map(device_fn, mesh=mesh,
                                in_specs=(P(), P(), P("d", None), P()),
                                out_specs=(P("d", None), P()),
                                check_vma=False)

            @jax.jit
            def one_pass(sd, gr, stream):
                rad, dep = sharded(sd, gr, pix_pad, stream)
                return rad[:n], dep
        _cache_put(ck, one_pass)

    sd = _device_scene(scene) if _scene_as_arg(scene) else scene
    base = make_stream(seed)
    acc = jnp.zeros((w * h, 3), jnp.float32)
    t0 = _time.time()
    for j in range(spp):
        rad, dep = one_pass(sd, grid, stream_fold(base, j))
        acc = acc + rad
        grid = grid.replace(
            table=grid.table * decay + dep.reshape(grid.table.shape))
    img = np.asarray(acc).reshape(h, w, 3) / spp
    if verbose:
        tw = float(jnp.sum(grid.table))
        print(f"render_guided: {spp} passes in {_time.time()-t0:.2f}s "
              f"(grid mass {tw:.3g})")
    film = Film(w, h)
    film.buffers["primal"] = img
    if return_grid:
        return film, grid
    return film


class IntegratorGuidedPath:
    """Self-driving guided path tracer whose guide table PERSISTS across
    render() calls: under `-a`, every averaging pass continues training the
    table the previous passes built, so later passes sample better than a
    fresh-table run (the progressive-guiding idea applied across passes).
    Averaging stays unbiased: each pass's grid depends only on EARLIER
    samples, so per-pass estimates are independent conditioned on history
    and identically-weighted averaging is exact.

    state_dict/load_state_dict checkpoint the table alongside -a dumps
    (same protocol as SMCMC chains) so --resume reproduces an
    uninterrupted run bit-exactly."""

    averaging = True

    def __init__(self, integrator, g: int = 16, alpha: float = 0.5,
                 decay: float = 0.8):
        self.integrator = integrator
        self.g = g
        self.alpha = alpha
        self.decay = decay
        self._grid = None
        self._grid_scene = None   # retained: id() reuse after GC aliases

    def render(self, scene, spp: int, seed: int = 0, verbose: bool = False,
               mesh=None):
        grid = self._grid if self._grid_scene is scene else None
        film, grid = render_guided(
            scene, self.integrator, spp, seed=seed, g=self.g,
            alpha=self.alpha, decay=self.decay, verbose=verbose,
            grid=grid, return_grid=True, mesh=mesh)
        self._grid = grid
        self._grid_scene = scene
        return film

    def state_dict(self):
        if self._grid is None:
            return None
        return {"table": np.asarray(self._grid.table),
                "g": np.asarray(self.g)}

    def load_state_dict(self, d, scene):
        if int(d["g"]) != self.g:
            raise ValueError(f"guide-grid mismatch: dumped g={int(d['g'])} "
                             f"!= configured g={self.g}")
        grid = make_guide_grid(scene, self.g)
        self._grid = grid.replace(table=jnp.asarray(d["table"]))
        self._grid_scene = scene
