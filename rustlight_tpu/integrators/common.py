"""Integrator framework: MC render driver over the wavefront.

The reference's `compute_mc` (src/integrators/mod.rs:403-450) tiles the image
into 16x16 blocks with per-block RNG clones under rayon. The wavefront version has
no blocks: one jitted pass evaluates *every pixel of a batch* for one sample
index, the spp loop runs on host (keeping each device launch bounded), and the
film accumulates on device. Sharding across chips happens in
parallel/render.py by slicing the pixel batch over a mesh axis.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.scene import SceneData
from ..utils.film import Film
from ..utils.rng import RngStream, make_stream, stream_fold


def mis_power(pdf_a, pdf_b):
    """Power heuristic beta=2 with zero/NaN guards (reference mis_weight,
    src/integrators/mod.rs:462-478)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    w = a2 / jnp.maximum(a2 + b2, 1e-30)
    w = jnp.where(jnp.isfinite(pdf_a) & jnp.isfinite(pdf_b), w, 0.0)
    return jnp.where(pdf_a > 0.0, w, 0.0)


def mis_balance(pdf_a, pdf_b):
    """Balance heuristic (the path tracer's per-strategy MIS,
    src/integrators/explicit/path.rs:77-106)."""
    w = pdf_a / jnp.maximum(pdf_a + pdf_b, 1e-30)
    w = jnp.where(jnp.isfinite(pdf_a) & jnp.isfinite(pdf_b), w, 0.0)
    return jnp.where(pdf_a > 0.0, w, 0.0)


class Integrator:
    """Base: an integrator is `Lo(scene, pix, stream) -> [n, 3]` radiance."""

    #: extra AOV names beyond "primal"
    aovs = ()

    def compute_pixel(self, scene: SceneData, pix, stream: RngStream):
        raise NotImplementedError

    # hook for meta-integrators (avg): does averaging make sense?
    averaging = True


class SplattingIntegrator:
    """Base for image-space splatting integrators (light tracing, MCMC):
    `trace_paths(scene, n, stream) -> (pixel_ids, values)` — contributions
    scatter-add into the film (P2 in SURVEY.md §2.10)."""

    averaging = True

    def trace_paths(self, scene: SceneData, n: int, stream: RngStream):
        raise NotImplementedError


def _pixel_grid(width, height):
    ys, xs = np.mgrid[0:height, 0:width]
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int32)


_BLOCK_CACHE = {}   # (id(scene), id(integ), spp, w, h) -> compiled block fn
_BLOCK_CACHE_CAP = 64   # each entry pins its closed-over scene; bound it


def _cache_put(key, fn):
    if len(_BLOCK_CACHE) >= _BLOCK_CACHE_CAP:
        _BLOCK_CACHE.pop(next(iter(_BLOCK_CACHE)))   # FIFO eviction
    _BLOCK_CACHE[key] = fn


# --- scene-as-argument mode for huge scenes -------------------------------
# Closing over the scene bakes its tables into the HLO as constants, which
# lets XLA constant-fold scene-dependent layout work. But the serialized
# constants grow with the scene — a 4.9M-tri scene is gigabytes of tables,
# which no compiler front-end should see. Above the threshold the tables
# enter as jit ARGUMENTS instead: device-resident once (cached
# device_put), parameters in the HLO. Renders are bit-identical either way
# (tests/test_integrators.py). Neither the threshold nor the choice has
# been measured on the H100 yet.
_ARG_SCENE_MB = 384.0
_DEVICE_SCENE_CACHE = {}   # id(scene) -> device-resident pytree


def _scene_nbytes(scene) -> int:
    return sum(l.nbytes for l in jax.tree_util.tree_leaves(scene)
               if hasattr(l, "nbytes"))


def _scene_as_arg(scene) -> bool:
    return _scene_nbytes(scene) > _ARG_SCENE_MB * 2 ** 20


def _device_scene(scene):
    """One-time transfer of the scene tables to the default device; numpy
    leaves passed per call would re-stage the whole scene every dispatch."""
    ent = _DEVICE_SCENE_CACHE.get(id(scene))
    # the entry retains the HOST scene alongside the device copy: an
    # id()-keyed cache whose key object can be garbage-collected would let a
    # NEW scene reuse the address and silently render the stale tables
    if ent is not None and ent[0] is scene:
        return ent[1]
    if len(_DEVICE_SCENE_CACHE) >= _BLOCK_CACHE_CAP:
        _DEVICE_SCENE_CACHE.pop(next(iter(_DEVICE_SCENE_CACHE)))
    ds = jax.device_put(scene)
    _DEVICE_SCENE_CACHE[id(scene)] = (scene, ds)
    return ds


def use_persistent(integrator, sampler: str = "independent",
                   variance: bool = False) -> bool:
    """The one rule that picks the loop form of a render.

    The persistent wavefront (all spp in one while_loop with pixel-pinned
    lane respawn; `compute_block`) runs on any accelerator. The
    pass-chunked loop runs on the CPU, where compiling a while_loop per spp
    count costs the test matrix more than it saves, and wherever its
    per-pass RNG layout (the stratified sampler) or per-sample second
    moments (variance AOVs) are needed."""
    return (hasattr(integrator, "compute_block")
            and sampler == "independent" and not variance
            and jax.default_backend() != "cpu")


def render(scene: SceneData, integrator: Integrator, spp: int, seed: int = 0,
           spp_per_pass: int = 8, verbose: bool = False,
           sampler: str = "independent", persistent: bool = None,
           variance: bool = False) -> Film:
    """Monte Carlo render: returns the averaged film.

    Integrators exposing `compute_block` (the path tracer) render ALL spp in
    one persistent-wavefront while_loop with pixel-pinned lane respawn, so
    Russian-roulette holes refill immediately. Others run the spp loop
    `fori`-batched in chunks of `spp_per_pass`. `persistent=None` leaves
    the choice to `use_persistent`; `persistent=False` forces the chunked
    path.

    `variance=True` additionally emits per-pixel `mean` and `variance` AOVs
    (variance of the per-sample estimates — reference BufferCollection
    mean/variance buffers, src/integrators/mod.rs:102-135); forces the
    chunked path, which tracks per-sample second moments."""
    cam = scene.camera
    w, h = cam.width, cam.height
    pix = jnp.asarray(_pixel_grid(w, h))
    chunk = max(1, min(spp_per_pass, spp))
    if hasattr(integrator, "prepare"):
        integrator.prepare(scene)
    if variance:
        persistent = False

    if persistent is None:
        persistent = use_persistent(integrator, sampler, variance)
    scene_arg = _scene_as_arg(scene)
    if persistent and hasattr(integrator, "compute_block"):
        # CLOSE OVER the scene: scene tables as compile-time constants let
        # XLA constant-fold scene-dependent layout work. The executable is
        # cached per
        # (scene, integrator, spp) so repeated passes (avg mode) reuse it;
        # only the RNG stream enters as an argument. Huge scenes flip to
        # scene-as-argument (see _scene_as_arg).
        ck = (id(scene), id(integrator), spp, w, h)
        run_block = _BLOCK_CACHE.get(ck)
        if run_block is None:
            if scene_arg:
                @jax.jit
                def _run_arg(sd, stream):
                    acc = integrator.compute_block(sd, pix, stream, spp)
                    ok = jnp.all(jnp.isfinite(acc), axis=-1) & jnp.all(
                        acc >= 0.0, axis=-1)
                    return jnp.where(ok[:, None], acc, 0.0)

                def run_block(stream):
                    return _run_arg(_device_scene(scene), stream)
            else:
                @jax.jit
                def run_block(stream):
                    acc = integrator.compute_block(scene, pix, stream, spp)
                    ok = jnp.all(jnp.isfinite(acc), axis=-1) & jnp.all(
                        acc >= 0.0, axis=-1)
                    return jnp.where(ok[:, None], acc, 0.0)
            _cache_put(ck, run_block)

        t0 = time.time()
        img = np.asarray(
            run_block(stream_fold(make_stream(seed), 0)).reshape(h, w, 3)
            / spp)
        if verbose:
            dt = time.time() - t0
            print(f"render(persistent): {spp} spp in {dt:.2f}s")
        film = Film(w, h)
        film.buffers["primal"] = img
        return film

    # scene + pixel grid closed over (constants; see the persistent path) —
    # only the RNG base and start index are arguments, so one executable
    # serves every pass/seed
    ck = (id(scene), id(integrator), chunk, sampler, spp, w, h, variance,
          "chunk")
    run_chunk = _BLOCK_CACHE.get(ck)
    if run_chunk is None:
        def _chunk_impl(sd, base, start_idx):
            def one(s, carry):
                acc, acc2 = carry
                stream = stream_fold(base, start_idx + s)
                if sampler == "stratified":
                    from ..utils.rng import StratifiedStream
                    pid = pix[:, 1] * w + pix[:, 0]
                    stream = StratifiedStream(inner=stream, pixel_ids=pid,
                                              pass_idx=start_idx + s, spp=spp,
                                              base_key=base.key)
                li = integrator.compute_pixel(sd, pix, stream)
                # guard invalid splats (accumulate_safe, mod.rs:160-175)
                ok = jnp.all(jnp.isfinite(li), axis=-1) \
                    & jnp.all(li >= 0.0, axis=-1)
                li = jnp.where(ok[:, None], li, 0.0)
                if variance:
                    acc2 = acc2 + li * li
                return acc + li, acc2
            z = jnp.zeros((h * w, 3), jnp.float32)
            z2 = z if variance else jnp.zeros((1, 3), jnp.float32)
            return jax.lax.fori_loop(0, chunk, one, (z, z2))

        if scene_arg:
            _jit_chunk = jax.jit(_chunk_impl)

            def run_chunk(base, start_idx):
                return _jit_chunk(_device_scene(scene), base, start_idx)
        else:
            @jax.jit
            def run_chunk(base, start_idx):
                return _chunk_impl(scene, base, start_idx)
        _cache_put(ck, run_chunk)

    base_stream = make_stream(seed)
    acc = jnp.zeros((h * w, 3), jnp.float32)
    acc2 = jnp.zeros((h * w, 3) if variance else (1, 3), jnp.float32)
    t0 = time.time()
    done = 0
    while done < spp:
        a, a2 = run_chunk(base_stream, jnp.int32(done))
        acc = acc + a
        acc2 = acc2 + a2
        done += chunk
    spp_actual = done
    img = np.asarray(acc.reshape(h, w, 3) / spp_actual)
    if verbose:
        dt = time.time() - t0
        print(f"render: {spp_actual} spp in {dt:.2f}s "
              f"({w*h*spp_actual/max(dt,1e-9)/1e6:.2f} Msamples/s)")

    film = Film(w, h)
    film.buffers["primal"] = img
    if variance:
        # unbiased per-sample variance (Welford closed form over sums);
        # mean AOV mirrors primal (reference mod.rs:102-135)
        m2 = np.asarray(acc2.reshape(h, w, 3)) - spp_actual * img * img
        film.buffers["mean"] = img
        film.buffers["variance"] = np.maximum(
            m2 / max(spp_actual - 1, 1), 0.0)
    return film


def render_splat(scene: SceneData, integrator: SplattingIntegrator, spp: int,
                 seed: int = 0, paths_per_pass: Optional[int] = None,
                 verbose: bool = False) -> Film:
    """Render with a splatting integrator.

    Total light paths = spp * w * h (reference light.rs:230-233); the film is
    scatter-added on device and finally scaled by w*h/total_paths."""
    cam = scene.camera
    w, h = cam.width, cam.height
    total = spp * w * h
    n = paths_per_pass or min(total, w * h)

    ck = (id(scene), id(integrator), n, w, h, "splat")
    one_pass = _BLOCK_CACHE.get(ck)
    if one_pass is None:
        def _pass_impl(sd, base, pass_idx):
            stream = stream_fold(base, pass_idx)
            pids, vals = integrator.trace_paths(sd, n, stream)
            ok = jnp.all(jnp.isfinite(vals), axis=-1) & jnp.all(vals >= 0.0,
                                                                axis=-1)
            vals = jnp.where(ok[:, None], vals, 0.0)
            film = jnp.zeros((h * w, 3), jnp.float32)
            return film.at[pids].add(vals, mode="drop")

        if _scene_as_arg(scene):
            _jit_pass = jax.jit(_pass_impl)

            def one_pass(base, pass_idx):
                return _jit_pass(_device_scene(scene), base, pass_idx)
        else:
            @jax.jit
            def one_pass(base, pass_idx):
                return _pass_impl(scene, base, pass_idx)
        _cache_put(ck, one_pass)

    base_stream = make_stream(seed)
    acc = jnp.zeros((h * w, 3), jnp.float32)
    t0 = time.time()
    done = 0
    p = 0
    while done < total:
        acc = acc + one_pass(base_stream, jnp.int32(p))
        done += n
        p += 1
    img = np.asarray(acc.reshape(h, w, 3)) * (w * h / done)
    if verbose:
        print(f"render_splat: {done} paths in {time.time()-t0:.2f}s")

    film = Film(w, h)
    film.buffers["primal"] = img
    return film


def render_adaptive(scene: SceneData, integrator: Integrator, spp: int,
                    seed: int = 0, pilot_frac: float = 0.25,
                    verbose: bool = False, mesh=None) -> Film:
    """Variance-adaptive render (beyond the reference, which samples every
    pixel uniformly): a pilot pass measures per-pixel noise, then the
    remaining sample budget is allocated across pixels proportionally to
    their standard deviation — the wavefront makes this natural, since
    lanes are pixel-indexed and a resampled pixel list costs nothing.

    Unbiased: each pixel's estimate is the mean of its OWN iid samples; the
    per-pixel counts depend only on the pilot samples, not the extra ones.
    The total sample budget equals `spp * w * h` like render(spp).
    `mesh` shards both phases over the device mesh (pilot via
    render_variance_sharded; extra passes scatter into per-device films
    merged by one psum). The allocation itself stays on host."""
    cam = scene.camera
    w, h = cam.width, cam.height
    n_pix = w * h
    # pilot floor of 8: below that the variance estimates misallocate
    # against fireflies (measured 0.5x rmse at pilot=4 vs 2x at pilot=8)
    pilot = max(8, min(int(round(spp * pilot_frac)), spp))
    # spp_per_pass=pilot: one exact-size chunk — the default chunked loop
    # rounds UP to the chunk size, which would silently render extra pilot
    # samples (budget overshoot) while the merge weights them as `pilot`
    if mesh is not None:
        from ..parallel import render_variance_sharded
        film = render_variance_sharded(scene, integrator, pilot, mesh=mesh,
                                       seed=seed, spp_per_pass=pilot)
    else:
        film = render(scene, integrator, pilot, seed=seed, variance=True,
                      persistent=False, spp_per_pass=pilot)
    extra_budget = (spp - pilot) * n_pix
    if extra_budget <= 0:
        return film

    var = film.buffers["variance"].mean(-1).reshape(-1)     # [n_pix]
    sigma = np.sqrt(np.maximum(var, 0.0)) + 1e-12           # optimal ~ sigma
    # defensive blend: a small pilot's variance estimates are themselves
    # noisy — a pixel whose few pilot samples happened to agree would be
    # starved even when its true variance is high (measured: pure-sigma
    # allocation DOUBLES rmse at pilot=4). 30% of the budget stays uniform.
    share = 0.7 * sigma / sigma.sum() + 0.3 / n_pix
    alloc = share * extra_budget
    counts = np.floor(alloc).astype(np.int64)
    rem = int(extra_budget - counts.sum())
    if rem > 0:  # largest-remainder rounding keeps the budget exact
        frac = alloc - counts
        counts[np.argpartition(-frac, rem - 1)[:rem]] += 1

    pix = _pixel_grid(w, h)
    pix_list = np.repeat(pix, counts, axis=0)               # [extra_budget, 2]
    pids = (pix_list[:, 1].astype(np.int64) * w + pix_list[:, 0]).astype(
        np.int32)
    # chunk the extra wavefront at the base resolution's width (rounded up
    # to a device multiple when sharded)
    lanes = n_pix if mesh is None else n_pix + ((-n_pix) % mesh.shape["d"])
    n_total = pix_list.shape[0]
    pad = (-n_total) % lanes
    if pad:
        # padding lanes resample pixel 0 but are EXCLUDED from the counts
        pix_list = np.concatenate([pix_list, np.tile(pix_list[:1], (pad, 1))])
        # pad ids point PAST the film (mode="drop" discards them; -1 would
        # wrap to the last pixel under numpy index semantics)
        pids = np.concatenate([pids, np.full(pad, n_pix, np.int32)])
    n_passes = pix_list.shape[0] // lanes
    pix_d = jnp.asarray(pix_list.reshape(n_passes, lanes, 2))
    pid_d = jnp.asarray(pids.reshape(n_passes, lanes))
    base = make_stream(seed + 7919)

    if mesh is None:
        @jax.jit
        def extra_pass(sd, px, pid, k):
            li = integrator.compute_pixel(sd, px, stream_fold(base, k))
            ok = jnp.all(jnp.isfinite(li), axis=-1) & jnp.all(li >= 0.0,
                                                              axis=-1)
            li = jnp.where(ok[:, None], li, 0.0)
            acc = jnp.zeros((n_pix, 3), jnp.float32)
            return acc.at[pid].add(li, mode="drop")
    else:
        from ..parallel import adaptive_step_sharded
        from ..parallel.render import _step_cached
        step = _step_cached(
            ("adaptive", id(integrator), id(mesh), n_pix, lanes),
            lambda: jax.jit(lambda sc, px, pid, b, k: adaptive_step_sharded(
                sc, integrator, mesh, n_pix, px, pid, b, k)))

        def extra_pass(sd, px, pid, k):
            return step(sd, px, pid, base, k)

    sd = _device_scene(scene) if _scene_as_arg(scene) else scene
    extra_sum = jnp.zeros((n_pix, 3), jnp.float32)
    t0 = time.time()
    for k in range(n_passes):
        extra_sum = extra_sum + extra_pass(sd, pix_d[k], pid_d[k],
                                           jnp.int32(k))
    extra_sum = np.asarray(extra_sum).reshape(h, w, 3)
    if verbose:
        print(f"render_adaptive: pilot {pilot} spp + {n_total} adaptive "
              f"samples in {time.time()-t0:.2f}s (max/pixel "
              f"{pilot + counts.max()})")

    total = pilot + counts.reshape(h, w)
    img = (film.buffers["primal"] * pilot + extra_sum) / total[..., None]
    out = Film(w, h)
    out.buffers["primal"] = img.astype(np.float32)
    out.buffers["spp"] = total[..., None].astype(np.float32)
    return out


def render_feature_aovs(scene: SceneData, spp: int = 8, seed: int = 0) -> dict:
    """First-hit feature AOVs for external denoisers: `albedo`, `normal`,
    `depth`, each [h, w, 3], averaged over `spp` jittered camera samples
    (anti-aliased like the beauty pass).

    Beyond the reference: its BufferCollection carries only radiance-derived
    buffers (src/integrators/mod.rs:48-216); joint-filtering denoisers
    (OIDN-style) want noise-free guide channels. Conventions:
      albedo — textured diffuse reflectance at the first hit; delta/smooth
               materials and emitters report 1 (their detail rides in the
               radiance, not the albedo); misses report 0.
      normal — world-space shading normal, averaged without renormalizing
               (edge pixels blend, as denoisers expect).
      depth  — first-hit distance replicated to 3 channels; 0 for misses.
    """
    from ..accel import intersect_rays
    from ..scene import generate_rays, fill_hit
    from ..bsdfs import bsdf_is_smooth
    from ..bsdfs.kernels import _gather, diffuse_color
    from ..utils.rng import stream_next2d

    cam = scene.camera
    w, h = cam.width, cam.height
    pix = jnp.asarray(_pixel_grid(w, h))
    n = pix.shape[0]

    def _impl(sd, base):
        def one(s, acc):
            alb_a, nrm_a, dep_a = acc
            stream = stream_fold(base, s)
            u_pix, stream = stream_next2d(stream, (n,))
            o, d = generate_rays(sd.camera, pix.astype(jnp.float32) + u_pix)
            rh = intersect_rays(sd.geom, o, d)
            hit = fill_hit(sd, o, d, rh)
            v = hit.valid
            p = _gather(sd.materials, hit.mat)
            alb = diffuse_color(p, hit.uv)
            one_alb = bsdf_is_smooth(sd.materials, hit.mat) | hit.is_light
            alb = jnp.where(one_alb[:, None], 1.0, alb)
            alb = jnp.where(v[:, None], alb, 0.0)
            nrm = jnp.where(v[:, None], hit.n_s, 0.0)
            dep = jnp.where(v, hit.t, 0.0)
            return (alb_a + alb, nrm_a + nrm, dep_a + dep)

        z3 = jnp.zeros((n, 3), jnp.float32)
        return jax.lax.fori_loop(0, spp, one, (z3, z3, jnp.zeros(n)))

    if _scene_as_arg(scene):
        alb, nrm, dep = jax.jit(_impl)(_device_scene(scene), make_stream(seed))
    else:
        alb, nrm, dep = jax.jit(partial(_impl, scene))(make_stream(seed))
    alb = np.asarray(alb).reshape(h, w, 3) / spp
    nrm = np.asarray(nrm).reshape(h, w, 3) / spp
    dep = np.repeat(np.asarray(dep).reshape(h, w, 1) / spp, 3, axis=-1)
    return {"albedo": alb.astype(np.float32),
            "normal": nrm.astype(np.float32),
            "depth": dep.astype(np.float32)}
