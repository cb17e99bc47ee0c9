"""Multi-chip rendering via jax.sharding.

The reference parallelizes with rayon threads over 16x16 image blocks and
mutex-merged films (SURVEY.md §2.10). The device-mesh equivalents here:

  P1 (image-block data parallelism)  -> shard the pixel wavefront over the
     mesh 'd' axis with shard_map; film shards concatenate (no merge needed).
  P2/P6 (splatting + reduction)      -> each device splats into a private
     full-resolution film; one psum merges them (used by light
     tracing / VPL / MCMC integrators).

Scene tables are replicated (they are small); only lane state is sharded.
Multi-host scaling needs nothing further: the film psum is the only
cross-device communication in the whole renderer.
"""
from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..integrators.common import Integrator, _pixel_grid, use_persistent
from ..scene.scene import SceneData
from ..utils.film import Film
from ..utils.rng import RngStream, make_stream, stream_fold


def make_device_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), ("d",))


# Compiled sharded steps, reused across passes: meta-integrators (`-a`/`-e`)
# call render_sharded once per pass, and a fresh jit(lambda) per pass would
# retrace — and, with the seed baked as a closure constant, RECOMPILE —
# every pass. The RNG base rides as a traced argument instead. Values pin
# their closed-over integrator and mesh, so the id()-keys stay valid while
# entries live.
_STEP_CACHE = {}
_STEP_CACHE_CAP = 64


def _step_cached(key, make):
    fn = _STEP_CACHE.get(key)
    if fn is None:
        if len(_STEP_CACHE) >= _STEP_CACHE_CAP:
            _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
        fn = make()
        _STEP_CACHE[key] = fn
    return fn


def render_step_sharded(scene: SceneData, integrator: Integrator, mesh: Mesh,
                        pix_sharded, seed: int = 0, spp_per_pass: int = 1,
                        sampler: str = "independent", spp_total: int = None,
                        start_idx: int = 0, base: RngStream = None,
                        with_sq: bool = False):
    """One sharded render step: pix_sharded [n_dev * lanes_per_dev, 2] ->
    radiance accumulated over spp_per_pass samples. jit-compatible; this is
    the `dryrun_multichip` "training step". `sampler="stratified"` keys the
    stratum permutations off (pixel id, global pass index), so the sharded
    stratified render covers strata exactly like the single-device one.
    `base` (an RngStream) overrides `seed` and may be traced — callers that
    jit this step pass it as an argument so reseeding never recompiles."""
    n_dev = mesh.shape["d"]
    width = scene.camera.width
    if base is None:
        base = make_stream(seed)

    def device_fn(scene_, pix_, base_):
        dev = jax.lax.axis_index("d")
        base = base_

        def one(s, carry):
            acc, acc2 = carry
            # fold the GLOBAL pass index: chunked host loops would otherwise
            # replay identical streams every chunk (identical samples)
            stream = stream_fold(stream_fold(base, dev), start_idx + s)
            if sampler == "stratified":
                from ..utils.rng import StratifiedStream
                pid = pix_[:, 1] * width + pix_[:, 0]
                stream = StratifiedStream(inner=stream, pixel_ids=pid,
                                          pass_idx=start_idx + s,
                                          spp=spp_total or spp_per_pass,
                                          base_key=base.key)
            li = integrator.compute_pixel(scene_, pix_, stream)
            ok = jnp.all(jnp.isfinite(li), axis=-1) & jnp.all(li >= 0.0, axis=-1)
            li = jnp.where(ok[:, None], li, 0.0)
            if with_sq:
                acc2 = acc2 + li * li
            return acc + li, acc2

        n = pix_.shape[0]
        z = jnp.zeros((n, 3), jnp.float32)
        z2 = z if with_sq else jnp.zeros((1, 3), jnp.float32)
        return jax.lax.fori_loop(0, spp_per_pass, one, (z, z2))

    out_sq = P("d", None) if with_sq else P()
    fn = shard_map(device_fn, mesh=mesh,
                   in_specs=(P(), P("d", None), P()),
                   out_specs=(P("d", None), out_sq),
                   check_vma=False)
    acc, acc2 = fn(scene, pix_sharded, base)
    return (acc, acc2) if with_sq else acc


def render_block_sharded(scene: SceneData, integrator, mesh: Mesh,
                         pix_sharded, spp: int, seed: int = 0,
                         base: RngStream = None):
    """Persistent-wavefront step sharded over the mesh: each device runs the
    full pixel-pinned respawn loop (compute_block) on its pixel shard — all
    spp in one launch, zero cross-device traffic until the film concat."""
    if base is None:
        base = make_stream(seed)

    def device_fn(scene_, pix_, base_):
        dev = jax.lax.axis_index("d")
        stream = stream_fold(stream_fold(base_, dev), 0)
        acc = integrator.compute_block(scene_, pix_, stream, spp)
        ok = jnp.all(jnp.isfinite(acc), axis=-1) & jnp.all(acc >= 0.0, axis=-1)
        return jnp.where(ok[:, None], acc, 0.0)

    fn = shard_map(device_fn, mesh=mesh,
                   in_specs=(P(), P("d", None), P()), out_specs=P("d", None),
                   check_vma=False)
    return fn(scene, pix_sharded, base)


def splat_step_sharded(scene: SceneData, integrator, mesh: Mesh,
                       n_per_dev: int, seed: int = 0, pass_idx=0,
                       base: RngStream = None):
    """One sharded splatting pass: each device traces `n_per_dev` light paths
    with its own RNG stream, scatter-adds into a PRIVATE full-resolution film,
    and a single psum over the 'd' axis merges the films — the mesh
    form of the reference's nb_threads*4 jobs + mutex merge
    (src/integrators/explicit/light.rs:224-287; P2/P6 in SURVEY.md §2.10).

    Returns the merged [h*w, 3] film (unnormalized contribution sums)."""
    cam = scene.camera
    hw = cam.width * cam.height
    if base is None:
        base = make_stream(seed)

    def device_fn(scene_, base_):
        dev = jax.lax.axis_index("d")
        stream = stream_fold(stream_fold(base_, dev), pass_idx)
        pids, vals = integrator.trace_paths(scene_, n_per_dev, stream)
        ok = jnp.all(jnp.isfinite(vals), axis=-1) & jnp.all(vals >= 0.0,
                                                            axis=-1)
        vals = jnp.where(ok[:, None], vals, 0.0)
        film = jnp.zeros((hw, 3), jnp.float32)
        film = film.at[pids].add(vals, mode="drop")
        return jax.lax.psum(film, "d")

    fn = shard_map(device_fn, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                   check_vma=False)
    return fn(scene, base)


def render_splat_sharded(scene: SceneData, integrator, n_paths: int,
                         mesh: Optional[Mesh] = None, seed: int = 0,
                         paths_per_pass: Optional[int] = None,
                         verbose: bool = False) -> Film:
    """Full sharded splatting render (light tracing / VPL light pass):
    `n_paths` total light paths split evenly over the mesh devices, psum film
    merge per pass. Normalization matches render_splat: film * w*h/total."""
    if mesh is None:
        mesh = make_device_mesh()
    n_dev = mesh.shape["d"]
    cam = scene.camera
    w, h = cam.width, cam.height
    per_pass = paths_per_pass or min(n_paths, n_dev * w * h)
    n_per_dev = max(1, -(-per_pass // n_dev))

    step = _step_cached(
        ("splat", id(integrator), id(mesh), n_per_dev, w, h),
        lambda: jax.jit(lambda sc, b, p: splat_step_sharded(
            sc, integrator, mesh, n_per_dev, pass_idx=p, base=b)))
    base = make_stream(seed)

    acc = jnp.zeros((h * w, 3), jnp.float32)
    t0 = time.time()
    done = 0
    p = 0
    while done < n_paths:
        acc = acc + step(scene, base, jnp.int32(p))
        done += n_per_dev * n_dev
        p += 1
    img = np.asarray(acc.reshape(h, w, 3)) * (w * h / done)
    if verbose:
        print(f"render_splat_sharded[{n_dev}dev]: {done} paths "
              f"in {time.time()-t0:.2f}s")

    film = Film(w, h)
    film.buffers["primal"] = img
    return film


def render_sharded(scene: SceneData, integrator: Integrator, spp: int,
                   mesh: Optional[Mesh] = None, seed: int = 0,
                   spp_per_pass: int = 8, verbose: bool = False,
                   persistent: bool = None,
                   sampler: str = "independent") -> Film:
    """Full sharded render: pixels split over the mesh, spp looped on host
    (or one persistent-wavefront launch when the integrator supports it)."""
    if mesh is None:
        mesh = make_device_mesh()
    n_dev = mesh.shape["d"]
    w, h = scene.camera.width, scene.camera.height
    pix = _pixel_grid(w, h)
    n = pix.shape[0]
    pad = (-n) % n_dev
    if pad:
        pix = np.concatenate([pix, np.tile(pix[-1:], (pad, 1))], 0)
    pix = jnp.asarray(pix)

    if persistent is None:
        persistent = use_persistent(integrator, sampler)
    t0 = time.time()
    base = make_stream(seed)
    if persistent and hasattr(integrator, "compute_block"):
        step = _step_cached(
            ("block", id(integrator), id(mesh), spp, w, h),
            lambda: jax.jit(lambda sc, px, b: render_block_sharded(
                sc, integrator, mesh, px, spp, base=b)))
        acc = step(scene, pix, base)
        done = spp
    else:
        chunk = max(1, min(spp_per_pass, spp))
        step = _step_cached(
            ("chunk", id(integrator), id(mesh), chunk, sampler, spp, w, h),
            lambda: jax.jit(lambda sc, px, b, s0: render_step_sharded(
                sc, integrator, mesh, px, spp_per_pass=chunk,
                sampler=sampler, spp_total=spp, start_idx=s0, base=b)))

        acc = jnp.zeros((pix.shape[0], 3), jnp.float32)
        done = 0
        while done < spp:
            acc = acc + step(scene, pix, base, jnp.int32(done))
            done += chunk
    acc.block_until_ready()
    # The [:n] slice below assumes device shard i holds rows
    # [i*per_dev, (i+1)*per_dev) in input order — guaranteed by the
    # P("d", None) out_spec, but assert it so a future layout change
    # (e.g. a different out_spec or auto-sharding pass) fails loudly
    # instead of silently permuting pixels (padding lanes re-render pixel
    # n-1, so a permutation would also be silently *plausible*).
    spec = getattr(getattr(acc, "sharding", None), "spec", None)
    assert spec is None or tuple(spec) in ((), ("d",), ("d", None)), (
        f"render_sharded: unexpected film shard layout {spec}")
    if verbose:
        dt = time.time() - t0
        print(f"render_sharded[{n_dev}dev]: {done} spp in {dt:.2f}s")

    img = np.asarray(acc)[:n].reshape(h, w, 3) / done
    film = Film(w, h)
    film.buffers["primal"] = img
    return film


def render_variance_sharded(scene: SceneData, integrator: Integrator,
                            spp: int, mesh: Optional[Mesh] = None,
                            seed: int = 0, spp_per_pass: int = 8,
                            sampler: str = "independent") -> Film:
    """Sharded chunked render that also tracks per-sample second moments:
    the mesh form of `render(..., variance=True)` (per-pixel mean/variance
    AOVs, reference BufferCollection mod.rs:102-135). Used as
    render_adaptive's pilot when a mesh is given."""
    if mesh is None:
        mesh = make_device_mesh()
    n_dev = mesh.shape["d"]
    w, h = scene.camera.width, scene.camera.height
    pix = _pixel_grid(w, h)
    n = pix.shape[0]
    pad = (-n) % n_dev
    if pad:
        pix = np.concatenate([pix, np.tile(pix[-1:], (pad, 1))], 0)
    pix = jnp.asarray(pix)

    chunk = max(1, min(spp_per_pass, spp))
    step = _step_cached(
        ("chunk-var", id(integrator), id(mesh), chunk, sampler, spp, w, h),
        lambda: jax.jit(lambda sc, px, b, s0: render_step_sharded(
            sc, integrator, mesh, px, spp_per_pass=chunk, sampler=sampler,
            spp_total=spp, start_idx=s0, base=b, with_sq=True)))

    base = make_stream(seed)
    acc = jnp.zeros((pix.shape[0], 3), jnp.float32)
    acc2 = jnp.zeros((pix.shape[0], 3), jnp.float32)
    done = 0
    while done < spp:
        a, a2 = step(scene, pix, base, jnp.int32(done))
        acc = acc + a
        acc2 = acc2 + a2
        done += chunk
    # same layout guard as render_sharded: the [:n] slice assumes shard i
    # holds rows [i*per_dev, (i+1)*per_dev) in input order
    spec = getattr(getattr(acc, "sharding", None), "spec", None)
    assert spec is None or tuple(spec) in ((), ("d",), ("d", None)), (
        f"render_variance_sharded: unexpected film shard layout {spec}")
    img = np.asarray(acc)[:n].reshape(h, w, 3) / done
    m2 = np.asarray(acc2)[:n].reshape(h, w, 3) - done * img * img
    film = Film(w, h)
    film.buffers["primal"] = img
    film.buffers["mean"] = img
    film.buffers["variance"] = np.maximum(m2 / max(done - 1, 1), 0.0)
    return film


def adaptive_step_sharded(scene: SceneData, integrator, mesh: Mesh,
                          n_pix: int, pix_lanes, pid_lanes, base: RngStream,
                          pass_idx):
    """One sharded adaptive extra pass: the resampled pixel list shards by
    lane, each device scatter-adds its lanes' radiance into a private
    [n_pix, 3] film, one psum merges (pad lanes carry pid == n_pix and are
    dropped by the scatter)."""

    def device_fn(scene_, px_, pid_, base_, k_):
        dev = jax.lax.axis_index("d")
        stream = stream_fold(stream_fold(base_, dev), k_)
        li = integrator.compute_pixel(scene_, px_, stream)
        ok = jnp.all(jnp.isfinite(li), axis=-1) & jnp.all(li >= 0.0, axis=-1)
        li = jnp.where(ok[:, None], li, 0.0)
        film = jnp.zeros((n_pix, 3), jnp.float32)
        film = film.at[pid_].add(li, mode="drop")
        return jax.lax.psum(film, "d")

    fn = shard_map(device_fn, mesh=mesh,
                   in_specs=(P(), P("d", None), P("d",), P(), P()),
                   out_specs=P(), check_vma=False)
    return fn(scene, pix_lanes, pid_lanes, base, pass_idx)
