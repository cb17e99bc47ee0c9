"""rustlight_tpu — a wavefront physically-based light-transport renderer in JAX.

A from-scratch rebuild of the capabilities of the `rustlight` research renderer
(beltegeuse/rustlight) for accelerators: wavefront (bounce-synchronous) Monte
Carlo integrators over SoA path-state arrays, matrix-form ray/triangle
intersection, branch-free masked BSDF/emitter kernels, counter-based RNG, and
`jax.sharding`-based multi-chip scaling.

Layout (mirrors the reference's layer map, SURVEY.md §1):
  utils/       math primitives: frames, warps, distributions, solvers, images
  ops/         table gathers shared by the hot paths
  scene/       scene model: meshes, camera, emitters, volumes, loaders
  bsdfs/       material archetypes as masked kernels dispatched by material id
  accel/       acceleration structures: dense intersector, flattened BVH
  samplers/    RNG streams: independent, stratified, primary-sample-space (MCMC)
  integrators/ ao/direct/path/light/vpl/... wavefront integrators + MCMC + gradient
  parallel/    device-mesh sharding of the render loop, film reductions
  models/      ready-made scenes (Cornell box & friends) and render presets
"""

__version__ = "0.1.0"


def enable_compile_cache():
    """Point JAX's persistent compilation cache at one fixed place.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is changed here. Otherwise the cache goes to `.jax_cache/` in the
    checkout that holds this package. The path is part of the cache key, so
    it must not move between runs. RUSTLIGHT_TPU_NO_COMPILE_CACHE=1 turns
    the default off (the tests use it). Returns the directory chosen by
    this call, or None."""
    import os
    if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.environ.get("RUSTLIGHT_TPU_NO_COMPILE_CACHE") == "1"):
        return None
    import jax
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


enable_compile_cache()

EPSILON = 1e-4  # ray epsilon, mirrors reference src/lib.rs:50-53
ONE_MINUS_EPSILON = 1.0 - 1e-7
