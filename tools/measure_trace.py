#!/usr/bin/env python
"""Trace-tier measurements on the local GPU, behind two decisions:

  triton     the dense closest-hit trace written as a Pallas kernel on the
             Triton route (one pass over a power-of-two column tile of the
             plane rows), against XLA's dense trace (accel/dense.py): alone
             at cbox width, and end to end through render() on cbox 512^2
             128 spp, max depth 6, with the kernel in place of XLA's
             closest-hit trace;
  crossover  dense scan against BVH walk (accel/bvh.py) on sphere grids of
             194 to 22,502 triangles: per-wavefront closest-hit and any-hit
             times, and path 256^2 8 spp depth 5 renders with each tier
             forced (geometry.BVH_THRESHOLD), which set BVH_THRESHOLD.

    python tools/measure_trace.py [triton] [crossover]    # default: both

Prints the card's name and power limit, then one JSON object per line.
The renderer does not use the kernel here; it is kept to re-run the
measurement (tests/test_measure_trace.py checks it in interpret mode).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def triton_trace(rows, o, d, tnear, tfar, block=256, num_warps=8,
                 interpret=False):
    """Closest hit of rays o, d [n, 3] in (tnear, tfar) against the plane
    rows [t_pad, 3, 4] of accel/dense.py (t_pad <= 256), as one Pallas
    kernel on the Triton route. Returns (t, tri, u, v), each [n]; a miss
    has t = inf and tri = -1; exact ties go to the lower triangle id."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n, t_pad = o.shape[0], rows.shape[0]
    cols = max(16, 1 << (t_pad - 1).bit_length())
    assert cols <= 256, "one column tile holds at most 256 triangles"
    # [12, cols]: row 4j + c is coefficient c of N (j=0), U (1), V (2); the
    # zero pad columns have n = 0 and never hit
    r = jnp.zeros((12, cols), jnp.float32).at[:, :t_pad].set(
        rows.reshape(t_pad, 12).T)
    n_pad = -(-n // block) * block

    def lanes(x, fill=0.0):                  # pad lanes: tfar = 0, inert
        return jnp.pad(x, (0, n_pad - n), constant_values=fill)
    rays = ([lanes(o[:, i]) for i in range(3)]
            + [lanes(d[:, i]) for i in range(3)]
            + [lanes(tnear), lanes(tfar)])

    def kernel(ox, oy, oz, dx, dy, dz, tn, tf, r_ref,
               t_out, i_out, u_out, v_out):
        po = [ox[...][:, None], oy[...][:, None], oz[...][:, None]]
        pd = [dx[...][:, None], dy[...][:, None], dz[...][:, None]]

        def row(k):
            return r_ref[k, :][None, :]

        def dot(j, p, affine):
            acc = p[0] * row(4 * j) + p[1] * row(4 * j + 1) \
                + p[2] * row(4 * j + 2)
            return acc + row(4 * j + 3) if affine else acc
        no, nd = dot(0, po, True), dot(0, pd, False)
        live = jnp.abs(nd) > 1e-20
        t = -no / jnp.where(live, nd, 1.0)
        u = dot(1, po, True) + t * dot(1, pd, False)
        v = dot(2, po, True) + t * dot(2, pd, False)
        valid = (live & (t > tn[...][:, None]) & (t < tf[...][:, None])
                 & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
        tm = jnp.where(valid, t, jnp.inf)
        best = jnp.min(tm, axis=1)
        iota = lax.broadcasted_iota(jnp.int32, tm.shape, 1)
        idx = jnp.min(jnp.where(tm == best[:, None], iota, cols), axis=1)
        sel = iota == idx[:, None]
        t_out[...] = best
        i_out[...] = jnp.where(best < jnp.inf, idx, -1)
        u_out[...] = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        v_out[...] = jnp.sum(jnp.where(sel, v, 0.0), axis=1)

    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    outs = pl.pallas_call(
        kernel, grid=(n_pad // block,),
        in_specs=[lane_spec] * 8 + [pl.BlockSpec((12, cols),
                                                 lambda i: (0, 0))],
        out_specs=[lane_spec] * 4,
        out_shape=[f32, jax.ShapeDtypeStruct((n_pad,), jnp.int32), f32, f32],
        backend="triton", interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
    )(*rays, r)
    return tuple(x[:n] for x in outs)


def median_ms(fn, *args, reps=20):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def emit(name, obj):
    print(name, json.dumps(obj), flush=True)


def run_triton(size=512, spp=128):
    import jax
    import jax.numpy as jnp
    from functools import partial
    from chip_smoke import wavefront_rays
    from rustlight_tpu.accel import dense
    from rustlight_tpu.integrators import IntegratorPathTracing, render
    from rustlight_tpu.models import cornell_box

    sd = cornell_box(size, size).compile()
    rows = sd.geom.inter_rows
    o, d, _, _ = wavefront_rays(sd, size)
    o, d = o[:size * size], d[:size * size]  # the camera wavefront
    tnear = jnp.full(o.shape[0], 1e-4, jnp.float32)
    tfar = jnp.full(o.shape[0], jnp.inf, jnp.float32)
    xla = jax.jit(lambda o, d: dense._intersect_impl(rows, o, d, tnear, tfar,
                                                     False))
    ref = jax.device_get(xla(o, d))
    out = {"rays": int(o.shape[0]), "t_pad": int(rows.shape[0])}
    out["xla_ms"] = median_ms(xla, o, d)
    for warps in (4, 8):
        tri = jax.jit(partial(triton_trace, num_warps=warps))
        t, i, _, _ = jax.device_get(tri(rows, o, d, tnear, tfar))
        out[f"triton_w{warps}_ms"] = median_ms(tri, rows, o, d, tnear, tfar)
        out[f"triton_w{warps}_tri_equal"] = float(np.mean(i == ref.tri))
        hit = ref.hit
        out[f"triton_w{warps}_t_maxabs"] = float(
            np.abs(t[hit] - ref.t[hit]).max())
    out["xla_ms_again"] = median_ms(xla, o, d)
    emit("triton_trace", out)

    # end to end: one (scene, integrator) pair compiled with XLA's trace,
    # one with the kernel in its place (render() caches per pair)
    orig, calls = dense._intersect_impl, []

    def kernel_impl(inter_rows, o, d, tnear, tfar, any_hit):
        if any_hit:
            return orig(inter_rows, o, d, tnear, tfar, True)
        calls.append(1)
        t, i, u, v = triton_trace(inter_rows, o, d, tnear, tfar)
        return dense.RayHit(t=t, tri=i, u=u, v=v, hit=t < jnp.inf)

    pairs = {}
    for name in ("xla", "triton"):
        scene = cornell_box(size, size).compile()
        integ = IntegratorPathTracing(max_depth=6)
        if name == "triton":
            dense._intersect_impl = kernel_impl
        try:
            t0 = time.perf_counter()
            img = render(scene, integ, spp, seed=0)["primal"]
            cold = time.perf_counter() - t0
        finally:
            dense._intersect_impl = orig
        pairs[name] = (scene, integ)
        emit(f"cbox_{name}_cold", {"cold_s": cold,
                                   "mean": float(np.mean(img)),
                                   "kernel_traced": len(calls)})
    if not calls:
        raise RuntimeError("the kernel never entered the render")
    warm = {"xla": [], "triton": []}
    for name in ("xla", "triton", "triton", "xla", "xla", "triton",
                 "triton", "xla"):
        scene, integ = pairs[name]
        t0 = time.perf_counter()
        render(scene, integ, spp, seed=0)
        warm[name].append(time.perf_counter() - t0)
    emit("cbox_e2e_warm_s", warm)


# (n_tris, n_theta) of sphere_grid: 194, 482, 898, 1442, 4862, 11522 and
# 22502 triangles (2^3 spheres of 24..180 triangles, then 3^3 .. 5^3 of 180)
GRIDS = ((168, 4), (420, 6), (784, 8), (1260, 10), (3000, 10), (10000, 10),
         (20000, 10))


def run_crossover(grids=GRIDS, width=256, reps=3):
    import jax
    from chip_smoke import wavefront_rays
    from rustlight_tpu.accel import intersect_rays, occluded_rays
    from rustlight_tpu.integrators import IntegratorPathTracing, render
    from rustlight_tpu.models import sphere_grid
    from rustlight_tpu.scene import geometry

    orig = geometry.BVH_THRESHOLD
    for n, n_theta in grids:
        scenes = {}
        for tier, thr in (("dense", 1 << 62), ("bvh", 0)):
            geometry.BVH_THRESHOLD = thr
            try:
                scenes[tier] = sphere_grid(n, width, width,
                                           n_theta).compile()
            finally:
                geometry.BVH_THRESHOLD = orig
        o, d, tnear, tfar = wavefront_rays(scenes["dense"], width)
        half = width * width
        out = {"n_tris": int(scenes["dense"].geom.n_tris)}
        integ = {k: IntegratorPathTracing(max_depth=5) for k in scenes}
        for tier, sd in scenes.items():
            g = sd.geom
            closest = jax.jit(lambda o, d, g=g: intersect_rays(g, o, d))
            anyhit = jax.jit(lambda o, d, g=g: occluded_rays(g, o, d, tnear,
                                                              tfar))
            out[f"{tier}_camera_ms"] = median_ms(closest, o[:half], d[:half])
            out[f"{tier}_bounce_ms"] = median_ms(closest, o[half:], d[half:])
            out[f"{tier}_anyhit_ms"] = median_ms(anyhit, o, d)
            t0 = time.perf_counter()
            render(sd, integ[tier], 8, seed=0)
            out[f"{tier}_path_cold_s"] = time.perf_counter() - t0
        for tier in ("dense", "bvh") * reps:
            t0 = time.perf_counter()
            render(scenes[tier], integ[tier], 8, seed=0)
            out.setdefault(f"{tier}_path_warm_s", []).append(
                time.perf_counter() - t0)
        emit("crossover", out)


def main(argv):
    what = argv or ["triton", "crossover"]
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    for name in what:
        {"triton": run_triton, "crossover": run_crossover}[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
