"""Throughput benchmark of the path tracer on the local GPU.

Prints ONE JSON line: Mrays/s (primary + bounce + shadow rays over wall
clock) of renders through `render()` (or `render_sharded()` with
`--devices N`), which on an accelerator take the persistent-wavefront loop.
Rows:
  1. cbox 512^2 128 spp max depth 6 (the headline; dense intersector), with
     the correctness gate: l1 of 8x8 block means against the committed CPU
     reference (regress/bench_ref.npz) within 4x its seed-to-seed floor;
  2. 122k- and 516k-triangle sphere grids, path 256^2 8 spp depth 5 (the
     BVH tier) — detail.grid122k / detail.grid516k;
  3. the 4.9M-triangle grid under AO, 256^2 4 spp — detail.grid4p9M.

Ray counts come from an instrumented pass (not lanes * bounces). The bench
needs a GPU: without one it prints an error row and exits 1.

    python bench.py [--devices N]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

METRIC = "cbox_path_128spp_throughput"
UNIT = "Mrays/s/chip"
REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "regress", "bench_ref.npz")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="devices to shard each render over (default 1)")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != "gpu":
        print(json.dumps({"metric": METRIC, "ok": False, "device": device,
                          "error": "no GPU: the bench measures only on "
                                   "a GPU"}))
        sys.exit(1)
    mesh = None
    if args.devices > 1:
        from rustlight_tpu.parallel import make_device_mesh
        mesh = make_device_mesh(args.devices)

    from rustlight_tpu.models import cornell_box, sphere_grid
    head, img = _bench_path(cornell_box(512, 512).compile(), 128, 6, mesh)
    check = _correctness_gate(img)
    grid = _bench_path(sphere_grid(122_000, 256, 256).compile(), 8, 5,
                       mesh)[0]
    big = _bench_path(sphere_grid(516_000, 256, 256).compile(), 8, 5,
                      mesh)[0]
    huge = _bench_ao_4p9m(mesh)
    detail = dict(head, grid122k=grid, grid516k=big, grid4p9M=huge,
                  correctness=check, n_devices=args.devices,
                  xla_flags=os.environ.get("XLA_FLAGS", ""))
    value = detail.pop("value")
    print(json.dumps({"metric": METRIC, "value": value, "unit": UNIT,
                      "device": device, "detail": detail,
                      "ok": check["ok"]}))
    if not check["ok"]:
        sys.exit(1)


def _block_mean(img: np.ndarray, b: int) -> np.ndarray:
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))


def _correctness_gate(img: np.ndarray, ref_path: str = REF_PATH) -> dict:
    """l1 of the 8x8 block means of the cbox render against the committed
    CPU reference (tools/make_bench_ref.py), gated at 4x the reference's
    seed-to-seed floor. Block means average out per-pixel MC noise and
    rounding differences between backends (statistically identical renders
    pass); a biased estimator, broken emitter or wrong scene lands far
    above the floor. A missing reference fails the gate."""
    if not os.path.exists(ref_path):
        return {"ok": False, "error": f"{ref_path} missing"}
    ref = np.load(ref_path)
    bm = _block_mean(img.astype(np.float64), int(ref["block"]))
    l1 = float(np.abs(bm - ref["blockmean"]).mean())
    floor = float(ref["floor_l1"])
    return {"ok": bool(l1 <= 4.0 * floor), "l1_vs_ref": l1,
            "floor_l1": floor, "margin": 4.0}


def _render(sd, integ, spp, seed, mesh):
    from rustlight_tpu.integrators import render
    from rustlight_tpu.parallel import render_sharded
    if mesh is None:
        return render(sd, integ, spp=spp, seed=seed)["primal"]
    return render_sharded(sd, integ, spp, mesh=mesh, seed=seed)["primal"]


def _timed(sd, integ, spp, mesh):
    """(compile-inclusive first render s, warm render s, warm image)."""
    t0 = time.perf_counter()
    _render(sd, integ, spp, 0, mesh)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = _render(sd, integ, spp, 0, mesh)   # returns host numpy: synced
    return cold, time.perf_counter() - t0, img


def _bench_ao_4p9m(mesh):
    """4.9M-tri sphere grid, AO 256^2 4 spp. Rays are exact: every sample
    traces one primary + one occlusion wavefront."""
    from rustlight_tpu.models import sphere_grid_ao
    from rustlight_tpu.integrators import IntegratorAO

    sd = sphere_grid_ao().compile()
    cold, dt, img = _timed(sd, IntegratorAO(max_distance=2.0), 4, mesh)
    rays = 2 * 256 * 256 * 4
    n_dev = 1 if mesh is None else mesh.shape["d"]
    return {"metric": "grid4p9M_ao_4spp_throughput",
            "value": rays / dt / 1e6 / n_dev, "unit": UNIT,
            "resolution": "256x256", "spp": 4,
            "n_tris": int(sd.geom.n_tris), "wall_s": dt, "cold_s": cold,
            "rays_per_render": rays, "mean_ao": float(np.mean(img))}


def _bench_path(scene, spp, max_depth, mesh):
    import jax
    import jax.numpy as jnp
    from rustlight_tpu.integrators import IntegratorPathTracing
    from rustlight_tpu.integrators.common import _pixel_grid
    from rustlight_tpu.utils.rng import make_stream, stream_fold

    width, height = scene.camera.width, scene.camera.height
    integ = IntegratorPathTracing(max_depth=max_depth)
    cold, dt, img = _timed(scene, integ, spp, mesh)

    # Count rays on a measurement pass: per pass, bounce b traces alive_b
    # rays plus the NEE shadow rays that are actually traced (the
    # throughput metric must not count rays the estimator does not trace).
    from rustlight_tpu.accel import intersect_rays
    from rustlight_tpu.scene import generate_rays, fill_hit, sample_light
    from rustlight_tpu.bsdfs import bsdf_sample
    from rustlight_tpu.utils.rng import stream_next, stream_next2d

    pix = jnp.asarray(_pixel_grid(width, height))
    n = pix.shape[0]

    @jax.jit
    def alive_per_bounce(scene_, pix_):
        stream = stream_fold(make_stream(0), 0)
        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene_.camera, pix_.astype(jnp.float32) + u_pix)
        from rustlight_tpu.scene.scene import offset_ray_origin
        from rustlight_tpu.utils.frame import to_world
        from rustlight_tpu.utils.vec import channel_max

        def body(carry, k):
            o, d, alive, thr, stream, rays = carry
            rh = intersect_rays(scene_.geom, o, d)
            hit = fill_hit(scene_, o, d, rh)
            lane = alive & hit.valid
            u_sel, stream = stream_next(stream, (n,))
            u_pos, stream = stream_next2d(stream, (n,))
            ls = sample_light(scene_.emitters, scene_.geom, hit.p, u_sel,
                              u_pos)
            # the real loop's pre_ok gates on can_expand: no NEE at the
            # final bounce (those lanes shoot inert tfar=0 rays)
            pre = lane & ls.valid & (k + 1 < max_depth)
            rays = rays + jnp.sum(alive) + jnp.sum(pre)  # trace + shadow
            u_b, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(scene_.materials, hit.mat, hit.uv, hit.wi, u_b)
            thr = thr * bs.weight
            u_rr, stream = stream_next(stream, (n,))
            rr_p = jnp.minimum(channel_max(thr), 0.95)
            keep = u_rr < rr_p
            alive = lane & bs.valid & keep
            thr = thr / jnp.maximum(rr_p, 1e-8)[:, None]
            d2 = to_world(hit.frame, bs.wo)
            o2 = offset_ray_origin(hit.p, hit.n_g, d2)
            return (o2, d2, alive, thr, stream, rays), None

        init = (o, d, jnp.ones(n, bool), jnp.ones((n, 3)), stream,
                jnp.zeros((), jnp.float32))
        (o, d, alive, thr, stream, rays), _ = jax.lax.scan(
            body, init, jnp.arange(max_depth))
        return rays

    rays_per_pass = float(alive_per_bounce(scene, pix))
    n_dev = 1 if mesh is None else mesh.shape["d"]
    mrays_aggregate = rays_per_pass * spp / dt / 1e6
    row = {"value": mrays_aggregate / n_dev, "unit": UNIT,
           "resolution": f"{width}x{height}", "spp": spp,
           "n_tris": int(scene.geom.n_tris), "wall_s": dt, "cold_s": cold,
           "rays_per_pass": int(rays_per_pass),
           "aggregate_mrays_s": mrays_aggregate,
           "mean_radiance": float(np.mean(img))}
    return row, np.asarray(img, np.float64)


if __name__ == "__main__":
    main()
