#!/usr/bin/env python
"""Smoke test of the renderer's main path on a GPU.

    python chip_smoke.py          # one card, phases 1-6
    python chip_smoke.py --four   # four cards: the sharded phase only

One card:
  1. the card: JAX's device, and its name and power limit from nvidia-smi;
  2. cbox 512^2, path max depth 6, 128 spp through the CLI (in-process) and
     through render(): wall time cold and warm, compile time apart, and the
     gate against regress/bench_ref.npz, the CPU reference — l1 of the 8x8
     block means within 4x the reference's seed-to-seed floor;
  3. intersector parity on the 122k-triangle sphere grid: the BVH walk
     against the dense scan on 65,536 camera and 65,536 bounce rays — the
     same hits, the same triangles except exact ties, identical any-hit,
     and t to relative 1e-5; lanes over 1e-5 are counted, and each tier's
     t there is held to the float64 t of the same plane within the f32
     evaluation's error bound;
  4. the 122k grid, path max depth 5, 8 spp, 256^2 through render();
  5. the 4.9M-triangle grid under AO, 256^2 4 spp through render();
  6. `pytest -m gpu` on the tests marked for the card. It runs first, in a
     child process that has ended before this process opens the card.
Four cards: the cbox render sharded over 4 cards against the one-card
render, and sharded light tracing (psum film merge) against one card.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a GPU or outside the repo, and
exits 1 if any phase fails.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")
GATE_MARGIN = 4.0     # the cbox gate's margin over the seed-to-seed floor


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (cache hits
    included), read from JAX's monitoring events."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.total += duration


def timed(clock, fn):
    """(result, wall s, compile s) of fn(); fn must return host data."""
    c0, t0 = clock.total, time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, clock.total - c0


def block_l1(a, b):
    """l1 between the 8x8 block means of two images."""
    from bench import _block_mean
    return float(np.abs(_block_mean(np.asarray(a, np.float64), 8)
                        - _block_mean(np.asarray(b, np.float64), 8)).mean())


def phase_cbox(clock, size=512, spp=128, depth=6, ref=None):
    """cbox path through the CLI, then through render() (cold and warm);
    both images are held to the CPU reference `ref` (bench.py's gate,
    regress/bench_ref.npz by default)."""
    from bench import REF_PATH, _correctness_gate
    from rustlight_tpu.cli import main as cli_main
    from rustlight_tpu.integrators import IntegratorPathTracing, render
    from rustlight_tpu.integrators.common import use_persistent
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.utils.image import read_pfm

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pfm = os.path.join(tmp, "cbox.pfm")
        argv = ["cbox", "-n", str(spp), "-s", str(size / 512), "-o", pfm,
                "path", "-m", str(depth)]
        _, out["cli_wall_s"], out["cli_compile_s"] = timed(
            clock, lambda: cli_main(argv))
        img_cli = read_pfm(pfm)
    integ = IntegratorPathTracing(max_depth=depth)
    out["loop"] = "persistent" if use_persistent(integ) else "chunked"
    sd = cornell_box(size, size).compile()
    _, out["render_cold_s"], out["render_cold_compile_s"] = timed(
        clock, lambda: render(sd, integ, spp, seed=0)["primal"])
    img, out["render_warm_s"], out["render_warm_compile_s"] = timed(
        clock, lambda: render(sd, integ, spp, seed=0)["primal"])
    img = np.asarray(img, np.float32)
    out["msamples_per_s"] = size * size * spp / out["render_warm_s"] / 1e6
    out["cli_equals_render"] = bool(np.array_equal(img_cli, img))
    out["finite"] = bool(np.isfinite(img).all())
    ref = ref or REF_PATH
    out["gate_render"] = _correctness_gate(img, ref)
    out["gate_cli"] = _correctness_gate(img_cli, ref)
    out["bit_equal_cpu_ref"] = (hashlib.sha256(img.tobytes()).hexdigest()
                                == str(np.load(ref)["img_sha256"]))
    out["ok"] = (out["finite"] and out["gate_render"]["ok"]
                 and out["gate_cli"]["ok"])
    return out


def _moller_t(o, d, v0, v1, v2):
    """float64 ray-triangle distance (Möller-Trumbore; inf on a miss)."""
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d, e2)
    det = np.sum(e1 * p, -1)
    inv = 1.0 / np.where(det == 0, np.inf, det)
    s = o - v0
    u = np.sum(s * p, -1) * inv
    q = np.cross(s, e1)
    v = np.sum(d * q, -1) * inv
    t = np.sum(e2 * q, -1) * inv
    ok = (det != 0) & (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1 + 1e-6)
    return np.where(ok, t, np.inf)


def plane_t_f64(row, o, d):
    """float64 t = -(n.o + c) / (n.d) from the f32 plane rows [m, 4] that
    both intersector tiers evaluate, and the forward error bound of that
    evaluation in f32 (unit roundoff u; dot products within gamma_4 of
    their absolute sum):
        |dt| <= (g4 (sum|n_i o_i| + |c|) + g4 |t| sum|n_i d_i|) / |n.d|
                + u |t|,
    widened by 10% for second-order terms."""
    row = np.asarray(row, np.float64)
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    n, c = row[:, :3], row[:, 3]
    nd = np.sum(n * d, -1)
    t = -(np.sum(n * o, -1) + c) / nd
    u = 2.0 ** -24
    g4 = 4 * u / (1 - 4 * u)
    bound = (g4 * (np.abs(n * o).sum(-1) + np.abs(c))
             + g4 * np.abs(t) * np.abs(n * d).sum(-1)) / np.abs(nd)
    return t, 1.1 * (bound + u * np.abs(t))


def wavefront_rays(sd, width, seed=0):
    """Camera rays through every pixel of a width^2 image and one bounce ray
    from each camera hit (a random direction on the side of arrival), with
    a shadow-ray range for each: (o, d, tnear, tfar), 2 * width^2 rays."""
    import jax
    import jax.numpy as jnp
    from rustlight_tpu.accel import intersect_rays
    from rustlight_tpu.scene import generate_rays
    from rustlight_tpu.scene.scene import offset_ray_origin

    n = width * width
    key = jax.random.PRNGKey(seed)
    ys, xs = np.mgrid[0:width, 0:width]
    pix = jnp.asarray(np.stack([xs.ravel(), ys.ravel()], -1), jnp.float32)
    o, d = generate_rays(sd.camera, pix + jax.random.uniform(key, (n, 2)))
    first = intersect_rays(sd.geom, o, d)
    n_g = sd.geom.n_g[jnp.maximum(first.tri, 0)]
    d2 = jax.random.normal(jax.random.fold_in(key, 1), (n, 3))
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    d2 = jnp.where((jnp.sum(d2 * n_g, -1) * jnp.sum(d * n_g, -1) < 0)[:, None],
                   d2, -d2)                 # leave on the side of arrival
    p = o + d * jnp.where(first.hit, first.t, 0.0)[:, None]
    o2 = jnp.where(first.hit[:, None], offset_ray_origin(p, n_g, d2), o)
    tnear = jnp.full(2 * n, 1e-4, jnp.float32)
    tfar = jax.random.uniform(jax.random.fold_in(key, 2), (2 * n,),
                              maxval=2.0 * width)
    return jnp.concatenate([o, o2]), jnp.concatenate([d, d2]), tnear, tfar


def phase_parity(n_tris=122_000, width=256, reps=5):
    """BVH walk vs dense scan on camera + bounce rays of the sphere grid."""
    import jax
    from rustlight_tpu.accel import intersect_rays, occluded_rays
    from rustlight_tpu.models import sphere_grid

    sd = sphere_grid(n_tris, width, width).compile()
    walk, dense = sd.geom, sd.geom.replace(bvh=None)
    assert walk.bvh is not None, "the grid must take the BVH tier"
    o_all, d_all, tnear, tfar = wavefront_rays(sd, width)
    m = o_all.shape[0]

    closest = {k: jax.jit(lambda o, d, g=g: intersect_rays(g, o, d))
               for k, g in (("bvh", walk), ("dense", dense))}
    anyhit = {k: jax.jit(lambda o, d, g=g: occluded_rays(g, o, d, tnear,
                                                          tfar))
              for k, g in (("bvh", walk), ("dense", dense))}
    out = {"rays": int(m), "n_tris": int(walk.n_tris)}
    res = {}
    for k in ("bvh", "dense"):
        res[k] = jax.device_get(closest[k](o_all, d_all))
        res[k + "_any"] = np.asarray(anyhit[k](o_all, d_all))
        for name, fn in (("closest", closest[k]), ("anyhit", anyhit[k])):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(o_all, d_all))
                ts.append(time.perf_counter() - t0)
            out[f"{k}_{name}_ms"] = 1e3 * float(np.median(ts))
    b, r = res["bvh"], res["dense"]
    both = b.hit & r.hit
    out["hit_mismatch"] = int((b.hit != r.hit).sum())
    rel = np.abs(b.t[both] - r.t[both]) / np.maximum(r.t[both], 1e-30)
    out["t_max_rel"] = float(rel.max()) if rel.size else 0.0
    out["t_rel_over_1e-5"] = int((rel > 1e-5).sum())
    # which tier is right where they differ: each t against the float64
    # evaluation of the plane row it came from, within the forward error
    # bound of the f32 evaluation (TF32 products would land far outside)
    rows = np.asarray(sd.host.data.geom.inter_rows)[:, 0]
    o_np, d_np = np.asarray(o_all)[both], np.asarray(d_all)[both]
    err = {}
    for k, h in (("bvh", b), ("dense", r)):
        t64, bound = plane_t_f64(rows[h.tri[both]], o_np, d_np)
        err[k] = np.abs(h.t[both] - t64) / t64
        out[f"{k}_outside_f32_bound"] = int(
            (np.abs(h.t[both] - t64) > bound).sum())
    over = rel > 1e-5
    out["t_over_bvh_nearer_f64"] = int((err["bvh"] < err["dense"])[over].sum())
    out["t_over_dense_nearer_f64"] = int(
        (err["dense"] < err["bvh"])[over].sum())
    for k in ("bvh", "dense"):
        out[f"t_over_{k}_max_rel_f64"] = (float(err[k][over].max())
                                          if over.any() else 0.0)
    diff = np.nonzero(both & (b.tri != r.tri))[0]
    o64, d64 = np.asarray(o_all, np.float64), np.asarray(d_all, np.float64)
    v0 = np.asarray(sd.host.data.geom.v0, np.float64)
    e1 = np.asarray(sd.host.data.geom.e1, np.float64)
    e2 = np.asarray(sd.host.data.geom.e2, np.float64)

    def t64(tri):
        return _moller_t(o64[diff], d64[diff], v0[tri], v0[tri] + e1[tri],
                         v0[tri] + e2[tri])
    ta, tb = t64(b.tri[diff]), t64(r.tri[diff])
    tie = np.abs(ta - tb) <= 1e-6 * np.maximum(np.abs(tb), 1e-30)
    out["tri_ties"] = int(tie.sum())
    out["tri_mismatch_not_tie"] = int((~tie).sum())
    out["anyhit_mismatch"] = int((res["bvh_any"] != res["dense_any"]).sum())
    out["anyhit_occluded_share"] = float(res["dense_any"].mean())
    out["ok"] = (out["hit_mismatch"] == 0
                 and out["bvh_outside_f32_bound"] == 0
                 and out["dense_outside_f32_bound"] == 0
                 and out["tri_mismatch_not_tie"] == 0
                 and out["anyhit_mismatch"] == 0)
    return out


def _render_phase(clock, sd, integ, spp, lo, hi):
    from rustlight_tpu.integrators import render
    out = {"n_tris": int(sd.geom.n_tris)}
    _, out["cold_s"], out["cold_compile_s"] = timed(
        clock, lambda: render(sd, integ, spp, seed=0)["primal"])
    img, out["warm_s"], out["warm_compile_s"] = timed(
        clock, lambda: render(sd, integ, spp, seed=1)["primal"])
    img = np.asarray(img)
    out["mean"] = float(img.mean())
    out["finite"] = bool(np.isfinite(img).all())
    out["ok"] = out["finite"] and lo < out["mean"] < hi
    return out


def phase_grid_path(clock, n_tris=122_000, width=256, spp=8, depth=5):
    from rustlight_tpu.integrators import IntegratorPathTracing
    from rustlight_tpu.models import sphere_grid
    t0 = time.perf_counter()
    sd = sphere_grid(n_tris, width, width).compile()
    setup = time.perf_counter() - t0
    out = _render_phase(clock, sd, IntegratorPathTracing(max_depth=depth),
                        spp, 0.1, 2.0)
    out["scene_setup_s"] = setup
    return out


def phase_ao(clock, n_tris=4_200_000, width=256, spp=4):
    import jax
    from rustlight_tpu.integrators import IntegratorAO
    from rustlight_tpu.models import sphere_grid_ao
    t0 = time.perf_counter()
    sd = sphere_grid_ao(n_tris, width, width).compile()
    setup = time.perf_counter() - t0
    out = _render_phase(clock, sd, IntegratorAO(max_distance=2.0), spp,
                        0.3, 1.0)
    out["scene_setup_s"] = setup
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_device_gb"] = (stats["peak_bytes_in_use"] / 2 ** 30
                             if "peak_bytes_in_use" in stats
                             else "not available")
    return out


def phase_four(clock, n_dev=4, size=512, spp=128, depth=6, splat_spp=16,
               ref=None):
    """Sharded path render against one card and against the CPU reference
    `ref` (regress/bench_ref.npz by default), within GATE_MARGIN times the
    reference's floor; sharded light tracing against one card, within
    GATE_MARGIN times its own seed-to-seed floor."""
    from bench import REF_PATH, _correctness_gate
    from rustlight_tpu.integrators import (IntegratorLightTracing,
                                           IntegratorPathTracing, render)
    from rustlight_tpu.integrators.common import render_splat
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.parallel import (make_device_mesh, render_sharded,
                                        render_splat_sharded)

    mesh = make_device_mesh(n_dev)
    assert mesh.shape["d"] == n_dev, mesh.shape
    sd = cornell_box(size, size).compile()
    out = {"devices": n_dev}
    integ = IntegratorPathTracing(max_depth=depth)
    one, out["path_one_wall_s"], _ = timed(
        clock, lambda: render(sd, integ, spp, seed=0)["primal"])
    render_sharded(sd, integ, spp, mesh=mesh, seed=0)        # compile
    four, out["path_sharded_warm_s"], _ = timed(
        clock, lambda: render_sharded(sd, integ, spp, mesh=mesh,
                                      seed=0)["primal"])
    ref = ref or REF_PATH
    out["path_l1_sharded_vs_one"] = block_l1(four, one)
    out["path_limit"] = GATE_MARGIN * float(np.load(ref)["floor_l1"])
    out["path_gate_sharded"] = _correctness_gate(four, ref)
    ok = (out["path_l1_sharded_vs_one"] <= out["path_limit"]
          and out["path_gate_sharded"]["ok"])

    lt = IntegratorLightTracing(max_depth=depth)
    s_one = render_splat(sd, lt, splat_spp, seed=0)["primal"]
    s_one2 = render_splat(sd, lt, splat_spp, seed=1)["primal"]
    n_paths = splat_spp * size * size
    render_splat_sharded(sd, lt, n_paths, mesh=mesh, seed=0)  # compile
    s_four, out["splat_sharded_warm_s"], _ = timed(
        clock, lambda: render_splat_sharded(sd, lt, n_paths, mesh=mesh,
                                            seed=0)["primal"])
    out["splat_floor_l1"] = block_l1(s_one, s_one2)
    out["splat_l1_sharded_vs_one"] = block_l1(s_four, s_one)
    out["splat_limit"] = GATE_MARGIN * out["splat_floor_l1"]
    out["ok"] = bool(ok and np.isfinite(s_four).all()
                     and out["splat_l1_sharded_vs_one"] <= out["splat_limit"])
    return out


def run_phase(failed, name, fn, *args, **kw):
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
    except Exception:
        out = {"ok": False, "error": traceback.format_exc()[-2000:]}
    out["phase_s"] = time.perf_counter() - t0
    ok = bool(out.pop("ok"))
    if not ok:
        failed.append(name)
    print(f"[{name}] {'ok' if ok else 'FAILED'} {json.dumps(out)}",
          flush=True)
    return out


def run_gpu_tests():
    """Phase 6 in a child process (this process has not opened the card)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    tail = r.stdout.strip().splitlines()[-1:] or [r.stderr[-500:]]
    return {"ok": r.returncode == 0 and " passed" in tail[0],
            "rc": r.returncode, "summary": tail[0]}


def result_line(ok, devices):
    d = devices[0]
    return json.dumps({"ok": bool(ok), "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "rustlight_tpu")):
        print("chip_smoke.py must run from a checkout of the renderer",
              file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = ""
    if not smi:
        print("no GPU: nvidia-smi found no card", file=sys.stderr)
        return 1
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and not {"cuda", "gpu"} & set(plats.split(",")):
        print(f"no GPU: JAX_PLATFORMS={plats}", file=sys.stderr)
        return 1
    failed = []
    if not args.four:
        run_phase(failed, "6-gpu-tests", run_gpu_tests)

    sys.path.insert(0, REPO)
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    print(f"[1-device] {devices[0].platform} {devices[0].device_kind} "
          f"x{len(devices)}; jax {jax.__version__}")
    print(smi.splitlines()[0], flush=True)
    clock = CompileClock()
    if args.four:
        if len(devices) < 4:
            print(f"--four needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 1
        run_phase(failed, "four", phase_four, clock)
    else:
        run_phase(failed, "2-cbox", phase_cbox, clock)
        run_phase(failed, "3-parity", phase_parity)
        run_phase(failed, "4-grid122k", phase_grid_path, clock)
        run_phase(failed, "5-ao4p9m", phase_ao, clock)
    if failed:
        print("FAILED phases: " + ", ".join(failed), file=sys.stderr)
    print(result_line(not failed, devices), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
