#!/usr/bin/env python
"""One profiler trace of one warm render() per configuration on the local
GPU, reduced to the device's busy time and idle share inside the render's
window, and the device ops that take the most time.

  cbox      cbox 512^2, path max depth 6, 128 spp (dense tier)
  grid122k  122k-triangle sphere grid, path max depth 5, 8 spp, 256^2
  ao4p9m    4.9M-triangle sphere grid, AO, 4 spp, 256^2 (BVH tier)

    python tools/profile_render.py [cbox] [grid122k] [ao4p9m] [--out DIR]

The window is the host span of a `TraceAnnotation("render")` around the
warm render; busy is the union of device-stream op intervals inside it, so
idle share = 1 - busy / window. Tracing slows the host: each row also gives
the untraced warm wall time. Prints the card's name and power limit, then
one JSON object per configuration. Traces are kept under --out if given.
"""
import argparse
import glob
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def reduce_trace(path, window="render", top=25):
    """Busy time, idle share and top device ops of a Chrome-format trace
    (`*.trace.json.gz`) inside the host span named `window`."""
    with gzip.open(path, "rt") as f:
        ev = json.load(f)["traceEvents"]
    procs, threads = {}, {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            procs[e["pid"]] = e["args"]["name"]
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            threads[(e["pid"], e["tid"])] = e["args"]["name"]
    dev = {p for p, name in procs.items() if name.startswith("/device:GPU")}
    # kernels and copies run on streams; other device lines ("XLA Modules",
    # "XLA Ops") repeat them at coarser grain
    streams = {k for k, name in threads.items()
               if k[0] in dev and name.startswith("Stream")}
    on_device = ((lambda e: (e["pid"], e["tid"]) in streams) if streams
                 else (lambda e: e["pid"] in dev))
    spans = [e for e in ev if e.get("ph") == "X" and e.get("name") == window
             and e["pid"] not in dev]
    if not spans:
        raise ValueError(f"no host span named {window!r} in {path}")
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e["dur"] for e in spans)
    ivs, per_op = [], {}
    for e in ev:
        if e.get("ph") != "X" or e["pid"] not in dev or not on_device(e):
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if b <= a:
            continue
        ivs.append((a, b))
        s = per_op.setdefault(e["name"], [0.0, 0])
        s[0] += b - a
        s[1] += 1
    busy, end = 0.0, w0
    for a, b in sorted(ivs):
        if b > end:
            busy += b - max(a, end)
            end = b
    ops = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_ms": (w1 - w0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (w1 - w0),
            "n_device_events": len(ivs),
            "top": [[name, ms / 1e3, n] for name, (ms, n) in ops]}


def configs():
    from rustlight_tpu.integrators import IntegratorAO, IntegratorPathTracing
    from rustlight_tpu.models import cornell_box, sphere_grid, sphere_grid_ao
    return {
        "cbox": (lambda: cornell_box(512, 512).compile(),
                 IntegratorPathTracing(max_depth=6), 128),
        "grid122k": (lambda: sphere_grid(122_000, 256, 256).compile(),
                     IntegratorPathTracing(max_depth=5), 8),
        "ao4p9m": (lambda: sphere_grid_ao(4_200_000, 256, 256).compile(),
                   IntegratorAO(max_distance=2.0), 4),
    }


def profile(name, out_dir):
    import jax
    from rustlight_tpu.integrators import render
    build, integ, spp = configs()[name]
    sd = build()
    render(sd, integ, spp, seed=0)                         # compile
    t0 = time.perf_counter()
    render(sd, integ, spp, seed=0)
    untraced = time.perf_counter() - t0
    tdir = os.path.join(out_dir, name)
    with jax.profiler.trace(tdir, create_perfetto_trace=True):
        with jax.profiler.TraceAnnotation("render"):
            render(sd, integ, spp, seed=0)
    path = sorted(glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                         "*.trace.json.gz")))[-1]
    row = reduce_trace(path)
    row["warm_untraced_s"] = untraced
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="*", default=["cbox", "grid122k", "ao4p9m"])
    ap.add_argument("--out", help="keep the traces in this directory")
    args = ap.parse_args(argv)
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.what:
            row = profile(name, args.out or tmp)
            print(name, json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
