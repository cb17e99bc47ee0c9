#!/usr/bin/env python
"""Smoke-render every scene under examples/ (reference tests/run_pbrt.sh:
render each pbrt-v3 scene at 16 spp and fail loudly on crashes/black
frames).

  python tools/smoke_scenes.py [--spp 16] [--size 128] [--out DIR]

Each scene renders with the path integrator at a small resolution; the
check is crash-freedom plus a finite, non-black film. Scenes ship in both
front-end formats (pbrt, mitsuba XML) and exercise instances, envmap IS
and dielectric/conductor/substrate materials.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", default=None,
                    help="optional directory for the rendered PFMs")
    args = ap.parse_args()

    from rustlight_tpu.scene.loaders import load_scene
    from rustlight_tpu.scene import resize_camera
    from rustlight_tpu.integrators import IntegratorPathTracing, render
    from rustlight_tpu.utils.image import write_pfm

    root = Path(__file__).parent.parent / "examples"
    scenes = sorted(p for p in root.iterdir()
                    if p.suffix in (".pbrt", ".xml", ".obj"))
    if not scenes:
        print("no scenes found under examples/", file=sys.stderr)
        return 1
    failures = []
    for sp in scenes:
        t0 = time.time()
        try:
            host = load_scene(str(sp))
            # resize_camera re-derives the projection; a bare dataclass
            # replace would keep the scene's original aspect baked into
            # sample_to_camera (anamorphic smoke renders)
            host.camera = resize_camera(host.camera, args.size, args.size)
            sd = host.compile()
            film = render(sd, IntegratorPathTracing(max_depth=6),
                          spp=args.spp, seed=0)
            img = np.asarray(film["primal"])
            ok = bool(np.isfinite(img).all()) and float(img.max()) > 0.0
            status = "ok" if ok else "BAD FILM"
            if not ok:
                failures.append(sp.name)
            if args.out:
                Path(args.out).mkdir(parents=True, exist_ok=True)
                write_pfm(Path(args.out) / (sp.stem + ".pfm"), img)
        except Exception as e:  # noqa: BLE001 — a smoke harness reports all
            status = f"FAIL: {type(e).__name__}: {e}"
            failures.append(sp.name)
        print(f"{sp.name:24s} {status}  ({time.time() - t0:.1f}s)",
              flush=True)
    if failures:
        print(f"{len(failures)} scene(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(f"all {len(scenes)} scenes smoke-rendered clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
