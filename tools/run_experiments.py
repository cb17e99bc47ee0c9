#!/usr/bin/env python
"""Batch experiment runner (reference run.py + run_plane_exp.sh).

Sweeps integrator configurations over scenes under an spp or equal-time
budget, recording wall clock, achieved spp and metrics vs a reference render
into a CSV — the `Elapsed Integrator` scraping workflow of the reference's
run.py:34-100, minus the log parsing (we own the clock).

  python tools/run_experiments.py --scene cbox --time 10 \\
      -t path pssmlt light vpl
  python tools/run_experiments.py --scene cbox --medium 0.004 \\
      -t point-normal:tr point-normal:ex point-normal:warp_T_bezier \\
         plane-single:average plane-single:cmis
"""
import argparse
import csv
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def make_integrator(spec: str):
    from rustlight_tpu import integrators as I
    from rustlight_tpu.integrators.mcmc import (
        IntegratorPSSMLT, IntegratorERPT, IntegratorSMCMC,
    )
    from rustlight_tpu.integrators.gradient import IntegratorGradientPath

    name, _, opt = spec.partition(":")
    path = lambda: I.IntegratorPathTracing(max_depth=8, hard_cap=8)
    if name == "path":
        return path()
    if name == "ao":
        return I.IntegratorAO()
    if name == "direct":
        return I.IntegratorDirect()
    if name == "light":
        return I.IntegratorLightTracing(max_depth=8, hard_cap=8)
    if name == "vpl":
        return I.IntegratorVPL(nb_vpl=int(opt or 256), max_depth=6, hard_cap=6)
    if name == "pssmlt":
        return IntegratorPSSMLT(path(), nb_samples_norm=16384, nb_chains=65536)
    if name == "erpt":
        return IntegratorERPT(path(), chain_samples=64, nb_samples_norm=16384)
    if name == "smcmc":
        return IntegratorSMCMC(path(), recons=opt or "naive")
    if name == "gradient-path":
        return IntegratorGradientPath(max_depth=6, hard_cap=6,
                                      recons=opt or "uniform")
    if name == "point-normal":
        strat = {"tr": ("tr",), "ex": ("equiangular",),
                 "ex_clamp": ("eq_clamp",), "tr_ex": ("tr", "equiangular")}
        if opt.startswith("warp"):
            _, chars, kind = (opt.split("_") + ["linear"])[:3]
            return I.IntegratorPointNormal(strategies=("warp",), warps=chars,
                                           warps_strategy=kind)
        return I.IntegratorPointNormal(strategies=strat.get(opt, ("tr", "equiangular")))
    if name == "plane-single":
        return I.IntegratorSinglePlane(nb_primitive=512, strategy=opt or "average")
    if name == "vol-primitives":
        return I.IntegratorVolPrimitives(nb_primitive=2048,
                                         primitives=opt or "bre", radius=5.0)
    raise SystemExit(f"unknown technique {spec}")


def main():
    import jax
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="cbox")
    ap.add_argument("--res", type=float, default=0.25)
    ap.add_argument("--medium", type=float, default=0.0)
    ap.add_argument("-t", "--techniques", nargs="+", required=True)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--time", type=float, default=None,
                    help="equal-time budget in seconds instead of --spp")
    ap.add_argument("--out", default="experiments")
    ap.add_argument("--ref-spp", type=int, default=128)
    args = ap.parse_args()

    from rustlight_tpu.cli import build_parser, load_scene_arg
    from rustlight_tpu.integrators.meta import IntegratorEqualTime, _render_once
    from rustlight_tpu.utils import image as rimage
    from rustlight_tpu.utils.metrics import metric_scalar

    cli = build_parser().parse_args(
        [args.scene, "-s", str(args.res), "-m", str(args.medium), "path"])
    sd = load_scene_arg(cli).compile()

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ref_path = out / f"{Path(args.scene).stem}_ref.exr"
    if not ref_path.exists():
        print(f"rendering reference ({args.ref_spp} spp)...")
        film = _render_once(sd, make_integrator("path"), args.ref_spp, seed=999)
        rimage.save(str(ref_path), film["primal"])
    ref = rimage.load(str(ref_path))

    rows = []
    for spec in args.techniques:
        integ = make_integrator(spec)
        t0 = time.time()
        if args.time is not None:
            meta = IntegratorEqualTime(integ, target_s=args.time, spp_per_pass=4)
            film = meta.render(sd)
            spp = meta.achieved_spp
        else:
            film = _render_once(sd, integ, args.spp, seed=0)
            spp = args.spp
        dt = time.time() - t0
        img = film["primal"]
        rimage.save(str(out / f"{spec.replace(':', '_')}.exr"), img)
        row = dict(technique=spec, spp=spp, time_s=round(dt, 3),
                   device=jax.devices()[0].device_kind,
                   l1=metric_scalar(ref, img, "l1"),
                   mape=metric_scalar(ref, img, "mape"),
                   rmse=metric_scalar(ref, img, "rmse"))
        rows.append(row)
        print(row)

    # merge-update by technique: a single-technique rerun must not drop the
    # other committed rows
    csv_path = out / "results.csv"
    old_rows = {}
    if csv_path.exists():
        with open(csv_path, newline="") as f:
            for r in csv.DictReader(f):
                old_rows[r["technique"]] = r
    for r in rows:
        old_rows[r["technique"]] = r
    # a wall time names the device it was taken on
    fieldnames = ["technique", "spp", "time_s", "device", "l1", "mape",
                  "rmse"]
    with open(csv_path, "w", newline="") as f:
        wcsv = csv.DictWriter(f, fieldnames=fieldnames)
        wcsv.writeheader()
        wcsv.writerows(old_rows.values())
    print(f"wrote {csv_path} ({len(old_rows)} rows)")


if __name__ == "__main__":
    main()
