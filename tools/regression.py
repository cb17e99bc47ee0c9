#!/usr/bin/env python
"""Image-regression harness (reference tests/launch.py).

Renders named scene x technique combinations under an spp or time budget,
compares against stored reference images with l1/l2/mape/dssim, and writes an
HTML comparison table.

  python tools/regression.py --out regress/ --spp 32          # run + compare
  python tools/regression.py --out regress/ --make-refs       # (re)build refs
  python tools/regression.py --scenes cbox_path -t path pssmlt
  python tools/regression.py --make-floors   # ref-vs-ref noise floors
  python tools/regression.py --check         # GATE: exit 1 on metric drift

The gate: --check re-renders each row and fails if any metric exceeds
  limit = stored * 1.3 + 1.5 * floor
where `floor` is the scene's ref-vs-ref noise floor (two independent
256-spp references, regress/floors.json; a gated row with no measured
floor fails loudly). Renders are seed-fixed and deterministic, so within
one code state the fresh metrics equal the stored ones exactly — a breach
means the renderer's output drifted beyond noise, not that the dice
rolled badly.

The gate is PINNED TO CPU: the XLA CPU lowering reproduces stored rows to
the last bit across rounds, while an accelerator toolchain update may change
fusion and rounding and so re-roll every pixel (statistically identical,
but a drift gate would see MC-noise-scale "drift" on every row). A drift
gate needs bit-stability across toolchains, which only the CPU gives."""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

METRICS = ["l1", "l2", "mape", "dssim"]
GI_ALGO = ["path", "light", "pssmlt", "vpl", "erpt", "smcmc",
           "gradient-path"]


def build_tests():
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.scene import make_volume

    def cbox():
        return cornell_box(128, 128)

    def cbox_medium():
        sc = cornell_box(128, 128)
        sc.volume = make_volume(sigma_s=(0.0025,) * 3)
        return sc

    def veach():
        from rustlight_tpu.models import veach_mis
        return veach_mis(128, 96)

    return {
        "cbox_ao": dict(scene=cbox, techniques=["ao"]),
        "cbox_direct": dict(scene=cbox, techniques=["direct"],
                            ref_tech="direct"),
        "cbox_path": dict(scene=cbox,
                          techniques=GI_ALGO + ["gradient-path-explicit"]),
        # volumetric: forward path vs adjoint light tracing in the medium
        "cbox_medium": dict(scene=cbox_medium, techniques=["path", "light"]),
        # veach's l2 floor is dominated by ~50 near-delta pixels (light
        # silhouettes + the exponent-5000 highlight); a 4096-spp reference
        # puts the row inside an ordinary floor (VERDICT r4 item 7)
        "veach_mis": dict(scene=veach, techniques=["path"], ref_spp=4096),
        # single-scatter estimators compare against a single-scatter ref
        "cbox_medium_single": dict(scene=cbox_medium,
                                   techniques=["point-normal", "path-single",
                                               "plane-single",
                                               "plane-single-unc"],
                                   ref_tech="path-single"),
        # photon-primitive family (BRE/beams/planes/VRL,
        # vol_primitives.rs:40-374): biased density estimators, gated on
        # their own stored rows against the multiple-scattering path ref
        "cbox_medium_prims": dict(scene=cbox_medium,
                                  techniques=["bre", "beams", "planes",
                                              "vrl"],
                                  ref_tech="path", spp=8),
    }


def make_integrator(name):
    from rustlight_tpu import integrators as I
    from rustlight_tpu.integrators.mcmc import (
        IntegratorERPT, IntegratorPSSMLT, IntegratorSMCMC)

    if name == "ao":
        return I.IntegratorAO()
    if name == "path":
        return I.IntegratorPathTracing(max_depth=8, hard_cap=8)
    if name == "light":
        return I.IntegratorLightTracing(max_depth=8, hard_cap=8)
    if name == "vpl":
        return I.IntegratorVPL(nb_vpl=256, max_depth=6, hard_cap=6)
    if name == "pssmlt":
        return IntegratorPSSMLT(
            I.IntegratorPathTracing(max_depth=8, hard_cap=8),
            nb_samples_norm=16384, nb_chains=65536)
    if name == "erpt":
        return IntegratorERPT(
            I.IntegratorPathTracing(max_depth=6, hard_cap=6),
            nb_mc=2, chain_samples=16, nb_samples_norm=16384)
    if name == "smcmc":
        return IntegratorSMCMC(
            I.IntegratorPathTracing(max_depth=6, hard_cap=6), recons="naive")
    if name == "direct":
        return I.IntegratorDirect(nb_light_samples=1, nb_bsdf_samples=1)
    if name == "gradient-path":
        from rustlight_tpu.integrators.gradient import (
            IntegratorGradientPathReconnect)
        return IntegratorGradientPathReconnect(max_depth=6)
    if name == "gradient-path-explicit":
        from rustlight_tpu.integrators.gradient import IntegratorGradientPath
        return IntegratorGradientPath(max_depth=6)
    if name == "point-normal":
        return I.IntegratorPointNormal(strategies=("tr", "equiangular"))
    if name == "path-single":
        return I.IntegratorPathTracing(max_depth=2, hard_cap=2, min_depth=1,
                                       single_scattering=True)
    if name == "plane-single":
        return I.IntegratorSinglePlane(nb_primitive=256, strategy="average")
    if name == "plane-single-unc":
        return I.IntegratorSinglePlane(nb_primitive=256, strategy="average",
                                       uncorrelated=True)
    if name in ("bre", "beams", "planes", "vrl"):
        return I.IntegratorVolPrimitives(nb_primitive=1024, max_depth=6,
                                         hard_cap=6, primitives=name,
                                         radius=8.0)
    raise ValueError(name)


def render_one(scene_data, name, spp, seed=0):
    from rustlight_tpu.integrators.meta import _render_once
    return _render_once(scene_data, make_integrator(name), spp, seed)


def main():
    import os
    if "--check" in sys.argv:
        # the gate is CPU-pinned (see module docstring); set before the
        # first backend use
        os.environ["JAX_PLATFORMS"] = "cpu"
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="regress")
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--make-refs", action="store_true")
    ap.add_argument("--make-floors", action="store_true",
                    help="render a second independent reference per scene "
                         "and store ref-vs-ref metrics as noise floors")
    ap.add_argument("--check", action="store_true",
                    help="gate: exit 1 if any recomputed metric exceeds "
                         "stored * 1.3 + 1.5 * floor")
    ap.add_argument("-t", "--techniques", nargs="+")
    ap.add_argument("-s", "--scenes", nargs="+")
    args = ap.parse_args()

    from rustlight_tpu.utils import image as rimage
    from rustlight_tpu.utils.metrics import metric_scalar

    out = Path(args.out)
    refs = out / "refs"
    out.mkdir(parents=True, exist_ok=True)
    refs.mkdir(parents=True, exist_ok=True)

    tests = build_tests()
    results = {}
    floors_path = out / "floors.json"
    floors = {}
    if floors_path.exists():
        try:
            floors = json.loads(floors_path.read_text())
        except Exception:
            floors = {}
    for tname, spec in tests.items():
        if args.scenes and tname not in args.scenes:
            continue
        scene_data = spec["scene"]().compile()
        ref_spp = spec.get("ref_spp", args.ref_spp)
        ref_path = refs / f"{tname}.exr"
        ref_tech = spec.get("ref_tech",
                            "ao" if spec["techniques"] == ["ao"] else "path")
        if args.make_refs or not ref_path.exists():
            print(f"[{tname}] rendering reference ({ref_spp} spp path)...")
            film = render_one(scene_data, ref_tech, ref_spp, seed=777)
            rimage.save(str(ref_path), film["primal"])
        ref = rimage.load(str(ref_path))
        if args.make_floors:
            # an INDEPENDENT equal-spp reference: its metrics against the
            # stored one are the pure-MC noise floor for this scene/ref_spp
            print(f"[{tname}] rendering second reference (noise floor)...")
            film2 = render_one(scene_data, ref_tech, ref_spp, seed=778)
            floors[tname] = {m: metric_scalar(ref, film2["primal"], m)
                             for m in METRICS}
            print(f"[{tname}] floor: {floors[tname]}")
            floors_path.write_text(json.dumps(floors, indent=2))
            continue

        for tech in spec["techniques"]:
            if args.techniques and tech not in args.techniques:
                continue
            t0 = time.time()
            film = render_one(scene_data, tech, spec.get("spp", args.spp))
            dt = time.time() - t0
            # gate mode must not clobber the COMMITTED artifacts (tests pin
            # error-mass shapes on them); park check renders in a side dir
            img_dir = out / "check" if args.check else out
            img_dir.mkdir(parents=True, exist_ok=True)
            img_path = img_dir / f"{tname}_{tech}.exr"
            rimage.save(str(img_path), film["primal"])
            row = {m: metric_scalar(ref, film["primal"], m) for m in METRICS}
            row["time_s"] = round(dt, 2)
            import jax
            row["backend"] = jax.default_backend()
            results[f"{tname}/{tech}"] = row
            print(f"[{tname}/{tech}] {row}")

    res_path = out / "results.json"
    if args.check:
        # GATE mode: compare fresh rows against the committed matrix; do
        # NOT update it. limit = stored * 1.3 + 1.5 * scene noise floor.
        stored = json.loads(res_path.read_text()) if res_path.exists() else {}
        breaches = []
        for key, row in results.items():
            srow = stored.get(key)
            if srow is None:
                print(f"[check] {key}: no stored row (skipped)")
                continue
            scene_name = key.split("/")[0]
            fl = floors.get(scene_name)
            if fl is None:
                # a gated row without a measured noise floor means the 1.3x
                # band is doing load-bearing work with no justification —
                # fail loudly instead of silently gating at floor=0
                breaches.append(
                    f"{key}: no noise floor for scene '{scene_name}' in "
                    f"{floors_path} — run tools/regression.py --make-floors")
                continue
            for m in METRICS:
                limit = srow[m] * 1.3 + 1.5 * fl.get(m, 0.0)
                if row[m] > limit:
                    breaches.append(
                        f"{key} {m}: {row[m]:.6g} > limit {limit:.6g} "
                        f"(stored {srow[m]:.6g}, floor {fl.get(m, 0.0):.6g})")
        if breaches:
            print("REGRESSION GATE FAILED:")
            for b in breaches:
                print("  " + b)
            sys.exit(1)
        print(f"regression gate OK ({len(results)} rows checked)")
        return
    if args.make_floors:
        print(f"floors written: {floors_path}")
        return

    # merge-update: a partial run (one scene/technique) must not clobber the
    # other rows of the committed matrix
    merged = {}
    if res_path.exists():
        try:
            merged = json.loads(res_path.read_text())
        except Exception:
            merged = {}
    merged.update(results)
    res_path.write_text(json.dumps(merged, indent=2))

    # simple HTML report (stand-in for the interactive-viewer submodule)
    rows = "".join(
        f"<tr><td>{k}</td>" + "".join(
            f"<td>{v[m]:.5g}</td>" for m in METRICS + ["time_s"]) + "</tr>"
        for k, v in sorted(merged.items()))
    (out / "index.html").write_text(
        "<html><body><h1>rustlight_tpu regression</h1><table border=1>"
        "<tr><th>test</th>" + "".join(f"<th>{m}</th>" for m in METRICS + ["time_s"])
        + f"</tr>{rows}</table></body></html>")
    print(f"report: {out/'index.html'}")


if __name__ == "__main__":
    main()
