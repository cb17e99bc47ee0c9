#!/usr/bin/env python
"""External-anchor comparison against the ONE rustlight-produced image in
the reference repo: data/rustlight/cbox.png (the README render).

This is the only render produced by the reference renderer available in
this environment (building rustlight needs a Rust toolchain: none in the
image, installs forbidden, zero egress — STATUS.md "Reference-build
blocker"), so it is the only NON-self-referential anchor for the scene
model. It is LDR (gamma 2.2, structure.rs:160-168) of UNKNOWN spp,
exposure, and light spectrum (the repo ships no cbox scene file — the
README render used external pbrt data), so the comparison fits ONE free
scalar exposure in linear space and then gates only on convention signals
that survive an exposure change:

  * quadrant ordering (camera framing / ceiling-light placement),
  * left-wall green-minus-red and right-wall red-minus-green signs
    (wall color convention — a mirrored box flips both),
  * exposure-fitted LDR l1 in the same regime (< 0.25; measured 0.137 at
    32 spp — residual is the reference's warmer light spectrum and
    unknown tone pipeline, NOT estimator error).

  python tools/cbox_anchor.py [--spp 64] [--out regress/cbox_anchor.json]

Interpretation note (committed with the metric): this anchor catches gross
scene-convention bias (mirrored walls, wrong framing, broken emission)
that self-referenced oracles are blind to by construction; it can NOT
certify estimator accuracy — that is what tests/test_analytic.py's
closed-form oracles are for.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="regress/cbox_anchor.json")
    ap.add_argument("--png", default="/root/reference/data/rustlight/cbox.png")
    args = ap.parse_args()

    from PIL import Image
    ref = np.asarray(Image.open(args.png)).astype(np.float32)[..., :3] / 255.0

    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.integrators import IntegratorPathTracing, render
    from rustlight_tpu.utils.metrics import ssim, tonemap_ldr

    h, w = ref.shape[:2]
    sd = cornell_box(w, h).compile()
    film = render(sd, IntegratorPathTracing(max_depth=8, hard_cap=8),
                  spp=args.spp, seed=0)
    lin = np.asarray(film["primal"])

    # one free exposure scalar (reference exposure unknown): golden-section
    # on LDR l1 over a generous bracket
    def l1_at(s):
        return float(np.abs(tonemap_ldr(lin * s) - ref).mean())

    scales = np.geomspace(0.25, 16.0, 97)
    l1s = [l1_at(s) for s in scales]
    s_fit = float(scales[int(np.argmin(l1s))])
    ours = tonemap_ldr(lin * s_fit)

    def quad(im):
        hh, ww = im.shape[:2]
        return [float(im[:hh // 2, :ww // 2].mean()),
                float(im[:hh // 2, ww // 2:].mean()),
                float(im[hh // 2:, :ww // 2].mean()),
                float(im[hh // 2:, ww // 2:].mean())]

    def wall_sign(im):
        ww = im.shape[1]
        left = float((im[:, :ww // 4, 1] - im[:, :ww // 4, 0]).mean())
        right = float((im[:, 3 * ww // 4:, 0] - im[:, 3 * ww // 4:, 1]).mean())
        return left, right

    lg_ours, rr_ours = wall_sign(ours)
    lg_ref, rr_ref = wall_sign(ref)
    row = {
        "exposure_fit": s_fit,
        "l1_ldr_expfit": float(np.abs(ours - ref).mean()),
        "rmse_ldr_expfit": float(np.sqrt(((ours - ref) ** 2).mean())),
        "dssim_ldr_expfit": float((1.0 - ssim(ref, ours, data_range=1.0))
                                  / 2.0),
        "quads_ours": quad(ours),
        "quads_ref": quad(ref),
        "left_green_minus_red": [lg_ours, lg_ref],
        "right_red_minus_green": [rr_ours, rr_ref],
        "spp": args.spp,
        "note": ("coarse anchor, one fitted exposure dof: guards "
                 "scene-convention bias (layout, wall colors, framing); "
                 "residual l1 is the reference's unknown light spectrum / "
                 "tone pipeline, not estimator error"),
    }
    print(json.dumps(row, indent=2))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(row, indent=2))

    # convention gates (all exposure-invariant):
    assert lg_ours > 0.02 and lg_ref > 0.02, \
        "left wall is not green in one of the images (wall swap/mirror?)"
    assert rr_ours > 0.02 and rr_ref > 0.02, \
        "right wall is not red in one of the images (wall swap/mirror?)"
    qo, qr = row["quads_ours"], row["quads_ref"]
    assert np.argmin(qo) == np.argmin(qr), \
        f"darkest quadrant differs (framing drift): {qo} vs {qr}"
    assert row["l1_ldr_expfit"] < 0.25, \
        f"exposure-fitted l1 out of regime: {row['l1_ldr_expfit']}"
    print("cbox anchor: convention gates passed")


if __name__ == "__main__":
    main()
