#!/usr/bin/env python
"""Generate regress/bench_ref.npz — the CPU reference behind the cbox
correctness gate of bench.py and chip_smoke.py.

Renders the gate's cbox config (512^2, 128 spp, max_depth 6) on the CPU
through `render(..., persistent=True)`, the loop and threefry streams an
accelerator's `render()` uses, for seeds 0 and 1. Stores seed 0's 8x8 block
means, the seed-to-seed l1 floor between the two, and the SHA-256 of seed
0's float32 image (so a GPU run can tell whether it agrees bit for bit):

    JAX_PLATFORMS=cpu python tools/make_bench_ref.py

The gate passes a render whose block-mean l1 against this reference is
within 4x the floor (statistically identical renders pass; a biased
estimator, broken emitter or wrong scene fails).
"""
import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BLOCK = 8
SIZE, SPP, DEPTH = 512, 128, 6


def make_reference(out, size=SIZE, spp=SPP, depth=DEPTH):
    """Render the reference at `size`^2 and write it to `out`; returns the
    seed-to-seed floor."""
    import jax
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.integrators import IntegratorPathTracing, render
    from bench import _block_mean

    plat = jax.devices()[0].platform
    if plat != "cpu":
        raise SystemExit("the reference is rendered on the CPU: "
                         "run with JAX_PLATFORMS=cpu")
    scene = cornell_box(size, size).compile()
    integ = IntegratorPathTracing(max_depth=depth)
    imgs = [np.asarray(render(scene, integ, spp, seed=seed,
                              persistent=True)["primal"], np.float32)
            for seed in (0, 1)]
    bm0, bm1 = (_block_mean(im.astype(np.float64), BLOCK) for im in imgs)
    floor = float(np.abs(bm0 - bm1).mean())
    sha = hashlib.sha256(imgs[0].tobytes()).hexdigest()
    np.savez_compressed(out, blockmean=bm0.astype(np.float32),
                        floor_l1=floor, block=BLOCK, platform=plat,
                        spp=spp, max_depth=depth, img_sha256=sha)
    print(f"wrote {out}: platform={plat} block={BLOCK} "
          f"floor_l1={floor:.6f} mean={bm0.mean():.6f} sha256={sha}")
    return floor


def main():
    make_reference(os.path.join(REPO, "regress", "bench_ref.npz"))


if __name__ == "__main__":
    main()
