"""Tests that need the card (marker `gpu`): they skip elsewhere and run on
a GPU machine through chip_smoke.py's last phase,

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.gpu


def test_device_is_a_gpu_and_render_takes_the_persistent_loop():
    from rustlight_tpu.integrators import IntegratorPathTracing
    from rustlight_tpu.integrators.common import use_persistent
    assert jax.devices()[0].platform == "gpu"
    assert use_persistent(IntegratorPathTracing(max_depth=2))


def test_camera_rays_full_precision_on_gpu():
    """No TF32 in the camera transform: rays match float64 to 1e-6."""
    from test_runtime import _camera_rays_f64
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.scene import generate_rays
    cam = cornell_box(512, 512).camera
    px = np.random.RandomState(0).uniform(0, 512, (65536, 2))
    _, d = generate_rays(cam, jnp.asarray(px, jnp.float32))
    np.testing.assert_allclose(np.asarray(d, np.float64),
                               _camera_rays_f64(cam, px), atol=1e-6)


def test_dense_trace_full_precision_on_gpu():
    """The dense tier's products run at full f32 on the card: camera-ray
    hit distances in the Cornell box match float64 to 1e-5 relative."""
    import chip_smoke
    from rustlight_tpu.accel import intersect_rays
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.scene import generate_rays
    sd = cornell_box(256, 256).compile()
    px = np.random.RandomState(1).uniform(0, 256, (65536, 2))
    o, d = generate_rays(sd.camera, jnp.asarray(px, jnp.float32))
    rh = jax.device_get(intersect_rays(sd.geom, o, d))
    g = sd.host.data.geom
    hit = rh.hit
    tri = rh.tri[hit]
    t64 = chip_smoke._moller_t(
        np.asarray(o, np.float64)[hit], np.asarray(d, np.float64)[hit],
        g.v0[tri].astype(np.float64), (g.v0 + g.e1)[tri].astype(np.float64),
        (g.v0 + g.e2)[tri].astype(np.float64))
    assert hit.mean() > 0.9
    np.testing.assert_allclose(rh.t[hit], t64, rtol=1e-5)


@pytest.mark.parametrize("n_tris", [3000, 20000])
def test_walk_matches_dense_on_gpu(n_tris):
    import chip_smoke
    out = chip_smoke.phase_parity(n_tris=n_tris, width=128, reps=1)
    assert out["ok"], out
