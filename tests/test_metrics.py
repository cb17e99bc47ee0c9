"""Metric definitions vs closed forms (parity with scripts/tonemap.py)."""
import numpy as np

from rustlight_tpu.utils.metrics import (
    compute_metric, metric_scalar, ssim, falsecolor,
)


def test_metric_formulas():
    ref = np.full((4, 4, 3), 2.0)
    test = np.full((4, 4, 3), 1.0)
    assert np.allclose(compute_metric(ref, test, "l1"), 1.0)
    assert np.allclose(compute_metric(ref, test, "l2"), 1.0)
    assert np.allclose(compute_metric(ref, test, "mape", eps=0.0), 0.5)
    assert np.allclose(compute_metric(ref, test, "smape", eps=0.0), 2.0 / 3.0)
    assert np.allclose(compute_metric(ref, test, "mrse", eps=0.0), 0.25)
    assert np.isclose(metric_scalar(ref, test, "rmse"), 1.0)


def test_ssim_identity_and_noise():
    rng = np.random.default_rng(0)
    img = rng.random((32, 32, 3))
    assert ssim(img, img) > 0.999
    noisy = img + rng.normal(0, 0.3, img.shape)
    assert ssim(img, noisy) < 0.9
    assert metric_scalar(img, img, "dssim") < 1e-3


def test_falsecolor_shape_and_range():
    err = np.random.rand(8, 8, 3)
    fc = falsecolor(err, (0, 1))
    assert fc.shape == (8, 8, 3)
    assert fc.min() >= 0.0 and fc.max() <= 1.0


def test_bench_correctness_gate():
    """bench.py's correctness envelope: the committed
    reference must pass itself, a statistically-identical render (noise at the
    measured seed-to-seed floor) must pass, and a deliberately-perturbed
    render (+5% uniform bias, far above the floor) must FAIL."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    ref = np.load(os.path.join(os.path.dirname(bench.__file__),
                               "regress", "bench_ref.npz"))
    bm, block = ref["blockmean"].astype(np.float64), int(ref["block"])
    img = np.repeat(np.repeat(bm, block, axis=0), block, axis=1)

    assert bench._correctness_gate(img)["ok"]

    rng = np.random.default_rng(3)
    noisy = img + rng.normal(0.0, float(ref["floor_l1"]), img.shape)
    assert bench._correctness_gate(noisy)["ok"]

    res = bench._correctness_gate(img * 1.05)
    assert not res["ok"] and res["l1_vs_ref"] > 4.0 * res["floor_l1"]


def test_bench_gate_fails_without_reference(tmp_path):
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    res = bench._correctness_gate(np.zeros((512, 512, 3)),
                                  str(tmp_path / "missing.npz"))
    assert not res["ok"] and "missing" in res["error"]


def test_bench_refuses_without_gpu(capsys):
    """No CPU number is ever printed under the device metric."""
    import json
    import os
    import sys
    import pytest
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 1
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["ok"] is False and "value" not in row
    assert row["device"]["platform"] == "cpu"
