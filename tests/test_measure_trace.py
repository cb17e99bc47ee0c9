"""tools/measure_trace.py's Triton-route trace kernel (in interpret mode)
against the dense tier, and tools/profile_render.py's trace reducer."""
import gzip
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from measure_trace import triton_trace  # noqa: E402
from profile_render import reduce_trace  # noqa: E402


def _cbox_wavefront(n):
    import chip_smoke
    import jax.numpy as jnp
    from rustlight_tpu.models import cornell_box
    sd = cornell_box(32, 32).compile()
    o, d, tnear, tfar = chip_smoke.wavefront_rays(sd, 32)
    # two lanes in three unbounded, the rest with a short shadow range
    tfar = jnp.where(jnp.arange(o.shape[0]) % 3 == 0, tfar, jnp.inf)
    return sd.geom.inter_rows, o[:n], d[:n], tnear[:n], tfar[:n]


def _soup_wavefront(n, n_tris=150):
    import jax.numpy as jnp
    from rustlight_tpu.scene.geometry import TriMesh, build_geometry_tables
    rng = np.random.RandomState(2)
    c = rng.uniform(-1, 1, (n_tris, 1, 3))
    verts = (c + 0.3 * rng.normal(size=(n_tris, 3, 3))).reshape(-1, 3)
    geom = build_geometry_tables(
        [TriMesh(verts, np.arange(3 * n_tris).reshape(-1, 3))], [-1])
    o = rng.uniform(-3, 3, (n, 3))
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (jnp.asarray(geom.inter_rows), jnp.asarray(o, jnp.float32),
            jnp.asarray(d, jnp.float32), jnp.full(n, 1e-4, jnp.float32),
            jnp.full(n, jnp.inf, jnp.float32))


@pytest.mark.parametrize("scene,block", [("cbox", 256), ("soup", 128)])
def test_triton_trace_matches_dense_tier(scene, block):
    from rustlight_tpu.accel import dense
    n = 1001                                         # not a block multiple
    rows, o, d, tnear, tfar = (_cbox_wavefront if scene == "cbox"
                               else _soup_wavefront)(n)
    ref = dense._intersect_impl(rows, o, d, tnear, tfar, False)
    t, tri, u, v = (np.asarray(x) for x in triton_trace(
        rows, o, d, tnear, tfar, block=block, interpret=True))
    hit = np.asarray(ref.hit)
    assert 0.3 < hit.mean() < 1.0
    np.testing.assert_array_equal(tri, np.asarray(ref.tri))
    np.testing.assert_array_equal(np.isinf(t), ~hit)
    # both evaluate the same plane rows in f32, in another order: each t
    # lies within that evaluation's error bound of the float64 t
    import chip_smoke
    t64, bound = chip_smoke.plane_t_f64(np.asarray(rows)[tri[hit], 0],
                                        np.asarray(o)[hit], np.asarray(d)[hit])
    assert (np.abs(t[hit] - t64) <= bound).all()
    assert (np.abs(np.asarray(ref.t)[hit] - t64) <= bound).all()
    np.testing.assert_allclose(u[hit], np.asarray(ref.u)[hit], atol=1e-5)
    np.testing.assert_allclose(v[hit], np.asarray(ref.v)[hit], atol=1e-5)


def _write_trace(path, events):
    meta = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 2, "tid": 7, "name": "thread_name",
         "args": {"name": "Stream #7(Compute)"}},
        {"ph": "M", "pid": 2, "tid": 9, "name": "thread_name",
         "args": {"name": "XLA Modules"}},
    ]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": meta + events}, f)


def test_reduce_trace_busy_idle_and_top(tmp_path):
    path = str(tmp_path / "t.trace.json.gz")

    def x(pid, tid, name, ts, dur):
        return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts,
                "dur": dur}
    _write_trace(path, [
        x(1, 1, "render", 100.0, 1000.0),            # the window
        x(2, 7, "gemm", 50.0, 100.0),                # clipped to 100-150
        x(2, 7, "fusion", 200.0, 300.0),
        x(2, 7, "gemm", 400.0, 200.0),               # overlaps the fusion
        x(2, 7, "late", 1200.0, 50.0),               # outside the window
        x(2, 9, "jit_module", 100.0, 1000.0),        # not a stream
        x(1, 1, "host_op", 300.0, 500.0),            # host, not device
    ])
    out = reduce_trace(path)
    assert out["window_ms"] == pytest.approx(1.0)
    # union: [100,150] + [200,600] = 450 us
    assert out["busy_ms"] == pytest.approx(0.45)
    assert out["idle_share"] == pytest.approx(0.55)
    assert out["n_device_events"] == 3
    assert out["top"] == [["fusion", pytest.approx(0.3), 1],
                          ["gemm", pytest.approx(0.25), 2]]


def test_reduce_trace_needs_the_window(tmp_path):
    path = str(tmp_path / "t.trace.json.gz")
    _write_trace(path, [{"ph": "X", "pid": 2, "tid": 7, "name": "k",
                         "ts": 0.0, "dur": 1.0}])
    with pytest.raises(ValueError, match="render"):
        reduce_trace(path)
