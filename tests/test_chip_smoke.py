"""chip_smoke.py: its refusals without a GPU, the format of its last line,
and a CPU rehearsal of every phase at a tiny size."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok")), line


def test_refuses_without_gpu():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    _no_result(r.stdout)


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    _no_result(r.stdout)


def test_last_line_format():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
    line = chip_smoke.result_line(True, [Dev()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_refuses_cpu_platform_before_the_gpu_tests(monkeypatch, capsys):
    """With JAX held to the CPU the script refuses before phase 6 starts a
    pytest child on the card."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "NVIDIA H100, 700 W\n", "")
    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert chip_smoke.main([]) != 0
    assert [c[0] for c in calls] == ["nvidia-smi"]
    assert "no GPU" in capsys.readouterr().err


def test_plane_t_bound_holds_for_the_dense_tier():
    """The dense tier's f32 t stays within plane_t_f64's error bound of the
    float64 t, on grazing and head-on rays; for head-on rays longer than
    the plane's distance from the origin the bound is under 1e-5 of t."""
    import jax
    import jax.numpy as jnp
    from rustlight_tpu.accel import intersect_rays
    from rustlight_tpu.scene.geometry import TriMesh, build_geometry_tables
    rng = np.random.RandomState(5)
    verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    geom = build_geometry_tables(
        [TriMesh(verts * 50 + [30, -20, 40], np.array([[0, 1, 2]]))], [-1])
    n = 4096
    target = (np.array([30, -20, 40], np.float32)
              + rng.uniform(-10, 10, (n, 3)) * [1, 1, 0])
    cos = np.concatenate([rng.uniform(1e-4, 1e-2, n // 2),
                          rng.uniform(0.9, 1.0, n - n // 2)])
    phi = rng.uniform(0, 2 * np.pi, n)
    sin = np.sqrt(1 - cos ** 2)
    d = np.stack([sin * np.cos(phi), sin * np.sin(phi), -cos], -1)
    o = (target - d * rng.uniform(1, 300, (n, 1))).astype(np.float32)
    d = d.astype(np.float32)
    rh = intersect_rays(jax.device_put(geom), jnp.asarray(o), jnp.asarray(d))
    hit = np.asarray(rh.hit)
    assert hit.mean() > 0.95
    t64, bound = chip_smoke.plane_t_f64(
        np.asarray(geom.inter_rows)[np.asarray(rh.tri)[hit], 0],
        o[hit], d[hit])
    assert (np.abs(np.asarray(rh.t)[hit] - t64) <= bound).all()
    head_on = (cos[hit] > 0.9) & (t64 > 50.0)
    assert head_on.sum() > 1000
    assert (bound[head_on] / t64[head_on]).max() < 1e-5


@pytest.fixture(scope="module")
def clock():
    return chip_smoke.CompileClock()


@pytest.fixture(scope="module")
def ref32(tmp_path_factory):
    """A CPU reference for the rehearsals' 32^2 cbox."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_bench_ref import make_reference
    path = str(tmp_path_factory.mktemp("ref") / "ref32.npz")
    make_reference(path, size=32, spp=8, depth=3)
    return path


def test_rehearse_cbox(clock, ref32):
    out = chip_smoke.phase_cbox(clock, size=32, spp=8, depth=3, ref=ref32)
    assert out["ok"] and out["cli_equals_render"], out
    assert out["loop"] == "chunked"            # the CPU takes the chunked loop
    assert out["render_cold_compile_s"] > 0.0
    assert out["gate_render"]["ok"] and out["gate_cli"]["ok"]


def test_block_l1():
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 1, (16, 24, 3))
    assert chip_smoke.block_l1(a, a) == 0.0
    assert abs(chip_smoke.block_l1(a, a + 0.25) - 0.25) < 1e-12


def test_rehearse_parity():
    out = chip_smoke.phase_parity(n_tris=2000, width=32, reps=1)
    assert out["ok"], out
    assert out["rays"] == 2 * 32 * 32


def test_rehearse_grid_and_ao(clock):
    assert chip_smoke.phase_grid_path(clock, n_tris=2000, width=16, spp=2,
                                      depth=3)["ok"]
    out = chip_smoke.phase_ao(clock, n_tris=3000, width=16, spp=2)
    assert out["ok"] and out["n_tris"] > 3000


def test_rehearse_four_on_virtual_devices(clock, ref32):
    out = chip_smoke.phase_four(clock, size=32, spp=8, depth=3, splat_spp=8,
                                ref=ref32)
    assert out["devices"] == 4
    assert out["path_l1_sharded_vs_one"] <= out["path_limit"], out
    assert out["path_gate_sharded"]["ok"], out
    assert out["splat_l1_sharded_vs_one"] <= out["splat_limit"]
