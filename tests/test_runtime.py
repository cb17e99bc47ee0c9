"""Runtime plumbing: the pytree dataclass helper, the compile-cache setter,
the loop-form rule, and camera precision."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustlight_tpu.utils import pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytree.dataclass
class _Tab:
    size: int = pytree.field(static=True)
    data: object
    extra: object = None
    label: str = pytree.field(static=True, default="x")


class TestPytree:
    def test_static_fields_stay_out_of_the_leaves(self):
        t = _Tab(size=3, data=np.ones(3), extra=np.zeros(2))
        leaves, treedef = jax.tree_util.tree_flatten(t)
        assert len(leaves) == 2
        back = jax.tree_util.tree_unflatten(treedef, leaves)
        assert back.size == 3 and back.label == "x"
        assert jax.tree.map(lambda x: x + 1, t).size == 3

    def test_replace_returns_a_changed_copy(self):
        t = _Tab(size=3, data=np.ones(3))
        u = t.replace(size=4, extra=np.ones(1))
        assert (t.size, t.extra) == (3, None)
        assert u.size == 4 and u.extra.shape == (1,)
        with pytest.raises(Exception):
            t.size = 5                      # frozen

    def test_jit_specializes_on_static_fields(self):
        traces = []

        @jax.jit
        def f(t):
            traces.append(t.size)
            return t.data * t.size

        a = _Tab(size=2, data=jnp.ones(3))
        assert float(f(a)[0]) == 2.0
        assert float(f(a.replace(data=jnp.zeros(3)))[0]) == 0.0
        assert traces == [2]                # same static value: cached
        assert float(f(a.replace(size=5))[0]) == 5.0
        assert traces == [2, 5]             # new static value: retraced


class TestCompileCache:
    def _enable(self, monkeypatch, **env):
        import rustlight_tpu
        for k in ("JAX_COMPILATION_CACHE_DIR",
                  "RUSTLIGHT_TPU_NO_COMPILE_CACHE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        before = jax.config.jax_compilation_cache_dir
        try:
            got = rustlight_tpu.enable_compile_cache()
            return got, jax.config.jax_compilation_cache_dir, before
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_env_dir_is_honoured_and_nothing_set(self, monkeypatch,
                                                 tmp_path):
        got, now, before = self._enable(
            monkeypatch, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
        assert got is None and now == before

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        got, now, _ = self._enable(monkeypatch)
        assert got == now == os.path.join(REPO, ".jax_cache")
        assert self._enable(monkeypatch)[0] == got      # stable path

    def test_opt_out(self, monkeypatch):
        got, now, before = self._enable(
            monkeypatch, RUSTLIGHT_TPU_NO_COMPILE_CACHE="1")
        assert got is None and now == before

    def test_one_setter(self):
        hits = []
        for root in ("rustlight_tpu", "tools"):
            for dirpath, _, files in os.walk(os.path.join(REPO, root)):
                for f in files:
                    if f.endswith(".py"):
                        p = os.path.join(dirpath, f)
                        if "jax_compilation_cache_dir" in open(p).read():
                            hits.append(os.path.relpath(p, REPO))
        for f in ("bench.py", "chip_smoke.py"):
            assert "jax_compilation_cache_dir" not in open(
                os.path.join(REPO, f)).read()
        assert hits == [os.path.join("rustlight_tpu", "__init__.py")]


@pytest.mark.parametrize("backend,integ,sampler,variance,want", [
    ("gpu", "path", "independent", False, True),
    ("cpu", "path", "independent", False, False),
    ("gpu", "path", "stratified", False, False),
    ("gpu", "path", "independent", True, False),
    ("gpu", "ao", "independent", False, False),
])
def test_loop_form_rule(monkeypatch, backend, integ, sampler, variance,
                        want):
    from rustlight_tpu.integrators import IntegratorAO, IntegratorPathTracing
    from rustlight_tpu.integrators import common
    monkeypatch.setattr(common.jax, "default_backend", lambda: backend)
    it = (IntegratorPathTracing(max_depth=2) if integ == "path"
          else IntegratorAO())
    assert common.use_persistent(it, sampler, variance) is want


@pytest.mark.parametrize("sharded", [False, True])
def test_render_entry_points_follow_the_rule(monkeypatch, sharded):
    """render() and render_sharded() take compute_block exactly when the
    rule says so (here: an accelerator backend is faked)."""
    from rustlight_tpu.integrators import IntegratorPathTracing, common
    from rustlight_tpu.models import cornell_box
    from rustlight_tpu.parallel import make_device_mesh, render_sharded
    sd = cornell_box(8, 8).compile()
    calls = []

    class Spy(IntegratorPathTracing):
        def compute_block(self, *a, **k):
            calls.append("block")
            return super().compute_block(*a, **k)

    it = Spy(max_depth=2, hard_cap=2)
    for backend, want in (("cpu", []), ("gpu", ["block"])):
        calls.clear()
        monkeypatch.setattr(common.jax, "default_backend", lambda: backend)
        if sharded:
            render_sharded(sd, it, 1, mesh=make_device_mesh(2))
        else:
            common.render(sd, it, 1)
        assert calls == want, backend


def _camera_rays_f64(cam, px):
    s = np.stack([px[:, 0] / cam.width, px[:, 1] / cam.height,
                  np.zeros(len(px))], -1).astype(np.float64)
    m = np.asarray(cam.sample_to_camera, np.float64)
    q = s @ m[:3, :3].T + m[:3, 3]
    w = s @ m[3, :3] + m[3, 3]
    p = q / w[:, None]
    d = p / np.linalg.norm(p, axis=-1, keepdims=True)
    return d @ np.asarray(cam.to_world, np.float64)[:3, :3].T


@pytest.mark.parametrize("scene", ["cbox", "grid", "wide"])
def test_camera_rays_match_float64(scene):
    from rustlight_tpu.models import cornell_box, sphere_grid
    from rustlight_tpu.scene import generate_rays, make_camera, look_at
    if scene == "cbox":
        cam = cornell_box(64, 48).camera
    elif scene == "grid":
        cam = sphere_grid(2000, 40, 40).camera
    else:
        cam = make_camera(80, 20, fov=120.0, to_world=look_at(
            (1e3, -2e2, 5e2), (0, 0, 0), (0, 0, 1)))
    rng = np.random.RandomState(0)
    px = rng.uniform(0, 1, (4096, 2)) * [cam.width, cam.height]
    _, d = generate_rays(cam, jnp.asarray(px, jnp.float32))
    np.testing.assert_allclose(np.asarray(d, np.float64),
                               _camera_rays_f64(cam, px), atol=1e-6)
