"""Statistical integrator oracles (SURVEY.md §4: image-parity testing).

Without the Rust toolchain the reference cannot render on CI, so the oracles
are analytic (white furnace) and cross-estimator consistency (different
unbiased strategies must agree in expectation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustlight_tpu.models import cornell_box, furnace_scene
from rustlight_tpu.integrators import (
    IntegratorAO, IntegratorDirect, IntegratorPathTracing, render,
)

CBOX = cornell_box(48, 48).compile()


def _mean(film):
    return film["primal"].mean()


class TestFurnace:
    def test_white_furnace_single_bounce(self):
        # convex diffuse sphere (albedo .5) in a unit furnace: every first
        # bounce escapes, so sphere pixels = albedo exactly; background = 1
        scene = furnace_scene(24, 24, albedo=0.5).compile()
        integ = IntegratorPathTracing(max_depth=6, rr_depth=None)
        film = render(scene, integ, spp=48, seed=1)
        img = film["primal"]
        center = img[8:16, 8:16].mean()  # interior sphere patch
        corner = img[0, 0].mean()        # background
        assert abs(corner - 1.0) < 1e-3, corner
        assert abs(center - 0.5) < 0.015, center


class TestPathStrategies:
    @pytest.mark.parametrize("strategy", ["bsdf", "emitter"])
    def test_strategies_agree_with_all(self, strategy):
        spp = 48
        ref = _mean(render(CBOX, IntegratorPathTracing(max_depth=3), spp=spp, seed=0))
        alt = _mean(render(CBOX, IntegratorPathTracing(max_depth=3, strategy=strategy),
                           spp=spp * 2, seed=7))
        assert abs(alt - ref) / ref < 0.08, (strategy, alt, ref)

    def test_naive_strategy_is_bsdf_is_oracle(self):
        """STRATEGY_NAIVE (reference naive.rs) samples cosine-hemisphere with
        no BSDF IS — any disagreement with the IS'd strategies flags a broken
        sample/pdf pair."""
        spp = 48
        ref = _mean(render(CBOX, IntegratorPathTracing(max_depth=3), spp=spp,
                           seed=0))
        nv = _mean(render(CBOX, IntegratorPathTracing(max_depth=3,
                                                      strategy="naive"),
                          spp=spp * 4, seed=13))
        assert abs(nv - ref) / ref < 0.08, (nv, ref)

    def test_naive_strategy_on_glossy(self):
        """Phong glossy lobe: naive cosine sampling must converge to the
        BSDF-IS estimate (sample/eval/pdf consistency beyond diffuse)."""
        from rustlight_tpu.scene import Scene, make_camera, look_at, make_quad
        from rustlight_tpu.models import cornell_box as _cb
        from rustlight_tpu import bsdfs
        sc = cornell_box(32, 32)
        # make the floor glossy
        glossy = sc.add_material(bsdfs.phong((0.3, 0.3, 0.3),
                                             (0.4, 0.4, 0.4), 30.0))
        sc.meshes[0].material = glossy
        sd = sc.compile()
        ref = _mean(render(sd, IntegratorPathTracing(max_depth=3,
                                                     strategy="bsdf"),
                           spp=192, seed=0))
        nv = _mean(render(sd, IntegratorPathTracing(max_depth=3,
                                                    strategy="naive"),
                          spp=192, seed=13))
        assert abs(nv - ref) / ref < 0.08, (nv, ref)

    def test_direct_matches_depth2_path(self):
        spp = 64
        d = _mean(render(CBOX, IntegratorDirect(), spp=spp, seed=3))
        p = _mean(render(CBOX, IntegratorPathTracing(max_depth=2), spp=spp, seed=11))
        assert abs(d - p) / p < 0.06, (d, p)

    def test_min_depth_splits_energy(self):
        spp = 32
        full = _mean(render(CBOX, IntegratorPathTracing(max_depth=4), spp=spp, seed=0))
        early = _mean(render(CBOX, IntegratorPathTracing(max_depth=2), spp=spp, seed=0))
        late = _mean(render(CBOX, IntegratorPathTracing(min_depth=2, max_depth=4),
                            spp=spp, seed=0))
        assert abs((early + late) - full) / full < 0.05, (early, late, full)

    def test_deterministic_given_seed(self):
        a = render(CBOX, IntegratorPathTracing(max_depth=3), spp=4, seed=5)["primal"]
        b = render(CBOX, IntegratorPathTracing(max_depth=3), spp=4, seed=5)["primal"]
        np.testing.assert_array_equal(a, b)


class TestVarianceAOV:
    def test_mean_variance_buffers(self):
        """`variance=True` emits mean/variance AOVs (reference
        BufferCollection, mod.rs:102-135): mean == primal, variance shrinks
        like 1/spp between runs and is ~0 for a deterministic integrand."""
        film = render(CBOX, IntegratorPathTracing(max_depth=3), spp=16,
                      seed=0, variance=True)
        assert set(film.buffers) >= {"primal", "mean", "variance"}
        np.testing.assert_array_equal(film["mean"], film["primal"])
        v = film["variance"]
        assert (v >= 0).all() and np.isfinite(v).all()
        assert v.mean() > 0.0   # path tracing is noisy
        # emission-only render of the light pixels is deterministic
        f2 = render(CBOX, IntegratorPathTracing(max_depth=1, hard_cap=1,
                                                rr_depth=None),
                    spp=8, seed=0, variance=True)
        # the brightest pixel sits fully inside the light: every sample
        # returns exactly Le, so its variance is 0
        flat = f2["primal"].sum(-1).ravel()
        i = int(flat.argmax())
        # (tolerance covers f32 cancellation in sumsq - n*mean^2; genuine
        # noise on an Le ~ 20 pixel would be O(1))
        assert float(f2["variance"].reshape(-1, 3)[i].max()) < 1e-3


class TestAO:
    def test_ao_range_and_shadowing(self):
        film = render(CBOX, IntegratorAO(), spp=16, seed=2)
        img = film["primal"]
        assert img.min() >= 0.0 and img.max() <= 1.0
        # open floor areas should be much less occluded than box corners
        assert img[24, 24].mean() >= 0.0


class TestSharded:
    def test_sharded_matches_single_device_mean(self):
        from rustlight_tpu.parallel import make_device_mesh, render_sharded
        mesh = make_device_mesh(8)
        film_s = render_sharded(CBOX, IntegratorPathTracing(max_depth=3), spp=32,
                                mesh=mesh, seed=0)
        film_1 = render(CBOX, IntegratorPathTracing(max_depth=3), spp=32, seed=0)
        ms, m1 = film_s["primal"].mean(), film_1["primal"].mean()
        assert abs(ms - m1) / m1 < 0.05, (ms, m1)

    def test_sharded_persistent_matches(self):
        from rustlight_tpu.parallel import make_device_mesh, render_sharded
        mesh = make_device_mesh(8)
        f1 = render_sharded(CBOX, IntegratorPathTracing(max_depth=3), spp=24,
                            mesh=mesh, seed=0, persistent=True)
        f2 = render(CBOX, IntegratorPathTracing(max_depth=3), spp=24, seed=0)
        m1, m2 = f1["primal"].mean(), f2["primal"].mean()
        assert abs(m1 - m2) / m2 < 0.08, (m1, m2)

    def test_dryrun_multichip(self):
        import sys
        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as ge
        ge.dryrun_multichip(8)


class TestEmissionTypes:
    """EmissionType::{HSV,Texture} (reference geometry.rs:99-104, 184-206):
    uv-dependent emission must stay consistent between forward (path, NEE +
    hit eval) and adjoint (light tracing, position sampling) estimators."""

    @pytest.mark.parametrize("kind", [1, 2])
    def test_forward_adjoint_agree(self, kind):
        from rustlight_tpu.models import cornell_box
        from rustlight_tpu.integrators import IntegratorLightTracing
        from rustlight_tpu.integrators.common import render_splat
        sc = cornell_box(24, 24)
        for m in sc.meshes:
            if m.is_light:
                m.emission_kind = kind
                m.emission_scale = 15.0
                m.emission_tex = 0
        if kind == 2:
            yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
            sc.textures = np.stack([xx, yy, 0.5 * (1 - xx)], -1)[None]
        sd = sc.compile()
        f1 = render(sd, IntegratorPathTracing(max_depth=4, hard_cap=4),
                    spp=48, seed=0)["primal"]
        f2 = render_splat(sd, IntegratorLightTracing(max_depth=4, hard_cap=4),
                          spp=64, seed=1)["primal"]
        m1, m2 = float(np.asarray(f1).mean()), float(np.asarray(f2).mean())
        assert abs(m1 - m2) / m1 < 0.12, (m1, m2)
        if kind == 1:   # HSV ramp has no blue component
            assert float(np.asarray(f1)[..., 2].max()) == 0.0


class TestPointNormalEmitter:
    """PointNormalEmitter (emitter.rs:252-298): cosine point emitter must
    agree between NEE (implemented; the reference leaves it todo!()) and
    the adjoint position/direction sampling."""

    def test_forward_adjoint_agree(self):
        from rustlight_tpu.scene import Scene, make_camera, look_at, make_quad
        from rustlight_tpu import bsdfs
        from rustlight_tpu.integrators import IntegratorLightTracing
        from rustlight_tpu.integrators.common import render_splat
        sc = Scene()
        m = sc.add_material(bsdfs.diffuse((0.6, 0.6, 0.6)))
        sc.add_mesh(make_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5),
                              material=m))
        sc.add_mesh(make_quad((-5, 6, -5), (-5, 6, 5), (5, 6, 5), (5, 6, -5),
                              material=m))
        sc.point_normal_lights.append(
            ((0.0, 4.0, 0.0), (0.0, -1.0, 0.0), (30.0, 20.0, 10.0)))
        sc.camera = make_camera(24, 24, fov=70.0,
                                to_world=look_at((0, 3, -7), (0, 1, 0),
                                                 (0, 1, 0)))
        sd = sc.compile()
        f1 = render(sd, IntegratorPathTracing(max_depth=4, hard_cap=4),
                    spp=32, seed=0)["primal"]
        f2 = render_splat(sd, IntegratorLightTracing(max_depth=4, hard_cap=4),
                          spp=48, seed=1)["primal"]
        m1, m2 = float(np.asarray(f1).mean()), float(np.asarray(f2).mean())
        assert abs(m1 - m2) / m1 < 0.1, (m1, m2)


class TestPersistentWavefront:
    """Pixel-pinned persistent-wavefront loop (compute_block) must agree
    with the pass-chunked render — same estimator, different scheduling."""

    def test_block_matches_chunked(self):
        f1 = render(CBOX, IntegratorPathTracing(max_depth=4, hard_cap=4),
                    spp=24, seed=3, persistent=True)
        f2 = render(CBOX, IntegratorPathTracing(max_depth=4, hard_cap=4),
                    spp=24, seed=3, persistent=False)
        m1, m2 = f1["primal"].mean(), f2["primal"].mean()
        assert abs(m1 - m2) / m2 < 0.05, (m1, m2)

    def test_block_respawn_completes_all_samples(self):
        import jax.numpy as jnp
        from rustlight_tpu.integrators.common import _pixel_grid
        from rustlight_tpu.utils.rng import make_stream
        integ = IntegratorPathTracing(max_depth=3, hard_cap=3)
        pix = jnp.asarray(_pixel_grid(16, 16))
        acc = integ.compute_block(CBOX, pix, make_stream(0), 8)
        assert np.all(np.isfinite(np.asarray(acc)))


class TestVeachMIS:
    """Veach MIS grid (models/veach.py): emitter-only and bsdf-only
    strategies must converge to the same image mean; `all` (MIS) agrees
    within its (heavy-tailed) variance."""

    def test_strategies_consistent(self):
        from rustlight_tpu.models import veach_mis
        sd = veach_mis(48, 36).compile()
        pt = lambda s: IntegratorPathTracing(max_depth=2, hard_cap=2,
                                             strategy=s)
        em = render(sd, pt("emitter"), spp=1024, seed=1)["primal"].mean()
        bs = render(sd, pt("bsdf"), spp=2048, seed=1)["primal"].mean()
        assert abs(em - bs) / em < 0.06, (em, bs)
        al = render(sd, pt("all"), spp=128, seed=3)["primal"].mean()
        assert abs(al - em) / em < 0.2, (al, em)


class TestSceneAsArgument:
    """Huge scenes flip from scene-as-HLO-constants to scene-as-jit-argument
    (common._scene_as_arg), so multi-GB tables never become HLO
    constants. Both modes must render bit-identically."""

    def _both(self, run, monkeypatch):
        from rustlight_tpu.integrators import common
        common._BLOCK_CACHE.clear()
        a = run()   # constant mode (cbox is far below the threshold)
        monkeypatch.setattr(common, "_ARG_SCENE_MB", 0.0)
        common._BLOCK_CACHE.clear()
        common._DEVICE_SCENE_CACHE.clear()
        b = run()   # argument mode
        common._BLOCK_CACHE.clear()
        return np.asarray(a), np.asarray(b)

    def test_chunked_bit_identical(self, monkeypatch):
        run = lambda: render(CBOX, IntegratorPathTracing(max_depth=3),
                             spp=4, seed=5, persistent=False)["primal"]
        a, b = self._both(run, monkeypatch)
        assert np.array_equal(a, b)

    def test_persistent_bit_identical(self, monkeypatch):
        run = lambda: render(CBOX, IntegratorPathTracing(max_depth=3),
                             spp=4, seed=5, persistent=True)["primal"]
        a, b = self._both(run, monkeypatch)
        assert np.array_equal(a, b)

    def test_splat_bit_identical(self, monkeypatch):
        from rustlight_tpu.integrators import IntegratorLightTracing
        from rustlight_tpu.integrators.common import render_splat
        run = lambda: render_splat(CBOX, IntegratorLightTracing(max_depth=3),
                                   spp=4, seed=5)["primal"]
        a, b = self._both(run, monkeypatch)
        assert np.array_equal(a, b)


class TestAdaptiveSampling:
    """render_adaptive (beyond-reference): variance-guided per-pixel budget."""

    def test_matches_uniform_mean_and_spends_budget(self):
        import numpy as np
        from rustlight_tpu.models import cornell_box
        from rustlight_tpu.integrators import IntegratorPathTracing
        from rustlight_tpu.integrators.common import render, render_adaptive
        sd = cornell_box(24, 24).compile()
        integ = IntegratorPathTracing(max_depth=3, hard_cap=3)
        ref = render(sd, integ, spp=96, seed=3,
                     persistent=False).buffers["primal"]
        ada = render_adaptive(sd, integ, spp=24, seed=5)
        spp_map = ada.buffers["spp"][..., 0]
        # exact budget: same total samples as a uniform 24-spp render
        assert int(spp_map.sum()) == 24 * 24 * 24
        # allocation is genuinely non-uniform (noisy pixels got more)
        assert spp_map.max() > spp_map.min()
        # unbiasedness: agrees with a high-spp uniform reference
        a, b = ada.buffers["primal"].mean(), ref.mean()
        assert abs(a - b) / b < 0.05, (a, b)


class TestFeatureAOVs:
    def test_albedo_normal_depth_on_cbox(self):
        """Denoiser guide channels (beyond-reference): first-hit albedo
        matches the wall kd, normals are unit and face the camera, depth is
        positive everywhere (cbox encloses the camera's view)."""
        import jax.numpy as jnp
        from rustlight_tpu.models import cornell_box
        from rustlight_tpu.integrators.common import render_feature_aovs
        from rustlight_tpu.scene import generate_rays
        sd = cornell_box(24, 24).compile()
        a = render_feature_aovs(sd, spp=8, seed=0)
        assert set(a) == {"albedo", "normal", "depth"}
        for v in a.values():
            assert v.shape == (24, 24, 3) and np.isfinite(v).all()
        assert (a["albedo"] >= 0).all() and (a["albedo"] <= 1).all()
        assert (a["depth"] > 0).all()          # every view ray hits the box
        # interior pixel (away from silhouettes): unit normal facing the ray
        nc = a["normal"][12, 12]
        # averaged over jittered sub-pixel samples: near-unit, not exact
        assert abs(np.linalg.norm(nc) - 1.0) < 2e-2
        o, d = generate_rays(sd.camera, jnp.asarray([[12.5, 12.5]]))
        assert float(np.dot(nc, np.asarray(d)[0])) < 0.0
        # the ceiling light reports albedo 1 (denoiser convention); at 48^2
        # with unjittered-enough sampling some pixels sit fully inside it
        b = render_feature_aovs(cornell_box(48, 48).compile(), spp=1, seed=0)
        frac_one = (b["albedo"] == 1.0).all(-1).mean()
        assert 0.0 < frac_one < 0.3             # light occupies a small area

    def test_feature_aovs_deterministic(self):
        from rustlight_tpu.models import cornell_box
        from rustlight_tpu.integrators.common import render_feature_aovs
        sd = cornell_box(12, 12).compile()
        a = render_feature_aovs(sd, spp=2, seed=3)
        b = render_feature_aovs(sd, spp=2, seed=3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


class TestAdaptiveBudgetExact:
    def test_non_multiple_pilot_budget(self):
        """spp=44 -> pilot=11: the pilot must render EXACTLY 11 spp (one
        exact-size chunk), not round up to the chunk size — the spp AOV
        accounts for every sample and the total equals spp * n_pix."""
        from rustlight_tpu.models import cornell_box
        from rustlight_tpu.integrators.common import render_adaptive
        from rustlight_tpu.integrators import IntegratorPathTracing
        sd = cornell_box(10, 10).compile()
        integ = IntegratorPathTracing(max_depth=2, hard_cap=2)
        f = render_adaptive(sd, integ, 44, seed=0)
        assert int(np.asarray(f.buffers["spp"])[..., 0].sum()) == 44 * 100
        assert int(np.asarray(f.buffers["spp"]).min()) >= 11


def test_block_unbounded_depth_truncates_like_hard_cap():
    """max_depth=None in the persistent wavefront must cap each LANE at
    hard_cap bounces (banking the partial path sum) — not rely on the
    global it_cap, which silently drops in-flight radiance while the film
    still divides by full spp (a darkening bias in the rr_depth=None +
    unbounded-depth corner; reference paths always terminate by RR,
    strategies/directional.rs:77-87). With the cap, an unbounded-depth
    render is EXACTLY an explicit max_depth=hard_cap render."""
    sd = cornell_box(24, 24).compile()
    f_none = render(sd, IntegratorPathTracing(max_depth=None, rr_depth=None,
                                              hard_cap=6), 4, seed=3,
                    persistent=True)
    f_expl = render(sd, IntegratorPathTracing(max_depth=6, rr_depth=None,
                                              hard_cap=6), 4, seed=3,
                    persistent=True)
    a = np.asarray(f_none["primal"])
    b = np.asarray(f_expl["primal"])
    assert np.array_equal(a, b)
    assert a.mean() > 0.0
