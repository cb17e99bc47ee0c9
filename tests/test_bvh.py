"""BVH build + traversal vs brute-force dense intersection (the reference's
NaiveAcceleration-vs-BVH oracle, SURVEY.md §4), and the large-scene tier
that routes renders through it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustlight_tpu.accel import intersect_rays
from rustlight_tpu.accel.bvh import build_bvh, intersect_bvh, _load_native
from rustlight_tpu.models import cornell_box, furnace_scene


def _random_rays(n, center, radius, seed=0):
    k = jax.random.PRNGKey(seed)
    o = center + jax.random.normal(k, (n, 3)) * radius
    d = jax.random.normal(jax.random.fold_in(k, 1), (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


class TestBVH:
    def test_native_builder_compiles(self):
        assert _load_native() is not None, "C++ BVH builder failed to compile"

    @pytest.mark.parametrize("scene_fn,center,radius", [
        (lambda: cornell_box(16, 16), (278.0, 273.0, 100.0), 200.0),
        (lambda: furnace_scene(8, 8), (0.0, 0.0, 0.0), 2.0),
    ])
    def test_matches_dense(self, scene_fn, center, radius):
        sd = scene_fn().compile()
        bvh = build_bvh(sd.geom)
        o, d = _random_rays(512, jnp.asarray(center), radius)
        ref = intersect_rays(sd.geom, o, d)
        got = intersect_bvh(bvh, o, d)
        np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
        m = np.asarray(ref.hit)
        np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                                   rtol=1e-4, atol=1e-3)
        # triangle ids must agree except for shared-edge ties
        tri_match = (np.asarray(got.tri)[m] == np.asarray(ref.tri)[m])
        assert tri_match.mean() > 0.98

    def test_sweep_builder_matches_dense(self):
        """Full sweep-SAH build (the reference's exact algorithm,
        src/accel.rs:115-199) must traverse to the same hits as the dense
        oracle and the binned build."""
        rng = np.random.RandomState(7)
        from rustlight_tpu.scene.geometry import (TriMesh,
                                                  build_geometry_tables)
        nt = 600
        c = rng.uniform(-5, 5, (nt, 3)).astype(np.float32)
        v = (c[:, None, :]
             + rng.uniform(-0.4, 0.4, (nt, 3, 3))).astype(np.float32)
        idx = np.arange(3 * nt, dtype=np.int32).reshape(nt, 3)
        geom = build_geometry_tables(
            [TriMesh(vertices=v.reshape(-1, 3), indices=idx, material=0)],
            [-1])
        o, d = _random_rays(256, jnp.zeros(3), 6.0, seed=3)
        ref = intersect_rays(geom, o, d)
        got = intersect_bvh(build_bvh(geom, builder="sweep"), o, d)
        np.testing.assert_array_equal(np.asarray(got.hit),
                                      np.asarray(ref.hit))
        m = np.asarray(ref.hit)
        np.testing.assert_allclose(np.asarray(got.t)[m],
                                   np.asarray(ref.t)[m], rtol=1e-4,
                                   atol=1e-3)

    def test_skip_links_terminate(self):
        sd = cornell_box(8, 8).compile()
        bvh = build_bvh(sd.geom, max_leaf=2)
        skips = np.asarray(bvh.skip)
        assert (skips >= -1).all() and (skips < bvh.n_nodes).all()
        # preorder skip links always point forward
        idx = np.arange(bvh.n_nodes)
        fw = skips[skips >= 0] > idx[skips >= 0]
        assert fw.all()


def _tables(meshes):
    from rustlight_tpu.scene.geometry import build_geometry_tables
    return build_geometry_tables(meshes, [-1] * len(meshes))


def _soup(nt=1500, seed=7):
    from rustlight_tpu.scene.geometry import TriMesh
    rng = np.random.RandomState(seed)
    c = rng.uniform(-5, 5, (nt, 3)).astype(np.float32)
    v = (c[:, None, :] + rng.uniform(-0.6, 0.6, (nt, 3, 3))).astype(np.float32)
    idx = np.arange(3 * nt, dtype=np.int32).reshape(nt, 3)
    return [TriMesh(vertices=v.reshape(-1, 3), indices=idx, material=0)]


def _sphere_grid():
    from rustlight_tpu.models.presets import sphere_grid_mesh
    mesh, _ = sphere_grid_mesh(2000, n_theta=10)
    mesh.vertices = mesh.vertices - 4.5      # grid centred on the origin
    return [mesh]


def _degenerate_and_duplicates():
    """A soup with zero-area triangles (two corners equal, or all three)
    and exact duplicates of real triangles, whose ties the two tiers must
    break the same way (lower triangle id)."""
    from rustlight_tpu.scene.geometry import TriMesh
    rng = np.random.RandomState(11)
    nt = 1200
    c = rng.uniform(-4, 4, (nt, 3)).astype(np.float32)
    v0, v1, v2 = (c + rng.normal(0, .3, (nt, 3)).astype(np.float32)
                  for _ in range(3))
    v1[:80] = v0[:80]                       # two identical corners
    v2[80:120] = v0[80:120] = v1[80:120]    # collapsed to a point
    verts = np.concatenate([v0, v1, v2], 0)
    idx = np.arange(3 * nt).reshape(3, nt).T.astype(np.int32)
    idx = np.concatenate([idx, idx[200:400]], 0)   # exact duplicates
    return [TriMesh(vertices=verts, indices=idx, material=0)]


def _thin_axis_aligned():
    """Axis-aligned quads and flat boxes: zero-thickness bounding boxes."""
    from rustlight_tpu.scene.geometry import make_box, make_quad
    meshes = []
    for i in range(12):
        for j in range(12):
            x, z = i - 6.0, j - 6.0
            meshes.append(make_quad((x, -1, z), (x + 0.9, -1, z),
                                    (x + 0.9, -1, z + 0.9), (x, -1, z + 0.9)))
            meshes.append(make_box((x, 0.5 * (i % 3), z),
                                   (x + 0.5, 0.5 * (i % 3), z + 0.5)))
    return meshes


SCENES = {"sphere_grid": _sphere_grid, "random_soup": _soup,
          "degenerate_duplicate": _degenerate_and_duplicates,
          "thin_axis_aligned": _thin_axis_aligned}


def _with_and_without_bvh(name):
    geom = _tables(SCENES[name]())
    assert geom.bvh is not None, "test scene must sit above BVH_THRESHOLD"
    return geom, geom.replace(bvh=None)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_closest_hit_matches_dense(name):
    from rustlight_tpu.accel.bvh import intersect_bvh
    geom, dense = _with_and_without_bvh(name)
    o, d = _random_rays(2048, jnp.zeros(3), 4.0, seed=11)
    ref = intersect_rays(dense, o, d)
    got = intersect_bvh(geom.bvh, o, d)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    assert m.mean() > 0.1
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
    np.testing.assert_allclose(np.asarray(got.u)[m], np.asarray(ref.u)[m],
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_any_hit_matches_dense(name):
    from rustlight_tpu.accel.bvh import occluded_bvh
    from rustlight_tpu.accel.dense import occluded_rays
    geom, dense = _with_and_without_bvh(name)
    o, d = _random_rays(2048, jnp.zeros(3), 4.0, seed=12)
    n = o.shape[0]
    tnear = jnp.full(n, 1e-4)
    tfar = jnp.asarray(np.random.RandomState(1).uniform(0.0, 6.0, n),
                       jnp.float32)
    ref = np.asarray(occluded_rays(dense, o, d, tnear, tfar))
    assert 0.05 < ref.mean() < 0.95
    np.testing.assert_array_equal(
        np.asarray(occluded_bvh(geom.bvh, o, d, tnear, tfar)), ref)
    # the dispatch picks the walk for scenes that carry BVH tables
    np.testing.assert_array_equal(
        np.asarray(occluded_rays(geom, o, d, tnear, tfar)), ref)


@pytest.mark.parametrize("n", [1, 37, 1001])
def test_walk_bounded_tfar_inert_lanes_and_odd_counts(n):
    """Bounded tfar clips hits beyond it; tfar = 0 lanes (inert shadow
    rays) never hit; any ray count works (no padding contract)."""
    from rustlight_tpu.accel.bvh import intersect_bvh, occluded_bvh
    geom, dense = _with_and_without_bvh("sphere_grid")
    o, d = _random_rays(n, jnp.zeros(3), 4.0, seed=n)
    tnear = jnp.full(n, 1e-4)
    rng = np.random.RandomState(n)
    tfar = np.asarray(rng.uniform(0.0, 5.0, n), np.float32)
    tfar[::3] = 0.0
    tfar = jnp.asarray(tfar)
    ref = intersect_rays(dense, o, d, tnear, tfar)
    got = intersect_bvh(geom.bvh, o, d, tnear, tfar)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
    hit = np.asarray(got.hit)
    assert not hit[::3].any()
    assert (np.asarray(got.t)[hit] < np.asarray(tfar)[hit]).all()
    occ = np.asarray(occluded_bvh(geom.bvh, o, d, tnear, tfar))
    np.testing.assert_array_equal(occ, hit)
    assert got.t.shape == (n,) and occ.shape == (n,)


def _spheres_scene(width=16):
    """~1.6k triangles (above BVH_THRESHOLD) under one area light."""
    from rustlight_tpu.scene import (Scene, make_camera, look_at,
                                     make_sphere, make_quad)
    from rustlight_tpu import bsdfs as B
    sc = Scene()
    m = sc.add_material(B.diffuse((0.7,) * 3))
    rng = np.random.RandomState(0)
    for _ in range(16):
        c = rng.uniform(-8, 8, 3)
        c[1] = abs(c[1]) + 0.5
        sc.add_mesh(make_sphere(c, 0.9, material=m, n_theta=8, n_phi=7))
    sc.add_mesh(make_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20),
                          (-20, 0, 20), material=m))
    sc.add_mesh(make_quad((-3, 18, -3), (3, 18, -3), (3, 18, 3),
                          (-3, 18, 3), material=m, emission=(30,) * 3))
    sc.camera = make_camera(width, width, fov=60.0,
                            to_world=look_at((0, 8, -25), (0, 4, 0),
                                             (0, 1, 0)))
    return sc


@pytest.mark.parametrize("integrator", ["path", "ao"])
def test_render_above_threshold_equals_dense_forced(integrator, monkeypatch):
    """render() of a scene above the threshold (BVH walk) equals the same
    render with the threshold raised (dense scan)."""
    import rustlight_tpu.scene.geometry as G
    from rustlight_tpu.integrators import (IntegratorAO,
                                           IntegratorPathTracing, render)
    integ = (IntegratorPathTracing(max_depth=2, hard_cap=2)
             if integrator == "path" else IntegratorAO(max_distance=5.0))
    sc = _spheres_scene(12)
    sd = sc.compile()
    assert sd.geom.bvh is not None
    f1 = np.asarray(render(sd, integ, spp=4, seed=0)["primal"])
    monkeypatch.setattr(G, "BVH_THRESHOLD", 10 ** 9)
    sd2 = sc.compile()
    assert sd2.geom.bvh is None
    f2 = np.asarray(render(sd2, integ, spp=4, seed=0)["primal"])
    assert f1.mean() > 0.0
    np.testing.assert_allclose(f1, f2, atol=1e-5)


@pytest.mark.parametrize("persistent", [False, True])
def test_scene_as_argument_with_bvh_tables(persistent, monkeypatch):
    """A BVH-tier scene renders the same (to rounding: XLA folds constants)
    whether its tables, BVH included, are closed over or enter the jit as
    arguments."""
    from rustlight_tpu.integrators import IntegratorPathTracing, render
    from rustlight_tpu.integrators import common
    sd = _spheres_scene(8).compile()
    nbytes_bvh = sum(x.nbytes for x in jax.tree_util.tree_leaves(
        sd.geom.bvh))
    assert common._scene_nbytes(sd) > nbytes_bvh > 0

    def run():
        common._BLOCK_CACHE.clear()
        common._DEVICE_SCENE_CACHE.clear()
        return np.asarray(render(sd, IntegratorPathTracing(max_depth=2),
                                 spp=1, seed=4,
                                 persistent=persistent)["primal"])
    a = run()
    monkeypatch.setattr(common, "_ARG_SCENE_MB", 0.0)
    assert common._scene_as_arg(sd)
    b = run()
    common._BLOCK_CACHE.clear()
    assert a.mean() > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("builder", ["binned", "sweep"])
def test_bvh_build_invariants(builder):
    """Every triangle sits in exactly one leaf; boxes contain their
    primitives and children; skip links point forward in preorder."""
    geom = _tables(_soup(900, seed=2))
    bvh = build_bvh(geom, max_leaf=4, builder=builder)
    lo, hi = np.asarray(bvh.bbox_lo), np.asarray(bvh.bbox_hi)
    skip = np.asarray(bvh.skip)
    start, cnt = np.asarray(bvh.prim_start), np.asarray(bvh.prim_count)
    order = np.asarray(bvh.prim_index)
    v0 = np.asarray(geom.v0)[: geom.n_tris]
    p1 = v0 + np.asarray(geom.e1)[: geom.n_tris]
    p2 = v0 + np.asarray(geom.e2)[: geom.n_tris]
    tlo = np.minimum(np.minimum(v0, p1), p2)
    thi = np.maximum(np.maximum(v0, p1), p2)
    seen = np.zeros(geom.n_tris, int)
    for i in range(bvh.n_nodes):
        assert skip[i] == -1 or skip[i] > i
        if cnt[i] > 0:
            assert cnt[i] <= 4
            ids = order[start[i]: start[i] + cnt[i]]
            seen[ids] += 1
            assert (tlo[ids] >= lo[i] - 1e-6).all()
            assert (thi[ids] <= hi[i] + 1e-6).all()
        else:   # inner node: the left child follows, contained in the box
            assert (lo[i + 1] >= lo[i] - 1e-6).all()
            assert (hi[i + 1] <= hi[i] + 1e-6).all()
    assert (seen == 1).all()
    assert (order[geom.n_tris:] == -1).all()       # the padded tail
    rows = np.asarray(bvh.rows).reshape(-1, 3, 4)
    np.testing.assert_array_equal(
        rows[: geom.n_tris], np.asarray(geom.inter_rows)[order[:geom.n_tris]])


def test_bvh_tables_attach_above_threshold_only():
    import rustlight_tpu.scene.geometry as G
    small = _tables([G.make_box((0, 0, 0), (1, 1, 1))])
    assert small.bvh is None
    big = _tables(_soup(G.BVH_THRESHOLD + 1))
    assert big.bvh is not None and big.bvh.n_nodes > 1
    assert big.n_tris == G.BVH_THRESHOLD + 1


def test_visible_mask_contract():
    """visible(mask=...): masked-off lanes shoot inert tfar=0 rays and
    report True (unoccluded); unmasked lanes are unchanged."""
    import numpy as np
    import jax.numpy as jnp
    from rustlight_tpu.scene.geometry import TriMesh, build_geometry_tables
    from rustlight_tpu.accel import visible

    # one big triangle at z=1 blocking the segment (0,0,0) -> (0,0,2)
    verts = np.asarray([[-5, -5, 1], [5, -5, 1], [0, 5, 1]], np.float32)
    idx = np.asarray([[0, 1, 2]], np.int32)
    geom = build_geometry_tables([TriMesh(vertices=verts, indices=idx,
                                          material=0)], [-1])
    p0 = jnp.zeros((4, 3), jnp.float32)
    p1 = jnp.tile(jnp.asarray([[0.0, 0.0, 2.0]]), (4, 1))
    mask = jnp.asarray([True, False, True, False])
    vis_masked = np.asarray(visible(geom, p0, p1, mask=mask))
    vis_plain = np.asarray(visible(geom, p0, p1))
    assert not vis_plain.any()                       # all blocked
    assert (vis_masked == np.asarray([False, True, False, True])).all()
