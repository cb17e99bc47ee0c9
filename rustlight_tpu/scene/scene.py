"""Scene container: host-side description -> one device pytree.

The reference `Scene` (src/scene.rs:16-131) owns meshes/camera/emitters/volume
and `build_emitters()` wires the sampling structures. Here `Scene.compile()`
flattens everything into `SceneData` — a single pytree of dense arrays that
every integrator JIT-closes over. No object graph survives on device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils import pytree
from ..bsdfs import MaterialDesc, MaterialTable, build_material_table
from ..ops.gather import make_taker, table_take
from ..utils.frame import make_frame, to_local
from .camera import Camera
from .emitters import EmitterTables, build_emitter_tables
from .geometry import GeometryTables, TriMesh, build_geometry_tables, scene_bounds
from .volume import HomogeneousVolume


class HostMirror:
    """Identity-hashable container for the numpy copy of a compiled scene.

    Host-side consumers (BVH builder, ATS, plane_single's light extraction)
    read from here instead of reading device arrays back, so the host copy
    survives next to the device pytree."""

    def __init__(self, data):
        self.data = data

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@pytree.dataclass
class SceneData:
    camera: Camera
    geom: GeometryTables
    materials: MaterialTable
    emitters: EmitterTables
    volume: Optional[HomogeneousVolume]
    ats: Optional[Any] = None   # AtsTables when built with use_ats
    host: Optional[HostMirror] = pytree.field(static=True, default=None)
    # -x no-shading: ignore interpolated vertex normals (reference cli.rs
    # xtra option; scene_loader strips normals in that case)
    use_shading_normals: bool = pytree.field(static=True, default=True)


@dataclass
class Scene:
    """Host-side scene under construction."""
    camera: Camera = None
    meshes: List[TriMesh] = field(default_factory=list)
    materials: List[MaterialDesc] = field(default_factory=list)
    point_lights: List[Tuple] = field(default_factory=list)        # (pos, intensity)
    directional_lights: List[Tuple] = field(default_factory=list)  # (dir, intensity)
    point_normal_lights: List[Tuple] = field(default_factory=list)  # (pos, normal, intensity)
    env_constant: Optional[np.ndarray] = None
    env_image: Optional[np.ndarray] = None
    textures: Optional[np.ndarray] = None
    volume: Optional[HomogeneousVolume] = None

    def add_material(self, desc: MaterialDesc) -> int:
        self.materials.append(desc)
        return len(self.materials) - 1

    def add_mesh(self, mesh: TriMesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def compile(self, use_ats: bool = False,
                use_shading_normals: bool = True) -> SceneData:
        if not self.materials:
            self.materials = [MaterialDesc()]
        # emitter ids per mesh (dense numbering over emissive meshes)
        mesh_emitter_id, next_id = [], 0
        for m in self.meshes:
            if m.is_light:
                mesh_emitter_id.append(next_id)
                next_id += 1
            else:
                mesh_emitter_id.append(-1)

        geom = build_geometry_tables(self.meshes, mesh_emitter_id)
        _, _, center, radius = scene_bounds(self.meshes)
        # reference includes the camera position in the scene bounds
        if self.camera is not None:
            cam_p = np.asarray(self.camera.position)
            radius = max(radius, float(np.linalg.norm(cam_p - center)))
        emitters = build_emitter_tables(
            self.meshes, mesh_emitter_id, geom.n_pad,
            points=self.point_lights,
            directionals=self.directional_lights,
            point_normals=self.point_normal_lights,
            env_constant=self.env_constant,
            env_image=self.env_image,
            bsphere_center=center, bsphere_radius=radius,
            textures=self.textures,
        )
        # widen the fused per-tri attribute rows with the emission columns
        # (A_LE..A_EMTEX) so one gather serves hit fill, Le and NEE-pdf reads
        geom = geom.replace(attr=np.concatenate([
            geom.attr,
            emitters.tri_emission,
            emitters.tri_pdf_area[:, None],
            emitters.tri_em_kind[:, None].astype(np.float32),
            emitters.tri_em_scale[:, None],
            emitters.tri_em_tex[:, None].astype(np.float32),
        ], axis=1).astype(np.float32))
        materials = build_material_table(self.materials, textures=self.textures)
        ats = None
        if use_ats:
            from .ats import build_ats
            ats = build_ats(geom, emitters)
        host_sd = SceneData(camera=self.camera, geom=geom, materials=materials,
                            emitters=emitters, volume=self.volume, ats=ats,
                            use_shading_normals=use_shading_normals)
        # single upload; numpy mirror kept for host-side builders (no readbacks)
        import jax
        device_sd = jax.device_put(host_sd)
        return device_sd.replace(host=HostMirror(host_sd))


class Hit(NamedTuple):
    """Wavefront intersection record (reference Intersection,
    src/structure.rs:931-1060), SoA over lanes."""
    valid: Any   # [n] bool
    t: Any       # [n]
    tri: Any     # [n] int32
    p: Any       # [n, 3]
    n_g: Any     # [n, 3] geometric normal (possibly flipped two-sided)
    n_s: Any     # [n, 3] shading normal
    uv: Any      # [n, 2]
    frame: Any   # (t, b, n) shading frame
    wi: Any      # [n, 3] local incoming (toward previous vertex)
    mat: Any     # [n] int32 material id
    is_light: Any  # [n] bool
    # fused attribute rows [n, N_ATTR] gathered once for these lanes —
    # downstream emission/pdf reads (emitted_radiance, direct_pdf_tri) slice
    # this instead of re-gathering the big tables; None on scenes compiled
    # without emitter columns
    attr: Any = None


def fill_hit(scene: SceneData, o, d, rh,
             use_shading_normals: Optional[bool] = None) -> Hit:
    """Build the full intersection record from a RayHit.

    Mirrors fill_intersection (src/structure.rs:965-1059): barycentric
    normal/uv interpolation, shading-normal alignment with n_g, two-sided flip
    for non-light two-sided materials.
    """
    from ..ops.gather import MAX_ONEHOT_ROWS
    from .geometry import (
        A_NG, A_VN, A_VUV, A_HASN, A_MAT, A_EID, N_ATTR)
    g = scene.geom
    if use_shading_normals is None:
        use_shading_normals = scene.use_shading_normals
    tri = jnp.maximum(rh.tri, 0)
    b0 = 1.0 - rh.u - rh.v

    take = make_taker(tri, g.n_pad)
    # Above the one-hot threshold every take re-scans the whole table in
    # 4096-row chunks, so ONE fused gather of all columns wins big; below
    # it, per-column takes sharing the one-hot measure ~20% faster on the
    # cbox bench (narrow lane-0-aligned matmul outputs fuse better than a
    # wide row + lane-shifted slices).
    fused = g.n_pad > MAX_ONEHOT_ROWS
    if fused:
        a = take(g.attr)              # ONE fused gather for every column
        nl = a.shape[0]
        n_g = a[:, A_NG]
        vn = a[:, A_VN].reshape(nl, 3, 3)
        has_n = (a[:, A_HASN] > 0.5) & use_shading_normals
    else:
        a = None
        n_g = take(g.n_g)
        vn = take(g.vn)
        has_n = take(g.has_normals) & use_shading_normals
    n_s_raw = (vn[:, 0] * b0[:, None] + vn[:, 1] * rh.u[:, None]
               + vn[:, 2] * rh.v[:, None])
    # flip n_g toward interpolated shading normal
    flip_g = jnp.sum(n_g * n_s_raw, axis=-1) < 0.0
    n_g = jnp.where((has_n & flip_g)[:, None], -n_g, n_g)
    l2 = jnp.sum(n_s_raw * n_s_raw, axis=-1, keepdims=True)
    n_s = jnp.where(l2 > 0.0, n_s_raw / jnp.sqrt(jnp.maximum(l2, 1e-30)), n_g)
    n_s = jnp.where(has_n[:, None], n_s, n_g)

    if fused:
        vuv = a[:, A_VUV].reshape(nl, 3, 2)
        mat = jnp.round(a[:, A_MAT]).astype(jnp.int32)
        is_light = jnp.round(a[:, A_EID]).astype(jnp.int32) >= 0
    else:
        vuv = take(g.vuv)
        mat = take(g.mat_id)
        is_light = take(g.emitter_id) >= 0
    uv = (vuv[:, 0] * b0[:, None] + vuv[:, 1] * rh.u[:, None]
          + vuv[:, 2] * rh.v[:, None])
    two_sided = table_take(scene.materials.two_sided, mat)
    backface = jnp.sum(d * n_s, axis=-1) > 0.0
    do_flip = two_sided & (~is_light) & backface
    n_s = jnp.where(do_flip[:, None], -n_s, n_s)
    n_g = jnp.where(do_flip[:, None], -n_g, n_g)

    p = o + d * rh.t[:, None]
    frame = make_frame(n_s)
    wi = to_local(frame, -d)
    return Hit(valid=rh.hit, t=rh.t, tri=rh.tri, p=p, n_g=n_g, n_s=n_s, uv=uv,
               frame=frame, wi=wi, mat=mat, is_light=is_light,
               attr=a if (a is not None and a.shape[1] >= N_ATTR) else None)


def offset_ray_origin(p, n_g, d):
    """Self-intersection-safe ray origin: offset p along +-n_g by a
    magnitude-relative epsilon (the robust version of the reference's
    `spawn_ray` absolute-tnear hack, src/structure.rs:717-731 — an absolute
    1e-4 breaks down at Cornell-box scale in f32)."""
    scale = jnp.max(jnp.abs(p), axis=-1)
    eps = (1e-4 + 2e-5 * scale)[..., None]
    sign = jnp.where(jnp.sum(n_g * d, axis=-1) >= 0.0, 1.0, -1.0)[..., None]
    return p + n_g * eps * sign
