"""Triangle meshes and their flattened device tables.

Host side: `TriMesh` — indexed triangles + material/emission, the analogue of
the reference `Mesh` (src/geometry.rs:107-458). Device side: `GeometryTables` —
one flat SoA over *all* scene triangles, padded to a multiple of TRI_PAD,
with precomputed plane/barycentric rows so that ray-triangle intersection
becomes two `[N,4] x [4,3T]` matrix products (see accel/dense.py). There is
no per-mesh object on device; meshes survive as per-triangle id columns.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import jax.numpy as jnp
import numpy as np

from ..utils import pytree

# Triangle-count padding quantum. Dense trace cost tracks the padded count,
# and renders are bitwise identical across pad sizes, so pad finely. Not yet
# tuned on the H100.
TRI_PAD = 8

# above this triangle count intersection leaves the dense scan for the BVH
# walk (accel/bvh.py). On an H100 (700 W limit), path 256^2 8 spp depth 5
# on sphere grids: dense wins at 898 triangles (81 vs 118 ms), the walk at
# 1442 (183 vs 217 ms); the crossover lies between.
BVH_THRESHOLD = 1024

# Fused per-triangle attribute row (GeometryTables.attr): every per-tri
# quantity the hot paths read, in ONE f32 table, so a wavefront hit fetch is
# a single one-hot gather (make_taker) instead of one scan per column —
# at >4096 triangles each separate take re-scans every 4096-row chunk.
# Ints/bools ride as exact small f32. Columns 0:N_ATTR_GEOM are built by
# build_geometry_tables; Scene.compile appends the emission columns
# (A_LE..A_EMTEX) once the emitter tables exist.
A_V0 = slice(0, 3)
A_E1 = slice(3, 6)
A_E2 = slice(6, 9)
A_NG = slice(9, 12)
A_AREA = 12
A_VN = slice(13, 22)      # 3 corners x 3
A_VUV = slice(22, 28)     # 3 corners x 2
A_HASN = 28
A_MAT = 29
A_EID = 30
N_ATTR_GEOM = 31
A_LE = slice(31, 34)      # em.tri_emission
A_PDFA = 34               # em.tri_pdf_area
A_EMKIND = 35             # em.tri_em_kind
A_EMSCALE = 36            # em.tri_em_scale
A_EMTEX = 37              # em.tri_em_tex
N_ATTR = 38


@dataclass
class TriMesh:
    """Host-side indexed triangle mesh."""
    vertices: np.ndarray            # [v, 3] f32
    indices: np.ndarray             # [t, 3] int32
    normals: Optional[np.ndarray] = None   # [v, 3]
    uvs: Optional[np.ndarray] = None       # [v, 2]
    material: int = 0               # index into the scene material list
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    name: str = ""
    # EmissionType::{Color,HSV,Texture} (reference geometry.rs:99-104):
    # 0 = constant color `emission`, 1 = HSV ramp over u, 2 = texture atlas slot
    emission_kind: int = 0
    emission_scale: float = 1.0
    emission_tex: int = -1          # index into the scene texture atlas

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32)
        self.indices = np.asarray(self.indices, np.int32)
        self.emission = np.asarray(self.emission, np.float32)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32)
        if self.uvs is not None:
            self.uvs = np.asarray(self.uvs, np.float32)

    @property
    def n_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def is_light(self) -> bool:
        if self.emission_kind != 0:
            return self.emission_scale > 0.0
        return bool(np.any(self.emission > 0.0))

    def mean_emission(self, textures=None) -> np.ndarray:
        """Representative Le for flux/CDF weights. The reference approximates
        HSV/texture flux as Color::value(scale) (emitter.rs:595-596); the
        exact uv-dependent value is applied at evaluation/sampling time."""
        if self.emission_kind == 1:      # HSV ramp: E_u[x, 1-x, 0] * scale
            return np.asarray([0.5, 0.5, 0.0], np.float32) * self.emission_scale
        if self.emission_kind == 2:
            if textures is not None and 0 <= self.emission_tex < len(textures):
                return (np.asarray(textures[self.emission_tex], np.float32)
                        .mean(axis=(0, 1)) * self.emission_scale)
            return np.full(3, self.emission_scale, np.float32)
        return self.emission

    def triangle_areas(self) -> np.ndarray:
        v = self.vertices
        i = self.indices
        e1 = v[i[:, 1]] - v[i[:, 0]]
        e2 = v[i[:, 2]] - v[i[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    def total_area(self) -> float:
        return float(self.triangle_areas().sum())

    def flux(self, textures=None) -> np.ndarray:
        """Emitter flux = area * Le * pi (reference src/emitter.rs:591-599)."""
        return self.total_area() * self.mean_emission(textures) * np.pi

    def compute_vertex_normals(self) -> None:
        """Area-weighted vertex normals (for smooth shading when absent)."""
        v, i = self.vertices, self.indices
        fn = np.cross(v[i[:, 1]] - v[i[:, 0]], v[i[:, 2]] - v[i[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, i[:, k], fn)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        self.normals = n / np.maximum(norm, 1e-20)


@pytree.dataclass
class GeometryTables:
    """Flat per-triangle SoA (padded to TRI_PAD). Pad rows are degenerate."""
    n_tris: int = pytree.field(static=True)       # real triangle count
    n_pad: int = pytree.field(static=True)        # padded count T
    v0: Any          # [T, 3]
    e1: Any          # [T, 3]
    e2: Any          # [T, 3]
    n_g: Any         # [T, 3] unit geometric normal
    inter_rows: Any  # [T, 3, 4] Baldwin-Weber rows (N4 | U4 | V4)
    vn: Any          # [T, 3, 3] per-corner shading normals
    vuv: Any         # [T, 3, 2] per-corner uvs
    area: Any        # [T]
    mat_id: Any      # [T] int32
    mesh_id: Any     # [T] int32
    emitter_id: Any  # [T] int32, -1 if not emissive (index into emitter table)
    has_normals: Any  # [T] bool (use vertex-normal interpolation)
    # fused attribute rows (see A_* column constants above): [T, N_ATTR_GEOM]
    # as built here, widened to [T, N_ATTR] by Scene.compile
    attr: Any = None
    # BVH tables (accel/bvh.py BvhTables), attached by build_geometry_tables
    # when the triangle count crosses BVH_THRESHOLD; None = dense scan
    bvh: Any = None


def _baldwin_weber_rows(v0, e1, e2, n):
    """Per-triangle world->(t, u, v) affine rows.

    For a point p on the plane: p - v0 = u*e1 + v*e2.
      w1 = (e2 x n) / ((e2 x n).e1)  =>  u = w1.(p - v0)
      w2 = (e1 x n) / ((e1 x n).e2)  =>  v = w2.(p - v0)
    Distance: t = -(n.o + d_plane) / (n.d), d_plane = -n.v0.
    Returns [t, 3, 4] rows [N4, U4, V4] with X4 = [x, -x.v0].
    """
    c2 = np.cross(e2, n)
    d1 = np.sum(c2 * e1, axis=-1, keepdims=True)
    w1 = c2 / np.where(np.abs(d1) > 1e-30, d1, 1.0)
    c1 = np.cross(e1, n)
    d2 = np.sum(c1 * e2, axis=-1, keepdims=True)
    w2 = c1 / np.where(np.abs(d2) > 1e-30, d2, 1.0)

    def row4(x):
        return np.concatenate([x, -np.sum(x * v0, axis=-1, keepdims=True)], axis=-1)

    return np.stack([row4(n), row4(w1), row4(w2)], axis=1).astype(
        np.float32, copy=False)


def build_geometry_tables(meshes: List[TriMesh], mesh_emitter_id: List[int]) -> GeometryTables:
    """Flatten meshes into one padded triangle table.

    mesh_emitter_id[i] = emitter index for mesh i, or -1.
    """
    v0s, e1s, e2s, ngs, rows, vns, vuvs, areas = [], [], [], [], [], [], [], []
    mats, mids, eids, hasn = [], [], [], []
    for mi, m in enumerate(meshes):
        # f32 up front: f64 vertices (some loaders/generators) would double
        # every downstream copy of the multi-million-row tables
        v, idx = np.asarray(m.vertices, np.float32), m.indices
        p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
        e1 = p1 - p0
        e2 = p2 - p0
        nraw = np.cross(e1, e2)
        nlen = np.linalg.norm(nraw, axis=-1, keepdims=True)
        ng = nraw / np.maximum(nlen, 1e-30)
        v0s.append(p0); e1s.append(e1); e2s.append(e2); ngs.append(ng)
        rows.append(_baldwin_weber_rows(p0, e1, e2, ng))
        areas.append(0.5 * nlen[:, 0])
        if m.normals is not None:
            vn = np.stack([m.normals[idx[:, k]] for k in range(3)], axis=1)
            hasn.append(np.ones(len(idx), bool))
        else:
            vn = np.repeat(ng[:, None, :], 3, axis=1)
            hasn.append(np.zeros(len(idx), bool))
        vns.append(vn)
        if m.uvs is not None:
            vuv = np.stack([m.uvs[idx[:, k]] for k in range(3)], axis=1)
        else:
            vuv = np.zeros((len(idx), 3, 2), np.float32)
        vuvs.append(vuv)
        mats.append(np.full(len(idx), m.material, np.int32))
        mids.append(np.full(len(idx), mi, np.int32))
        eids.append(np.full(len(idx), mesh_emitter_id[mi], np.int32))

    def cat(xs):
        # single-mesh scenes skip the copy (np.concatenate copies even for
        # a one-element list — measured ~5 s at 4.9M tris)
        return xs[0] if len(xs) == 1 else np.concatenate(xs, axis=0)

    v0 = cat(v0s); e1 = cat(e1s); e2 = cat(e2s); ng = cat(ngs)
    rws = cat(rows); vn = cat(vns); vuv = cat(vuvs); area = cat(areas)
    mat = cat(mats); mid = cat(mids); eid = cat(eids); hn = cat(hasn)

    t = v0.shape[0]
    t_pad = max(TRI_PAD, ((t + TRI_PAD - 1) // TRI_PAD) * TRI_PAD)
    pad = t_pad - t

    def padz(x, fill=0):
        shape = (pad,) + x.shape[1:]
        return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)

    # Degenerate pad triangles: n=0 rows make Nd==0 so they never report hits.
    # numpy leaves — Scene.compile device_puts the assembled pytree once.
    gt = GeometryTables(
        n_tris=t, n_pad=t_pad,
        v0=padz(v0), e1=padz(e1), e2=padz(e2),
        n_g=padz(ng),
        inter_rows=padz(rws),
        vn=padz(vn), vuv=padz(vuv),
        area=padz(area),
        mat_id=padz(mat), mesh_id=padz(mid, -1),
        emitter_id=padz(eid, -1),
        has_normals=padz(hn, False),
    )
    gt = gt.replace(attr=np.concatenate([
        gt.v0, gt.e1, gt.e2, gt.n_g, gt.area[:, None],
        gt.vn.reshape(t_pad, 9), gt.vuv.reshape(t_pad, 6),
        gt.has_normals[:, None].astype(np.float32),
        gt.mat_id[:, None].astype(np.float32),
        gt.emitter_id[:, None].astype(np.float32),
    ], axis=1).astype(np.float32, copy=False))
    if gt.n_tris > BVH_THRESHOLD:
        from ..accel.bvh import build_bvh
        gt = gt.replace(bvh=build_bvh(gt))
    return gt


def scene_bounds(meshes: List[TriMesh]):
    lo = np.min([m.vertices.min(0) for m in meshes], axis=0)
    hi = np.max([m.vertices.max(0) for m in meshes], axis=0)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center))
    return lo, hi, center, radius


# ---------------------------------------------------------------- primitives

def make_quad(p0, p1, p2, p3, material=0, emission=(0, 0, 0), name="") -> TriMesh:
    """Quad from 4 corners (ccw), split into 2 triangles."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return TriMesh(verts, idx, uvs=uv, material=material,
                   emission=np.asarray(emission, np.float32), name=name)


def make_box(lo, hi, material=0, name="") -> TriMesh:
    """Axis-aligned box with outward normals."""
    lo = np.asarray(lo, np.float32); hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo; x1, y1, z1 = hi
    quads = [
        # -z / +z
        ([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),
        ([x1, y0, z1], [x0, y0, z1], [x0, y1, z1], [x1, y1, z1]),
        # -x / +x
        ([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]),
        ([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]),
        # -y / +y
        ([x0, y0, z1], [x1, y0, z1], [x1, y0, z0], [x0, y0, z0]),
        ([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),
    ]
    verts, idx = [], []
    for q in quads:
        base = len(verts)
        verts.extend(q)
        idx.append([base, base + 1, base + 2])
        idx.append([base, base + 2, base + 3])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(idx, np.int32),
                   material=material, name=name)


def make_sphere(center, radius, material=0, emission=(0, 0, 0),
                n_theta=32, n_phi=32, name="") -> TriMesh:
    """Tessellated sphere (reference tessellates spheres 32x32, scene_loader.rs:598-665)."""
    center = np.asarray(center, np.float32)
    thetas = np.linspace(0, np.pi, n_theta + 1)
    phis = np.linspace(0, 2 * np.pi, n_phi + 1)
    verts, norms, uvs = [], [], []
    for it, th in enumerate(thetas):
        for ip, ph in enumerate(phis):
            n = np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], np.float32)
            verts.append(center + radius * n)
            norms.append(n)
            uvs.append([ip / n_phi, it / n_theta])
    idx = []
    stride = n_phi + 1
    for it in range(n_theta):
        for ip in range(n_phi):
            a = it * stride + ip
            b = a + 1
            c = a + stride
            d = c + 1
            if it > 0:
                idx.append([a, c, b])
            if it < n_theta - 1:
                idx.append([b, c, d])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(idx, np.int32),
                   normals=np.asarray(norms, np.float32), uvs=np.asarray(uvs, np.float32),
                   material=material, emission=np.asarray(emission, np.float32), name=name)
