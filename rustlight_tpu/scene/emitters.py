"""Emitters as flat atom tables with a single flux CDF.

The reference keeps `Vec<Arc<dyn Emitter>>` + a flux CDF and identifies
emitters by fat-pointer address (src/emitter.rs:1490-1763 — a known wart).
Here every *sampleable atom* — each emissive triangle, each point light, each
directional light, the envmap — is one row of a flat table with a single CDF.

Atom weights reproduce the reference's two-level scheme exactly: a mesh
emitter's selection probability (flux().channel_max() over the CDF,
src/scene.rs:102-111) is spread over its triangles proportionally to area, so
the area-domain pdf of a sampled point is sel_pdf(mesh)/mesh_area — identical
to `EmitterSampler::sample_light` + `Mesh::direct_sample`. Triangle hits map
back to atoms via a per-triangle table instead of pointer identity.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..utils import pytree
from ..utils.distribution import (
    Distribution1D, build_distribution_1d, build_distribution_1d_np,
    sample_discrete_1d, pdf_discrete_1d,
    Distribution2D, build_distribution_2d, build_distribution_2d_np,
    sample_continuous_2d,
)
from ..ops.gather import make_taker, table_take
from ..utils.frame import make_frame, to_world
from ..utils import warps

ATOM_TRI = 0
ATOM_POINT = 1
ATOM_DIR = 2
ATOM_ENV = 3
ATOM_PN = 4     # point+normal cosine emitter (emitter.rs:252-298)

_PI = np.pi


@pytree.dataclass
class EmitterTables:
    n_atoms: int = pytree.field(static=True)
    has_env: bool = pytree.field(static=True)
    env_textured: bool = pytree.field(static=True)
    # any triangle uses uv-dependent emission (HSV/texture,
    # reference geometry.rs:99-104) — static so constant scenes skip the math
    has_em_uv: bool = pytree.field(static=True)
    atom_cdf: Any            # Distribution1D over atoms
    atom_kind: Any           # [a] int32
    atom_ref: Any            # [a] int32 (tri global id / point idx / dir idx)
    # per-global-triangle emission tables (length T_pad)
    tri_emission: Any        # [t, 3] radiance Le (mean Le for uv-kinds)
    tri_pdf_area: Any        # [t] area-domain direct pdf (sel/area); 0 if not emissive
    tri_atom: Any            # [t] int32 atom id for this triangle (-1 if none)
    # point lights
    point_pos: Any           # [p, 3]
    point_intensity: Any     # [p, 3]
    # directional lights
    dir_direction: Any       # [d, 3] (from light into the world)
    dir_intensity: Any       # [d, 3]
    # envmap
    env_color: Any           # [3] constant color
    env_img: Any             # [h, w, 3] (ones if constant)
    env_cdf: Any             # Distribution2D over luminance*sin(theta)
    env_lum_int: Any         # scalar: avg of luminance*sin(theta) rows (marginal func_int)
    # scene bounding sphere (radius pre-scaled x1.1 for env/dir emitters)
    bsphere_center: Any      # [3]
    bsphere_radius: Any      # scalar
    # point-normal emitters (PointNormalEmitter, emitter.rs:252-298)
    pn_pos: Any = None        # [q, 3]
    pn_normal: Any = None     # [q, 3] unit
    pn_intensity: Any = None  # [q, 3]
    # uv-dependent emission (EmissionType::{HSV,Texture}, geometry.rs:184-206)
    tri_em_kind: Any = None   # [t] int32: 0 color, 1 HSV, 2 texture
    tri_em_scale: Any = None  # [t] f32
    tri_em_tex: Any = None    # [t] int32 atlas slot
    tex_atlas: Any = None     # [k, th, tw, 3] shared scene texture atlas


class LightSample(NamedTuple):
    """NEE record (reference LightSampling, src/emitter.rs:10-24)."""
    p: Any         # [n, 3] point on the light
    n: Any         # [n, 3] light normal (0 for point lights)
    d: Any         # [n, 3] unit direction shading point -> light
    dist: Any      # [n]
    pdf: Any       # [n] solid-angle pdf (or discrete prob for delta emitters)
    weight: Any    # [n, 3] Le * G / pdf  (ready to multiply with f*cos... f only)
    is_delta: Any  # [n] bool (point/directional: MIS does not apply)
    valid: Any     # [n]
    tri: Any       # [n] int32 sampled triangle (-1 otherwise)


class PositionSample(NamedTuple):
    """Photon/light-path emission origin (reference SampledPosition + flux)."""
    p: Any         # [n, 3]
    n: Any         # [n, 3]
    pdf_area: Any  # [n]
    weight: Any    # [n, 3] flux estimate (Phi / pdf, selection included)
    kind: Any      # [n] atom kind
    atom: Any      # [n] atom id
    valid: Any


def build_emitter_tables(
    meshes, mesh_emitter_id: List[int], t_pad: int,
    points: Optional[List] = None,
    directionals: Optional[List] = None,
    point_normals: Optional[List] = None,
    env_constant: Optional[np.ndarray] = None,
    env_image: Optional[np.ndarray] = None,
    bsphere_center=(0, 0, 0), bsphere_radius=1.0,
    textures: Optional[np.ndarray] = None,
) -> EmitterTables:
    """Flatten emitters. points: [(pos, intensity)], directionals:
    [(direction, intensity)]. env_image [h, w, 3] takes priority over
    env_constant."""
    points = points or []
    directionals = directionals or []
    point_normals = point_normals or []
    has_env = env_constant is not None or env_image is not None
    env_textured = env_image is not None

    lum = np.array([0.212671, 0.715160, 0.072169], np.float32)

    kinds, refs, weights = [], [], []
    tri_emission = np.zeros((t_pad, 3), np.float32)
    tri_pdf_area = np.zeros((t_pad,), np.float32)
    tri_atom = np.full((t_pad,), -1, np.int32)
    tri_em_kind = np.zeros((t_pad,), np.int32)
    tri_em_scale = np.ones((t_pad,), np.float32)
    tri_em_tex = np.full((t_pad,), -1, np.int32)
    has_em_uv = False

    # surface atoms: per-triangle rows carrying mesh_flux * area_frac
    tri_base = 0
    mesh_entries = []  # (atom slice, mesh)
    for mi, m in enumerate(meshes):
        nt = m.n_triangles
        if mesh_emitter_id[mi] >= 0 and m.is_light:
            areas = m.triangle_areas()
            total = areas.sum()
            # channel_max of area*Le*pi (Le = mean for uv-dependent kinds)
            flux_scalar = float(np.max(m.flux(textures)))
            w = flux_scalar * areas / max(total, 1e-30)
            for k in range(nt):
                kinds.append(ATOM_TRI)
                refs.append(tri_base + k)
                weights.append(w[k])
            tri_emission[tri_base:tri_base + nt] = m.mean_emission(textures)
            ek = int(getattr(m, "emission_kind", 0))
            if ek != 0:
                has_em_uv = True
                tri_em_kind[tri_base:tri_base + nt] = ek
                tri_em_scale[tri_base:tri_base + nt] = m.emission_scale
                tri_em_tex[tri_base:tri_base + nt] = m.emission_tex
            mesh_entries.append((len(weights) - nt, mi, total))
        tri_base += nt

    for pi, (pos, inten) in enumerate(points):
        kinds.append(ATOM_POINT); refs.append(pi)
        weights.append(float(np.max(np.asarray(inten) * 4.0 * _PI)))
    for di, (dvec, inten) in enumerate(directionals):
        kinds.append(ATOM_DIR); refs.append(di)
        area = _PI * (bsphere_radius * 1.1) ** 2
        weights.append(float(np.max(np.asarray(inten) * area)))
    for qi, (pos, nrm_, inten) in enumerate(point_normals):
        kinds.append(ATOM_PN); refs.append(qi)
        # reference flux() = 2*intensity (emitter.rs:283-289)
        weights.append(float(np.max(np.asarray(inten) * 2.0)))

    if has_env:
        if env_textured:
            h, w_ = env_image.shape[:2]
            sin_w = np.sin((np.arange(h) + 0.5) * _PI / h)[:, None]
            lum_img = (env_image * lum).sum(-1) * sin_w
            flux_scalar = _PI * (bsphere_radius * 1.1) ** 2 * float(lum_img.mean())
        else:
            lum_img = np.ones((1, 1), np.float32)
            flux_scalar = float(np.max(np.asarray(env_constant))) * _PI * (bsphere_radius * 1.1) ** 2
        kinds.append(ATOM_ENV); refs.append(0)
        weights.append(flux_scalar)

    n_atoms = len(kinds)
    if n_atoms == 0:
        # no emitters: single dummy atom with zero weight
        kinds, refs, weights = [ATOM_TRI], [0], [0.0]
        n_atoms = 1

    atom_cdf = build_distribution_1d_np(np.asarray(weights, np.float32))
    probs = atom_cdf.cdf[1:] - atom_cdf.cdf[:-1]

    # per-triangle direct-pdf + atom backref
    for ai, (k, r) in enumerate(zip(kinds, refs)):
        if k == ATOM_TRI and probs[ai] > 0.0:
            tri_atom[r] = ai
    tri_base = 0
    for mi, m in enumerate(meshes):
        nt = m.n_triangles
        if mesh_emitter_id[mi] >= 0 and m.is_light:
            areas = m.triangle_areas()
            for k in range(nt):
                ai = tri_atom[tri_base + k]
                if ai >= 0 and areas[k] > 0:
                    tri_pdf_area[tri_base + k] = probs[ai] / areas[k]
        tri_base += nt

    if env_textured:
        env_img = np.asarray(env_image, np.float32)
        h, w_ = env_img.shape[:2]
        sin_w = np.sin((np.arange(h) + 0.5) * _PI / h)[:, None]
        env_cdf = build_distribution_2d_np((env_img * lum).sum(-1) * sin_w)
    else:
        env_img = np.ones((1, 1, 3), np.float32)
        env_cdf = build_distribution_2d_np(np.ones((1, 1)))

    def arr(x, shape, dtype=np.float32):
        a = np.asarray(x, dtype)
        return a if a.size else np.zeros(shape, dtype)

    return EmitterTables(
        n_atoms=n_atoms,
        has_env=has_env,
        env_textured=env_textured,
        has_em_uv=has_em_uv,
        tri_em_kind=tri_em_kind,
        tri_em_scale=tri_em_scale,
        tri_em_tex=tri_em_tex,
        tex_atlas=(np.asarray(textures, np.float32)
                   if (has_em_uv and textures is not None) else None),
        atom_cdf=atom_cdf,
        atom_kind=np.asarray(kinds, np.int32),
        atom_ref=np.asarray(refs, np.int32),
        tri_emission=tri_emission,
        tri_pdf_area=tri_pdf_area,
        tri_atom=tri_atom,
        point_pos=arr([p for p, _ in points], (1, 3)),
        point_intensity=arr([i for _, i in points], (1, 3)),
        dir_direction=arr([d / np.linalg.norm(np.asarray(d, np.float32)) for d, _ in directionals], (1, 3)),
        dir_intensity=arr([i for _, i in directionals], (1, 3)),
        pn_pos=arr([p_ for p_, _, _ in point_normals], (0, 3)),
        pn_normal=arr([n_ / np.linalg.norm(np.asarray(n_, np.float32))
                       for _, n_, _ in point_normals], (0, 3)),
        pn_intensity=arr([i for _, _, i in point_normals], (0, 3)),
        env_color=np.asarray(env_constant if env_constant is not None else (0, 0, 0), np.float32),
        env_img=env_img,
        env_cdf=env_cdf,
        env_lum_int=env_cdf.marginal_int,
        bsphere_center=np.asarray(bsphere_center, np.float32),
        bsphere_radius=np.float32(bsphere_radius * 1.1),
    )


# ----------------------------------------------------------------- device ops

def _sphere_exit_t(center, radius, o, d):
    """Distance to the far intersection with the bounding sphere."""
    oc = o - center
    b = jnp.sum(oc * d, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius ** 2
    disc = jnp.maximum(b * b - c, 0.0)
    return -b + jnp.sqrt(disc)


def env_radiance(em: EmitterTables, d):
    """Escaped-ray radiance (reference enviroment_luminance, scene.rs:125-130)."""
    if not em.has_env:
        return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)
    if not em.env_textured:
        return jnp.broadcast_to(em.env_color, d.shape[:-1] + (3,))
    theta, phi = warps.to_spherical_coordinates(d)
    u = jnp.clip(phi / (2 * _PI), 0.0, 1.0 - 1e-7)
    v = jnp.clip(theta / _PI, 0.0, 1.0 - 1e-7)
    h, w = em.env_img.shape[:2]
    xi = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return em.env_img[yi, xi]


def _env_sel_pdf(em: EmitterTables):
    """Selection probability of the env atom (it is always the last atom)."""
    return pdf_discrete_1d(em.atom_cdf, jnp.int32(em.n_atoms - 1))


def env_direction_pdf(em: EmitterTables, d):
    """Solid-angle pdf of sampling direction d from the envmap (selection incl.)."""
    if not em.has_env:
        return jnp.zeros(d.shape[:-1], jnp.float32)
    sel = _env_sel_pdf(em)
    if not em.env_textured:
        return jnp.full(d.shape[:-1], 1.0 / (4.0 * _PI)) * sel
    theta, phi = warps.to_spherical_coordinates(d)
    u = jnp.clip(phi / (2 * _PI), 0.0, 1.0 - 1e-7)
    v = jnp.clip(theta / _PI, 0.0, 1.0 - 1e-7)
    h, w = em.env_img.shape[:2]
    xi = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    cell = em.env_cdf.func[yi, xi] / jnp.maximum(em.env_cdf.marginal_int, 1e-30)
    sin_t = jnp.sin(_PI * v)
    pdf = jnp.where(sin_t > 0.0, cell / (2.0 * _PI ** 2 * sin_t), 0.0)
    return pdf * sel


def _sample_env_direction(em: EmitterTables, uv):
    """Returns (d, color, pdf_sa) — selection pdf NOT included."""
    if not em.env_textured:
        d = warps.sample_uniform_sphere(uv)
        color = jnp.broadcast_to(em.env_color, uv.shape[:-1] + (3,))
        pdf = jnp.full(uv.shape[:-1], 1.0 / (4.0 * _PI))
        return d, color, pdf
    h, w = em.env_img.shape[:2]
    xy = sample_continuous_2d(em.env_cdf, uv)
    x = jnp.clip(xy[..., 0], 0.0, w - 1.0)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.0)
    xi = x.astype(jnp.int32)
    yi = y.astype(jnp.int32)
    color = em.env_img[yi, xi]
    cell = em.env_cdf.func[yi, xi] / jnp.maximum(em.env_cdf.marginal_int, 1e-30)
    phi = (2.0 * _PI / w) * x
    theta = (_PI / h) * y
    st, ct = jnp.sin(theta), jnp.cos(theta)
    d = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    pdf = jnp.where(st > 0.0, cell / (2.0 * _PI ** 2 * st), 0.0)
    color = jnp.where((st > 0.0)[..., None], color, 0.0)
    return d, color, pdf


def sample_light(em: EmitterTables, geom, p_ref, u_sel, u_pos) -> LightSample:
    """NEE sample toward one emitter atom per lane.

    p_ref [n, 3] shading points; u_sel [n]; u_pos [n, 2].
    weight = Le * G / pdf_area (surface) etc., selection pdf folded in — ready
    to be multiplied by f(wo) (reference sample_light, emitter.rs:1602-1640).
    """
    n = p_ref.shape[0]
    atom = sample_discrete_1d(em.atom_cdf, u_sel)
    sel_pdf = pdf_discrete_1d(em.atom_cdf, atom)
    atake = make_taker(atom, em.atom_kind.shape[0])
    kind = atake(em.atom_kind)
    ref = atake(em.atom_ref)

    # ---- surface triangle atom (one fused gather on large tables)
    tri = ref
    b = warps.uniform_sample_triangle(u_pos)
    ttake = make_taker(tri, geom.n_pad)
    fields = ["v0", "e1", "e2", "ng", "area", "le"]
    if em.has_em_uv:
        fields += ["vuv", "kind", "scale", "tex"]
    tc = _take_tri_cols(geom, em, ttake, fields)
    v0, e1, e2 = tc["v0"], tc["e1"], tc["e2"]
    p_tri = v0 + b[..., 0:1] * e1 + b[..., 1:2] * e2
    n_tri = tc["ng"]
    area = tc["area"]
    le = tc["le"]
    if em.has_em_uv:
        le = _emission_at(em, tc["kind"], tc["scale"], tc["tex"], le,
                          _tri_uv_at(tc["vuv"], b))

    delta_v = p_tri - p_ref
    dist_tri = jnp.linalg.norm(delta_v, axis=-1)
    d_tri = delta_v / jnp.maximum(dist_tri, 1e-20)[:, None]
    cos_l = jnp.maximum(jnp.sum(n_tri * (-d_tri), axis=-1), 0.0)
    g = jnp.where(dist_tri > 0.0, cos_l / jnp.maximum(dist_tri ** 2, 1e-20), 0.0)
    pdf_area = sel_pdf / jnp.maximum(area, 1e-20)
    pdf_tri = jnp.where(g > 0.0, pdf_area * dist_tri ** 2 / jnp.maximum(cos_l, 1e-20), 0.0)
    w_tri = jnp.where((g > 0.0)[:, None], le * (g / jnp.maximum(pdf_area, 1e-30))[:, None], 0.0)
    valid_tri = (g > 0.0) & (sel_pdf > 0.0)

    p = p_tri; nrm = n_tri; d = d_tri; dist = dist_tri
    pdf = pdf_tri; weight = w_tri
    is_delta = jnp.zeros(n, bool)
    valid = valid_tri
    tri_out = jnp.where(kind == ATOM_TRI, tri, -1)

    # ---- point atom
    if em.point_pos.shape[0] > 0:
        pp = table_take(em.point_pos, ref)
        pi = table_take(em.point_intensity, ref)
        dv = pp - p_ref
        dist_p = jnp.linalg.norm(dv, axis=-1)
        d_p = dv / jnp.maximum(dist_p, 1e-20)[:, None]
        w_p = pi / jnp.maximum(dist_p ** 2, 1e-20)[:, None] / jnp.maximum(sel_pdf, 1e-30)[:, None]
        m = kind == ATOM_POINT
        p = jnp.where(m[:, None], pp, p)
        nrm = jnp.where(m[:, None], 0.0, nrm)
        d = jnp.where(m[:, None], d_p, d)
        dist = jnp.where(m, dist_p, dist)
        pdf = jnp.where(m, sel_pdf, pdf)
        weight = jnp.where(m[:, None], w_p, weight)
        is_delta = is_delta | m
        valid = jnp.where(m, sel_pdf > 0.0, valid)

    # ---- directional atom
    if em.dir_direction.shape[0] > 0:
        dd = table_take(em.dir_direction, ref)
        di = table_take(em.dir_intensity, ref)
        m = kind == ATOM_DIR
        p_d = p_ref - em.bsphere_radius * dd
        dist_d = jnp.full(n, em.bsphere_radius)
        p = jnp.where(m[:, None], p_d, p)
        nrm = jnp.where(m[:, None], dd, nrm)
        d = jnp.where(m[:, None], -dd, d)
        dist = jnp.where(m, dist_d, dist)
        pdf = jnp.where(m, sel_pdf, pdf)
        weight = jnp.where(m[:, None], di / jnp.maximum(sel_pdf, 1e-30)[:, None], weight)
        is_delta = is_delta | m
        valid = jnp.where(m, sel_pdf > 0.0, valid)

    # ---- point-normal atom (PointNormalEmitter, emitter.rs:252-298; the
    # reference leaves direct_sample as todo!() — implemented here with the
    # natural cosine falloff I*max(n.(-d),0)/d^2)
    if em.pn_pos.shape[0] > 0:
        pp = table_take(em.pn_pos, ref)
        pnn = table_take(em.pn_normal, ref)
        pint = table_take(em.pn_intensity, ref)
        dv = pp - p_ref
        dist_q = jnp.linalg.norm(dv, axis=-1)
        d_q = dv / jnp.maximum(dist_q, 1e-20)[:, None]
        cos_q = jnp.maximum(jnp.sum(pnn * (-d_q), -1), 0.0)
        w_q = (pint * (cos_q / jnp.maximum(dist_q ** 2, 1e-20))[:, None]
               / jnp.maximum(sel_pdf, 1e-30)[:, None])
        m = kind == ATOM_PN
        p = jnp.where(m[:, None], pp, p)
        nrm = jnp.where(m[:, None], pnn, nrm)
        d = jnp.where(m[:, None], d_q, d)
        dist = jnp.where(m, dist_q, dist)
        pdf = jnp.where(m, sel_pdf, pdf)
        weight = jnp.where(m[:, None], w_q, weight)
        is_delta = is_delta | m
        valid = jnp.where(m, (sel_pdf > 0.0) & (cos_q > 0.0), valid)

    # ---- env atom
    if em.has_env:
        d_e, color_e, pdf_e = _sample_env_direction(em, u_pos)
        t_exit = _sphere_exit_t(em.bsphere_center, em.bsphere_radius, p_ref, d_e)
        p_e = p_ref + d_e * t_exit[:, None]
        n_e = em.bsphere_center - p_e
        n_e = n_e / jnp.maximum(jnp.linalg.norm(n_e, axis=-1, keepdims=True), 1e-20)
        m = kind == ATOM_ENV
        pdf_full = pdf_e * sel_pdf
        w_e = color_e / jnp.maximum(pdf_full, 1e-30)[:, None]
        p = jnp.where(m[:, None], p_e, p)
        nrm = jnp.where(m[:, None], n_e, nrm)
        d = jnp.where(m[:, None], d_e, d)
        dist = jnp.where(m, t_exit, dist)
        pdf = jnp.where(m, pdf_full, pdf)
        weight = jnp.where(m[:, None], w_e, weight)
        valid = jnp.where(m, pdf_full > 0.0, valid)

    weight = jnp.where(valid[:, None], weight, 0.0)
    return LightSample(p=p, n=nrm, d=d, dist=dist, pdf=pdf, weight=weight,
                       is_delta=is_delta, valid=valid, tri=tri_out)


def direct_pdf_tri(em: EmitterTables, tri_id, p_ref, p_hit, n_hit, d,
                   attr=None):
    """Solid-angle NEE pdf of hitting emissive triangle tri_id from p_ref
    (reference Mesh::direct_pdf x selection, emitter.rs:571-579). `attr` =
    pre-gathered fused attribute rows (Hit.attr), if available."""
    if attr is not None:
        from .geometry import A_PDFA
        pdf_area = attr[:, A_PDFA]
    else:
        pdf_area = table_take(em.tri_pdf_area, jnp.maximum(tri_id, 0))
    cos_l = jnp.maximum(jnp.sum(n_hit * (-d), axis=-1), 0.0)
    dist2 = jnp.sum((p_hit - p_ref) ** 2, axis=-1)
    pdf = jnp.where(cos_l > 0.0, pdf_area * dist2 / jnp.maximum(cos_l, 1e-20), 0.0)
    return jnp.where(tri_id >= 0, pdf, 0.0)


def _take_tri_cols(geom, em: EmitterTables, take, fields):
    """Per-tri columns for gathered triangle indices, as a dict.

    Above the one-hot threshold ONE fused gather of geom.attr serves every
    column (each separate take re-scans the table in 4096-row chunks);
    below it, narrow per-column takes sharing the one-hot measure faster
    (see fill_hit). `fields` from: v0 e1 e2 ng area le vuv kind scale tex.
    """
    from ..ops.gather import MAX_ONEHOT_ROWS
    from .geometry import (A_V0, A_E1, A_E2, A_NG, A_AREA, A_LE, A_VUV,
                           A_EMKIND, A_EMSCALE, A_EMTEX, N_ATTR)
    out = {}
    # the fused branch slices emission columns that exist only after
    # Scene.compile widened geom.attr to N_ATTR; a raw GeometryTables falls
    # through to the narrow takes (mirrors the fill_hit guard)
    if geom.n_pad > MAX_ONEHOT_ROWS and geom.attr.shape[1] >= N_ATTR:
        a = take(geom.attr)
        nl = a.shape[0]
        spec = {"v0": a[:, A_V0], "e1": a[:, A_E1], "e2": a[:, A_E2],
                "ng": a[:, A_NG], "area": a[:, A_AREA], "le": a[:, A_LE]}
        for f in fields:
            if f == "vuv":
                out[f] = a[:, A_VUV].reshape(nl, 3, 2)
            elif f == "kind":
                out[f] = jnp.round(a[:, A_EMKIND]).astype(jnp.int32)
            elif f == "scale":
                out[f] = a[:, A_EMSCALE]
            elif f == "tex":
                out[f] = jnp.round(a[:, A_EMTEX]).astype(jnp.int32)
            else:
                out[f] = spec[f]
        return out
    narrow = {"v0": geom.v0, "e1": geom.e1, "e2": geom.e2, "ng": geom.n_g,
              "area": geom.area, "le": em.tri_emission, "vuv": geom.vuv,
              "kind": em.tri_em_kind, "scale": em.tri_em_scale,
              "tex": em.tri_em_tex}
    for f in fields:
        out[f] = take(narrow[f])
    return out


def _emission_at(em: EmitterTables, kind, scale, tex, base_le, uv):
    """uv-dependent emission (Mesh::emit, reference geometry.rs:184-206):
    kind 0 = constant `base_le`, 1 = HSV ramp x*red+(1-x)*green over u,
    2 = texture atlas lookup. Only called when em.has_em_uv."""
    x = jnp.mod(jnp.abs(uv[..., 0]), 1.0)
    hsv = scale[:, None] * jnp.stack([x, 1.0 - x, jnp.zeros_like(x)], -1)
    le = jnp.where((kind == 1)[:, None], hsv, base_le)
    if em.tex_atlas is not None:
        k, th, tw, _ = em.tex_atlas.shape
        fu = uv[..., 0] - jnp.floor(uv[..., 0])
        fv = uv[..., 1] - jnp.floor(uv[..., 1])
        xi = jnp.clip((fu * tw).astype(jnp.int32), 0, tw - 1)
        yi = jnp.clip(((1.0 - fv) * th).astype(jnp.int32), 0, th - 1)
        img = jnp.clip(tex, 0, k - 1)
        texel = em.tex_atlas[img, yi, xi] * scale[:, None]
        le = jnp.where((kind == 2)[:, None], texel, le)
    return le


def _tri_uv_at(vuv, b):
    """Interpolated uv at barycentric b from per-corner uvs [n, 3, 2]."""
    w0 = (1.0 - b[..., 0] - b[..., 1])[:, None]
    return (vuv[:, 0] * w0 + vuv[:, 1] * b[..., 0:1]
            + vuv[:, 2] * b[..., 1:2])


def emitted_radiance(em: EmitterTables, geom, tri_id, d, uv=None, attr=None):
    """Le seen along -d when hitting triangle tri_id (front side only,
    reference `emit` + n_g orientation check in direct.rs:147). Pass the hit
    uv to evaluate uv-dependent emission kinds exactly. `attr` = fused
    attribute rows already gathered for tri_id (Hit.attr) — skips the
    re-gather of the big per-tri tables."""
    from .geometry import A_NG, A_LE, A_EMKIND, A_EMSCALE, A_EMTEX
    uv_on = em.has_em_uv and uv is not None
    if attr is not None:
        le = attr[:, A_LE]
        ng = attr[:, A_NG]
        if uv_on:
            le = _emission_at(em,
                              jnp.round(attr[:, A_EMKIND]).astype(jnp.int32),
                              attr[:, A_EMSCALE],
                              jnp.round(attr[:, A_EMTEX]).astype(jnp.int32),
                              le, uv)
    else:
        t = make_taker(jnp.maximum(tri_id, 0), geom.n_pad)
        tc = _take_tri_cols(geom, em, t, ["le", "ng"]
                            + (["kind", "scale", "tex"] if uv_on else []))
        le = tc["le"]
        ng = tc["ng"]
        if uv_on:
            le = _emission_at(em, tc["kind"], tc["scale"], tc["tex"], le, uv)
    front = jnp.sum(ng * (-d), axis=-1) > 0.0
    return jnp.where((front & (tri_id >= 0))[:, None], le, 0.0)


def sample_position(em: EmitterTables, geom, u_sel, u_pos) -> PositionSample:
    """Sample an emission origin for light paths/photons
    (reference random_sample_emitter_position, emitter.rs:1745-1756)."""
    n = u_sel.shape[0]
    atom = sample_discrete_1d(em.atom_cdf, u_sel)
    sel_pdf = pdf_discrete_1d(em.atom_cdf, atom)
    atake = make_taker(atom, em.atom_kind.shape[0])
    kind = atake(em.atom_kind)
    ref = atake(em.atom_ref)

    # surface: uniform point on the triangle; Phi = Le*pi/pdf_area
    tri = ref
    b = warps.uniform_sample_triangle(u_pos)
    ttake = make_taker(tri, geom.n_pad)
    fields = ["v0", "e1", "e2", "ng", "area", "le"]
    if em.has_em_uv:
        fields += ["vuv", "kind", "scale", "tex"]
    tc = _take_tri_cols(geom, em, ttake, fields)
    v0, e1, e2 = tc["v0"], tc["e1"], tc["e2"]
    p = v0 + b[..., 0:1] * e1 + b[..., 1:2] * e2
    nrm = tc["ng"]
    area = tc["area"]
    le = tc["le"]
    if em.has_em_uv:
        le = _emission_at(em, tc["kind"], tc["scale"], tc["tex"], le,
                          _tri_uv_at(tc["vuv"], b))
    pdf_area = sel_pdf / jnp.maximum(area, 1e-20)
    weight = le * (_PI / jnp.maximum(pdf_area, 1e-30))[:, None]
    valid = sel_pdf > 0.0

    if em.point_pos.shape[0] > 0:
        m = kind == ATOM_POINT
        p = jnp.where(m[:, None], table_take(em.point_pos, ref), p)
        nrm = jnp.where(m[:, None], 0.0, nrm)
        w_p = table_take(em.point_intensity, ref) * (4.0 * _PI)
        weight = jnp.where(m[:, None], w_p / jnp.maximum(sel_pdf, 1e-30)[:, None], weight)

    # PointNormalEmitter origin: position + normal, cosine direction follows
    # via sample_emission_direction (surface branch); Phi = pi*I for radiant
    # intensity I*cos (the reference's flux()=2I feeds its todo!()'d
    # sample_direction, emitter.rs:266-289 — we keep the energy-consistent
    # value so adjoint estimators stay unbiased)
    if em.pn_pos.shape[0] > 0:
        m = kind == ATOM_PN
        p = jnp.where(m[:, None], table_take(em.pn_pos, ref), p)
        nrm = jnp.where(m[:, None], table_take(em.pn_normal, ref), nrm)
        w_q = table_take(em.pn_intensity, ref) * _PI
        weight = jnp.where(m[:, None],
                           w_q / jnp.maximum(sel_pdf, 1e-30)[:, None], weight)
        pdf_area = jnp.where(m, sel_pdf, pdf_area)

    if em.dir_direction.shape[0] > 0:
        m = kind == ATOM_DIR
        dd = table_take(em.dir_direction, ref)
        disk = warps.concentric_sample_disk(u_pos)
        fr = make_frame(dd)
        poff = to_world(fr, jnp.stack(
            [disk[..., 0], disk[..., 1], jnp.zeros_like(disk[..., 0])], axis=-1)
        ) * em.bsphere_radius
        p_d = em.bsphere_center - dd * em.bsphere_radius + poff
        disk_area = _PI * em.bsphere_radius ** 2
        w_d = table_take(em.dir_intensity, ref) * disk_area
        p = jnp.where(m[:, None], p_d, p)
        nrm = jnp.where(m[:, None], dd, nrm)
        weight = jnp.where(m[:, None], w_d / jnp.maximum(sel_pdf, 1e-30)[:, None], weight)
        pdf_area = jnp.where(m, sel_pdf / disk_area, pdf_area)

    if em.has_env:
        m = kind == ATOM_ENV
        d_sph = warps.sample_uniform_sphere(u_pos)
        p_e = em.bsphere_center - d_sph * em.bsphere_radius
        area_sph = 4.0 * _PI * em.bsphere_radius ** 2
        if em.env_textured:
            w_e = jnp.full((n, 3), 1.0) * (area_sph / jnp.maximum(em.env_lum_int, 1e-30))
        else:
            w_e = jnp.broadcast_to(em.env_color, (n, 3)) * area_sph * _PI
        p = jnp.where(m[:, None], p_e, p)
        nrm = jnp.where(m[:, None], d_sph, nrm)
        weight = jnp.where(m[:, None], w_e / jnp.maximum(sel_pdf, 1e-30)[:, None], weight)
        pdf_area = jnp.where(m, sel_pdf / area_sph, pdf_area)

    return PositionSample(p=p, n=nrm, pdf_area=pdf_area,
                          weight=jnp.where(valid[:, None], weight, 0.0),
                          kind=kind, atom=atom, valid=valid)


def sample_emission_direction(em: EmitterTables, ps: PositionSample, u):
    """Direction from a sampled emission origin.

    Surface & constant-env: cosine about the normal (perfect IS, weight 1);
    point: uniform sphere; directional: deterministic.
    Returns (d_world [n,3], pdf [n], weight [n,3]).
    """
    d_loc = warps.cosine_sample_hemisphere(u)
    fr = make_frame(ps.n)
    d_cos = to_world(fr, d_loc)
    pdf = jnp.maximum(d_loc[..., 2], 0.0) / _PI
    weight = jnp.where((d_loc[..., 2] >= 0.0)[:, None], 1.0, 0.0) * jnp.ones_like(ps.p)

    m = ps.kind == ATOM_POINT
    d_sph = warps.sample_uniform_sphere(u)
    d = jnp.where(m[:, None], d_sph, d_cos)
    pdf = jnp.where(m, 1.0 / (4.0 * _PI), pdf)
    weight = jnp.where(m[:, None], 1.0, weight)

    m = ps.kind == ATOM_DIR
    d = jnp.where(m[:, None], ps.n, d)
    pdf = jnp.where(m, 1.0, pdf)
    weight = jnp.where(m[:, None], 1.0, weight)
    return d, pdf, weight


# ------------------------------------------------------------ ATS variants

def sample_light_ats(em: EmitterTables, geom, ats, p_ref, n_ref, u_sel, u_pos
                     ) -> LightSample:
    """NEE via the ATS light BVH: stochastic tree descent selects a triangle,
    then uniform area sampling on it (reference sample_light with ats,
    emitter.rs:1629-1648 + direct_sample_tri)."""
    from .ats import ats_sample

    tri, sel_pdf = ats_sample(ats, p_ref, n_ref, u_sel)
    ttake = make_taker(jnp.maximum(tri, 0), geom.n_pad)
    b = warps.uniform_sample_triangle(u_pos)
    fields = ["v0", "e1", "e2", "ng", "area", "le"]
    if em.has_em_uv:
        fields += ["vuv", "kind", "scale", "tex"]
    tc = _take_tri_cols(geom, em, ttake, fields)
    v0, e1, e2 = tc["v0"], tc["e1"], tc["e2"]
    p_tri = v0 + b[..., 0:1] * e1 + b[..., 1:2] * e2
    n_tri = tc["ng"]
    area = tc["area"]
    le = tc["le"]
    if em.has_em_uv:
        le = _emission_at(em, tc["kind"], tc["scale"], tc["tex"], le,
                          _tri_uv_at(tc["vuv"], b))

    delta_v = p_tri - p_ref
    dist = jnp.linalg.norm(delta_v, axis=-1)
    d = delta_v / jnp.maximum(dist, 1e-20)[:, None]
    cos_l = jnp.maximum(jnp.sum(n_tri * (-d), axis=-1), 0.0)
    g = jnp.where(dist > 0.0, cos_l / jnp.maximum(dist ** 2, 1e-20), 0.0)
    pdf_area = sel_pdf / jnp.maximum(area, 1e-20)
    pdf = jnp.where(g > 0.0, pdf_area * dist ** 2 / jnp.maximum(cos_l, 1e-20), 0.0)
    weight = jnp.where((g > 0.0)[:, None],
                       le * (g / jnp.maximum(pdf_area, 1e-30))[:, None], 0.0)
    valid = (g > 0.0) & (sel_pdf > 0.0) & (tri >= 0)
    return LightSample(p=p_tri, n=n_tri, d=d, dist=dist, pdf=pdf,
                       weight=jnp.where(valid[:, None], weight, 0.0),
                       is_delta=jnp.zeros_like(valid), valid=valid, tri=tri)


def direct_pdf_tri_ats(em: EmitterTables, geom, ats, tri_id, p_ref, p_hit,
                       n_hit, d):
    """Solid-angle NEE pdf under ATS selection (direct_pdf_tri x ats.pdf,
    emitter.rs:1567-1601; the reference passes n=None here)."""
    from .ats import ats_pdf

    sel = ats_pdf(ats, tri_id, p_ref, None)
    area_inv = table_take(ats.tri_area_inv, jnp.maximum(tri_id, 0))
    cos_l = jnp.maximum(jnp.sum(n_hit * (-d), axis=-1), 0.0)
    dist2 = jnp.sum((p_hit - p_ref) ** 2, axis=-1)
    pdf = jnp.where(cos_l > 0.0,
                    sel * area_inv * dist2 / jnp.maximum(cos_l, 1e-20), 0.0)
    return jnp.where(tri_id >= 0, pdf, 0.0)
