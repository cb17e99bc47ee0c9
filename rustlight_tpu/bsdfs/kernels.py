"""Branch-free BSDF sample/eval/pdf over the wavefront.

All directions are in the local shading frame (+z = shading normal), wi points
away from the surface toward the previous vertex — the reference's convention
(src/bsdfs/mod.rs:163-199). `eval` returns f·|cosθo| (cosine included) and
`sample` returns weight = f·cos/pdf, matching the reference's SampledDirection.

Every archetype evaluates for every lane and results blend by `kind` masks —
the wavefront replacement for trait-object dispatch. Guarded divisions keep masked
lanes NaN-free.

Known deviation from the reference: rough-metal `sample` reports the
solid-angle pdf of wo (D(m)·cosθm / (4|wo·m|)); the reference returns the raw
half-vector pdf from its sample() (src/bsdfs/metal.rs:66) while its pdf()
method converts measures — an internal inconsistency we resolve in favor of
the correct measure (weights are explicit either way, so estimators agree).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..ops.gather import make_taker, table_take
from ..utils.frame import make_frame, to_world
from ..utils.warps import cosine_sample_hemisphere
from .fresnel import fresnel_dielectric, fresnel_conductor, schlick_fresnel
from .microfacet import mf_eval, mf_pdf, mf_sample, mf_g
from .table import (
    MaterialTable, KIND_DIFFUSE, KIND_PHONG, KIND_GLASS, KIND_METAL,
    KIND_SUBSTRATE, TEX_CONST, TEX_BITMAP, TEX_CHECKER, TEX_GRID,
    TRANSPORT_RADIANCE,
)

_PI = jnp.pi
_INV_PI = 1.0 / jnp.pi


class BsdfSample(NamedTuple):
    wo: Any        # [n, 3] local outgoing direction
    weight: Any    # [n, 3] f*cos/pdf (zero where invalid)
    pdf: Any       # [n] solid-angle pdf, or discrete prob for delta lanes
    is_delta: Any  # [n] bool — this *sample* came from a delta lobe
    valid: Any     # [n] bool
    eta: Any       # [n] relative IOR of the sampled event


def _safe_div(a, b, eps=1e-20):
    return a / jnp.where(jnp.abs(b) > eps, b, jnp.where(b >= 0, eps, -eps))


def _gather(table: MaterialTable, idx):
    """Per-lane material rows (textures excluded — they stay scene-level).

    One one-hot matmul per column set (see ops/gather.py)."""
    taker = make_taker(idx, table.kind.shape[0])

    def take(x):
        return None if x is None else taker(x)
    return table.replace(
        kind=take(table.kind), kd=take(table.kd), ks=take(table.ks), kt=take(table.kt),
        exponent=take(table.exponent), weight_specular=take(table.weight_specular),
        eta=take(table.eta), eta_c=take(table.eta_c), k_c=take(table.k_c),
        alpha=take(table.alpha), dist_ggx=take(table.dist_ggx),
        tex_kind=take(table.tex_kind), tex_c1=take(table.tex_c1),
        tex_scale=take(table.tex_scale), tex_offset=take(table.tex_offset),
        tex_lw=take(table.tex_lw), tex_img=take(table.tex_img),
        sub_a=take(table.sub_a), sub_b=take(table.sub_b), blend_w=take(table.blend_w),
        smooth=take(table.smooth), two_sided=take(table.two_sided),
        textures=table.textures,
    )


def diffuse_color(p, uv):
    """Evaluate the (possibly textured) diffuse slot at uv [n, 2]."""
    c = p.kd
    su = uv * p.tex_scale + p.tex_offset

    # checkerboard (reference mod.rs:40-66; Rust `as i32` truncation + signed %)
    cx = jnp.fmod(jnp.trunc(su[..., 0] * 2.0), 2.0) * 2.0 - 1.0
    cy = jnp.fmod(jnp.trunc(su[..., 1] * 2.0), 2.0) * 2.0 - 1.0
    checker = jnp.where((cx * cy == 1.0)[..., None], p.kd, p.tex_c1)
    c = jnp.where((p.tex_kind == TEX_CHECKER)[..., None], checker, c)

    # grid (line color0 over background color1)
    gx = su[..., 0] - jnp.floor(su[..., 0])
    gy = su[..., 1] - jnp.floor(su[..., 1])
    gx = jnp.where(gx > 0.5, gx - 1.0, gx)
    gy = jnp.where(gy > 0.5, gy - 1.0, gy)
    on_line = (jnp.abs(gx) < p.tex_lw) | (jnp.abs(gy) < p.tex_lw)
    grid = jnp.where(on_line[..., None], p.kd, p.tex_c1)
    c = jnp.where((p.tex_kind == TEX_GRID)[..., None], grid, c)

    if p.textures is not None:
        k, th, tw, _ = p.textures.shape
        fu = uv[..., 0] - jnp.floor(uv[..., 0])
        fv = uv[..., 1] - jnp.floor(uv[..., 1])
        xi = jnp.clip((fu * tw).astype(jnp.int32), 0, tw - 1)
        yi = jnp.clip(((1.0 - fv) * th).astype(jnp.int32), 0, th - 1)
        img_id = jnp.clip(p.tex_img, 0, k - 1)
        texel = p.textures[img_id, yi, xi]
        c = jnp.where((p.tex_kind == TEX_BITMAP)[..., None], texel, c)
    return c


def _reflect(d):
    return jnp.stack([-d[..., 0], -d[..., 1], d[..., 2]], axis=-1)


def _reflect_about(wi, m):
    return 2.0 * jnp.sum(wi * m, axis=-1, keepdims=True) * m - wi


def _half_vector(wi, wo):
    h = wi + wo
    hl = jnp.linalg.norm(h, axis=-1, keepdims=True)
    return h / jnp.maximum(hl, 1e-20), hl[..., 0] > 1e-20


# --------------------------------------------------------------- atomic eval

def _eval_atomic(p, kd, wi, wo, transport):
    """f·cos for non-blend archetypes; [n, 3]."""
    wiz, woz = wi[..., 2], wo[..., 2]
    front = (wiz > 0.0) & (woz > 0.0)

    f_diffuse = kd * (jnp.maximum(woz, 0.0) * _INV_PI)[..., None]

    # phong (src/bsdfs/phong.rs:94-121)
    a = jnp.maximum(jnp.sum(_reflect(wi) * wo, axis=-1), 0.0)
    spec = p.ks * (a ** p.exponent * (p.exponent + 2.0) / (2.0 * _PI))[..., None]
    f_phong = f_diffuse + spec

    # rough metal (src/bsdfs/metal.rs:110-155); f*cos = ks*F*D*G/(4 cos_i)
    h, h_ok = _half_vector(wi, wo)
    rough = p.alpha > 0.0
    d_mf = mf_eval(p.dist_ggx, jnp.maximum(p.alpha, 1e-4), h)
    g_mf = mf_g(p.dist_ggx, jnp.maximum(p.alpha, 1e-4), wi, wo, h)
    f_cond = fresnel_conductor(jnp.sum(wi * h, axis=-1), p.eta_c, p.k_c)
    f_metal = p.ks * f_cond * _safe_div(d_mf * g_mf, 4.0 * wiz)[..., None]
    f_metal = jnp.where((rough & h_ok)[..., None], f_metal, 0.0)

    # substrate / FresnelBlend (src/bsdfs/substrate.rs:150-205)
    diff_sub = (
        kd * (1.0 - p.ks) * (28.0 / (23.0 * _PI))
        * ((1.0 - (1.0 - 0.5 * jnp.abs(wiz)) ** 5)
           * (1.0 - (1.0 - 0.5 * jnp.abs(woz)) ** 5))[..., None]
    )
    denom = 4.0 * jnp.abs(jnp.sum(wi * h, axis=-1)) * jnp.maximum(jnp.abs(wiz), jnp.abs(woz))
    spec_sub = schlick_fresnel(p.ks, jnp.sum(wi * h, axis=-1)) * _safe_div(d_mf, denom)[..., None]
    spec_sub = jnp.where((rough & h_ok)[..., None], spec_sub, 0.0)
    f_substrate = (diff_sub + spec_sub) * woz[..., None]

    f = jnp.zeros_like(kd)
    f = jnp.where((p.kind == KIND_DIFFUSE)[..., None], f_diffuse, f)
    f = jnp.where((p.kind == KIND_PHONG)[..., None], f_phong, f)
    f = jnp.where((p.kind == KIND_METAL)[..., None], f_metal, f)
    f = jnp.where((p.kind == KIND_SUBSTRATE)[..., None], f_substrate, f)
    # glass: delta-only -> 0 in the solid-angle domain
    return jnp.where(front[..., None], f, 0.0)


def _pdf_atomic(p, wi, wo):
    """Solid-angle pdf for non-blend archetypes; [n]."""
    wiz, woz = wi[..., 2], wo[..., 2]
    front = (wiz > 0.0) & (woz > 0.0)
    cos_pdf = jnp.maximum(woz, 0.0) * _INV_PI

    a = jnp.maximum(jnp.sum(_reflect(wi) * wo, axis=-1), 0.0)
    pdf_phong = (
        p.weight_specular * a ** p.exponent * (p.exponent + 1.0) / (2.0 * _PI)
        + (1.0 - p.weight_specular) * cos_pdf
    )

    h, h_ok = _half_vector(wi, wo)
    rough = p.alpha > 0.0
    pdf_h = mf_pdf(p.dist_ggx, jnp.maximum(p.alpha, 1e-4), h)
    pdf_spec = _safe_div(pdf_h, 4.0 * jnp.abs(jnp.sum(wo * h, axis=-1)))
    pdf_metal = jnp.where(rough & h_ok, pdf_spec, 0.0)
    pdf_substrate = 0.5 * (cos_pdf + jnp.where(rough & h_ok, pdf_spec, 0.0))

    pdf = jnp.zeros_like(wiz)
    pdf = jnp.where(p.kind == KIND_DIFFUSE, cos_pdf, pdf)
    pdf = jnp.where(p.kind == KIND_PHONG, pdf_phong, pdf)
    pdf = jnp.where(p.kind == KIND_METAL, pdf_metal, pdf)
    pdf = jnp.where(p.kind == KIND_SUBSTRATE, pdf_substrate, pdf)
    return jnp.where(front, pdf, 0.0)


def _sample_atomic(p, kd, wi, u, transport):
    """Sample one direction per lane from the lane's atomic archetype."""
    wiz = wi[..., 2]
    ux, uy = u[..., 0], u[..., 1]

    # ---- diffuse
    wo_diff = cosine_sample_hemisphere(u)

    # ---- phong: lobe select on weight_specular (src/bsdfs/phong.rs:25-63)
    ws = p.weight_specular
    pick_spec = ux < ws
    ux_s = _safe_div(ux, ws)
    ux_d = _safe_div(ux - ws, 1.0 - ws)
    expo = p.exponent
    sin_a = jnp.sqrt(jnp.maximum(1.0 - uy ** (2.0 / (expo + 1.0)), 0.0))
    cos_a = uy ** (1.0 / (expo + 1.0))
    phi = 2.0 * _PI * ux_s
    lobe = jnp.stack([sin_a * jnp.cos(phi), sin_a * jnp.sin(phi), cos_a], axis=-1)
    wo_spec = to_world(make_frame(_reflect(wi)), lobe)
    wo_phong_d = cosine_sample_hemisphere(jnp.stack([ux_d, uy], axis=-1))
    wo_phong = jnp.where(pick_spec[..., None], wo_spec, wo_phong_d)
    pdf_phong = _pdf_atomic(p.replace(kind=jnp.full_like(p.kind, KIND_PHONG)), wi, wo_phong)
    f_phong = _eval_atomic(p.replace(kind=jnp.full_like(p.kind, KIND_PHONG)), kd, wi, wo_phong, transport)
    w_phong = f_phong * _safe_div(1.0, pdf_phong)[..., None]
    ok_phong = (wo_phong[..., 2] > 0.0) & (pdf_phong > 0.0)

    # ---- glass (src/bsdfs/glass.rs:80-130)
    fr, cos_t = fresnel_dielectric(wiz, p.eta)
    pick_refl = ux <= fr
    inv_eta = 1.0 / p.eta
    scale = jnp.where(cos_t < 0.0, -inv_eta, -p.eta)
    wo_refr = jnp.stack([scale * wi[..., 0], scale * wi[..., 1], cos_t], axis=-1)
    factor = jnp.where(cos_t < 0.0, inv_eta, p.eta)
    if transport != TRANSPORT_RADIANCE:
        factor = jnp.ones_like(factor)
    wo_glass = jnp.where(pick_refl[..., None], _reflect(wi), wo_refr)
    w_glass = jnp.where(pick_refl[..., None], p.ks, p.kt * (factor ** 2)[..., None])
    pdf_glass = jnp.where(pick_refl, fr, 1.0 - fr)
    eta_glass = jnp.where(pick_refl, 1.0, jnp.where(cos_t < 0.0, p.eta, inv_eta))

    # ---- metal
    alpha = jnp.maximum(p.alpha, 1e-4)
    rough = p.alpha > 0.0
    m, pdf_m = mf_sample(p.dist_ggx, alpha, u)
    wo_mr = _reflect_about(wi, m)
    f_cond_m = fresnel_conductor(jnp.sum(wi * m, axis=-1), p.eta_c, p.k_c)
    d_m = mf_eval(p.dist_ggx, alpha, m)
    g_m = mf_g(p.dist_ggx, alpha, wi, wo_mr, m)
    w_mr = p.ks * f_cond_m * _safe_div(
        d_m * g_m * jnp.sum(wi * m, axis=-1), pdf_m * wiz)[..., None]
    pdf_mr = _safe_div(pdf_m, 4.0 * jnp.abs(jnp.sum(wo_mr * m, axis=-1)))
    ok_mr = (wo_mr[..., 2] > 0.0) & (pdf_m > 0.0)

    wo_ms = _reflect(wi)
    w_ms = p.ks * fresnel_conductor(wiz, p.eta_c, p.k_c)
    wo_metal = jnp.where(rough[..., None], wo_mr, wo_ms)
    w_metal = jnp.where(rough[..., None], w_mr, w_ms)
    pdf_metal = jnp.where(rough, pdf_mr, 1.0)
    ok_metal = jnp.where(rough, ok_mr, True)

    # ---- substrate: 0.5 diffuse / 0.5 specular (src/bsdfs/substrate.rs:22-90)
    pick_diff = ux < 0.5
    u_d = jnp.stack([ux * 2.0, uy], axis=-1)
    u_s = jnp.stack([(ux - 0.5) * 2.0, uy], axis=-1)
    wo_sub_d = cosine_sample_hemisphere(u_d)
    m_s, pdf_ms = mf_sample(p.dist_ggx, alpha, u_s)
    wo_sub_s = jnp.where(rough[..., None], _reflect_about(wi, m_s), _reflect(wi))
    wo_sub = jnp.where(pick_diff[..., None], wo_sub_d, wo_sub_s)
    kind_sub = p.replace(kind=jnp.full_like(p.kind, KIND_SUBSTRATE))
    # smooth specular half: delta lobe, pdf_discrete = 0.5, weight = schlick/0.5
    delta_sub = (~pick_diff) & (~rough)
    pdf_sub_sa = _pdf_atomic(kind_sub, wi, wo_sub)
    f_sub = _eval_atomic(kind_sub, kd, wi, wo_sub, transport)
    w_sub_sa = f_sub * _safe_div(1.0, pdf_sub_sa)[..., None]
    w_sub_delta = schlick_fresnel(p.ks, wiz) / 0.5
    w_sub = jnp.where(delta_sub[..., None], w_sub_delta, w_sub_sa)
    pdf_sub = jnp.where(delta_sub, 0.5, pdf_sub_sa)
    ok_sub = (wo_sub[..., 2] > 0.0) & (pdf_sub > 0.0) & (
        jnp.where(pick_diff | rough, pdf_sub_sa > 0.0, True))

    # ---- combine by kind
    kind = p.kind
    wo = wo_diff
    weight = kd
    pdf = jnp.maximum(wo_diff[..., 2], 0.0) * _INV_PI
    is_delta = jnp.zeros_like(wiz, dtype=bool)
    valid = wiz > 0.0

    def sel(k, wo_k, w_k, pdf_k, delta_k, ok_k):
        nonlocal wo, weight, pdf, is_delta, valid
        mask = kind == k
        wo = jnp.where(mask[..., None], wo_k, wo)
        weight = jnp.where(mask[..., None], w_k, weight)
        pdf = jnp.where(mask, pdf_k, pdf)
        is_delta = jnp.where(mask, delta_k, is_delta)
        valid = jnp.where(mask, ok_k, valid)

    t = jnp.ones_like(wiz, dtype=bool)
    sel(KIND_PHONG, wo_phong, w_phong, pdf_phong, ~t, ok_phong & (wiz > 0.0))
    sel(KIND_GLASS, wo_glass, w_glass, pdf_glass, t, t)
    sel(KIND_METAL, wo_metal, w_metal, pdf_metal, ~rough, ok_metal & (wiz > 0.0))
    sel(KIND_SUBSTRATE, wo_sub, w_sub, pdf_sub, delta_sub, ok_sub & (wiz > 0.0))

    eta = jnp.where(kind == KIND_GLASS, eta_glass, 1.0)
    weight = jnp.where(valid[..., None], weight, 0.0)
    return BsdfSample(wo=wo, weight=weight, pdf=pdf, is_delta=is_delta,
                      valid=valid, eta=eta)


# ------------------------------------------------------------------ public API

def bsdf_eval(table: MaterialTable, mat_id, uv, wi, wo,
              transport=0):
    """f·cos in the solid-angle domain for the whole wavefront; [n, 3]."""
    p = _gather(table, mat_id)
    pa = _gather(table, p.sub_a)
    pb = _gather(table, p.sub_b)
    w = p.blend_w[..., None]
    fa = _eval_atomic(pa, diffuse_color(pa, uv), wi, wo, transport)
    fb = _eval_atomic(pb, diffuse_color(pb, uv), wi, wo, transport)
    return w * fa + (1.0 - w) * fb


def bsdf_pdf(table: MaterialTable, mat_id, uv, wi, wo, transport=0):
    """Solid-angle pdf; [n]. Zero for delta lobes (they never MIS)."""
    p = _gather(table, mat_id)
    pa = _gather(table, p.sub_a)
    pb = _gather(table, p.sub_b)
    w = p.blend_w
    return w * _pdf_atomic(pa, wi, wo) + (1.0 - w) * _pdf_atomic(pb, wi, wo)


def bsdf_sample(table: MaterialTable, mat_id, uv, wi, u, transport=0) -> BsdfSample:
    """Importance-sample wo per lane. For blend lanes, the lobe is selected by
    blend_w with random-number reuse, then weight/pdf recombine over both
    sub-materials (reference src/bsdfs/blend.rs:9-95)."""
    p = _gather(table, mat_id)
    w = p.blend_w
    pick_a = u[..., 0] < w
    ux = jnp.where(pick_a, _safe_div(u[..., 0], w), _safe_div(u[..., 0] - w, 1.0 - w))
    u2 = jnp.stack([jnp.clip(ux, 0.0, 1.0 - 1e-7), u[..., 1]], axis=-1)
    chosen = jnp.where(pick_a, p.sub_a, p.sub_b)
    pc = _gather(table, chosen)
    s = _sample_atomic(pc, diffuse_color(pc, uv), wi, u2, transport)

    # Recombined pdf/weight across both slots (equals atomic when blend_w == 1)
    is_blend = w < 1.0
    pdf_mix = bsdf_pdf(table, mat_id, uv, wi, s.wo, transport)
    f_mix = bsdf_eval(table, mat_id, uv, wi, s.wo, transport)
    w_mix = f_mix * _safe_div(1.0, pdf_mix)[..., None]
    use_mix = is_blend & (~s.is_delta)
    pdf = jnp.where(use_mix, pdf_mix, s.pdf)
    weight = jnp.where(use_mix[..., None], w_mix, s.weight)
    valid = s.valid & jnp.where(use_mix, pdf_mix > 0.0, True)
    return BsdfSample(wo=s.wo, weight=jnp.where(valid[..., None], weight, 0.0),
                      pdf=pdf, is_delta=s.is_delta, valid=valid, eta=s.eta)


def bsdf_is_smooth(table: MaterialTable, mat_id):
    return table_take(table.smooth, mat_id)


def bsdf_two_sided(table: MaterialTable, mat_id):
    return table_take(table.two_sided, mat_id)
