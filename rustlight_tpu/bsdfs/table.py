"""Material table: all scene BSDFs as one dense SoA, dispatched by kind.

The reference models materials as `Box<dyn BSDF>` trait objects
(src/bsdfs/mod.rs:163-199). On the wavefront, virtual dispatch becomes a *table*: every
material archetype's parameters live in fixed columns and every lane evaluates
all (cheap) archetypes branch-free, blending by `kind` masks.

Blend materials (src/bsdfs/blend.rs) get a uniform treatment: every material
carries two sub-slots (sub_a, sub_b, blend_w). Non-blend materials point both
slots at themselves with weight 1, so a single code path computes
  f = w * f_atomic(sub_a) + (1-w) * f_atomic(sub_b)
for the whole wavefront with exactly 2x atomic cost and zero divergence.

Texturing (BSDFColor, src/bsdfs/mod.rs:11-121): the diffuse slot supports
constant / bitmap / checkerboard / grid; bitmap textures live in a scene-level
atlas of equally-sized images.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Any, List, Optional

import jax.numpy as jnp
import numpy as np

from ..utils import pytree

KIND_DIFFUSE = 0
KIND_PHONG = 1
KIND_GLASS = 2
KIND_METAL = 3
KIND_SUBSTRATE = 4
KIND_BLEND = 5

TEX_CONST = 0
TEX_BITMAP = 1
TEX_CHECKER = 2
TEX_GRID = 3

TRANSPORT_IMPORTANCE = 0  # camera paths (reference path.rs uses Importance)
TRANSPORT_RADIANCE = 1    # light/adjoint paths


@dataclass
class MaterialDesc:
    """Host-side material description; build_material_table flattens a list."""
    kind: int = KIND_DIFFUSE
    kd: Any = (0.8, 0.8, 0.8)        # diffuse albedo / checker color0
    ks: Any = (1.0, 1.0, 1.0)        # specular reflectance
    kt: Any = (1.0, 1.0, 1.0)        # transmittance (glass)
    exponent: float = 30.0           # phong
    weight_specular: float = 0.5     # phong lobe-selection probability
    eta: float = 1.5046 / 1.000277   # dielectric IOR ratio (bk7/air)
    eta_c: Any = (0.200438, 0.924033, 1.10221)   # conductor eta (Au-ish)
    k_c: Any = (3.91295, 2.45285, 2.14219)       # conductor k
    alpha: float = 0.0               # microfacet roughness; 0 => delta
    dist_ggx: bool = False           # False=Beckmann True=GGX
    # texture on the diffuse slot
    tex_kind: int = TEX_CONST
    tex_c1: Any = (0.2, 0.2, 0.2)
    tex_scale: Any = (1.0, 1.0)
    tex_offset: Any = (0.0, 0.0)
    tex_lw: float = 0.1
    tex_img: int = -1
    # blend
    sub_a: int = -1
    sub_b: int = -1
    blend_w: float = 1.0


@pytree.dataclass
class MaterialTable:
    kind: Any
    kd: Any
    ks: Any
    kt: Any
    exponent: Any
    weight_specular: Any
    eta: Any
    eta_c: Any
    k_c: Any
    alpha: Any
    dist_ggx: Any
    tex_kind: Any
    tex_c1: Any
    tex_scale: Any
    tex_offset: Any
    tex_lw: Any
    tex_img: Any
    sub_a: Any
    sub_b: Any
    blend_w: Any
    smooth: Any      # has a DELTA component -> NEE skipped (BSDFType::is_smooth)
    two_sided: Any   # normal auto-flip allowed (BSDF::is_twosided)
    textures: Optional[Any] = None   # [k, th, tw, 3] atlas or None


def _is_smooth(d: "MaterialDesc", mats: List["MaterialDesc"]) -> bool:
    if d.kind == KIND_GLASS:
        return True
    if d.kind == KIND_METAL:
        return d.alpha <= 0.0
    if d.kind == KIND_SUBSTRATE:
        return d.alpha <= 0.0  # DELTA|DIFFUSE counts as smooth in the reference
    if d.kind == KIND_BLEND:
        return _is_smooth(mats[d.sub_a], mats) or _is_smooth(mats[d.sub_b], mats)
    return False


def _is_two_sided(d: "MaterialDesc") -> bool:
    return d.kind != KIND_GLASS


def build_material_table(mats: List[MaterialDesc],
                         textures: Optional[np.ndarray] = None) -> MaterialTable:
    mats = list(mats)
    if not mats:
        mats = [MaterialDesc()]

    def col(f, dtype=np.float32):
        return np.asarray([f(m) for m in mats], dtype=dtype)

    n = len(mats)
    sub_a = np.asarray([m.sub_a if m.kind == KIND_BLEND else i for i, m in enumerate(mats)], np.int32)
    sub_b = np.asarray([m.sub_b if m.kind == KIND_BLEND else i for i, m in enumerate(mats)], np.int32)
    blend_w = np.asarray([m.blend_w if m.kind == KIND_BLEND else 1.0 for m in mats], np.float32)
    for i, m in enumerate(mats):
        if m.kind == KIND_BLEND:
            assert 0 <= m.sub_a < n and 0 <= m.sub_b < n
            assert mats[m.sub_a].kind != KIND_BLEND and mats[m.sub_b].kind != KIND_BLEND, \
                "nested blends unsupported (matches reference assertion)"

    return MaterialTable(
        kind=col(lambda m: m.kind, np.int32),
        kd=col(lambda m: m.kd),
        ks=col(lambda m: m.ks),
        kt=col(lambda m: m.kt),
        exponent=col(lambda m: m.exponent),
        weight_specular=col(lambda m: m.weight_specular),
        eta=col(lambda m: m.eta),
        eta_c=col(lambda m: m.eta_c),
        k_c=col(lambda m: m.k_c),
        alpha=col(lambda m: m.alpha),
        dist_ggx=col(lambda m: m.dist_ggx, bool),
        tex_kind=col(lambda m: m.tex_kind, np.int32),
        tex_c1=col(lambda m: m.tex_c1),
        tex_scale=col(lambda m: m.tex_scale),
        tex_offset=col(lambda m: m.tex_offset),
        tex_lw=col(lambda m: m.tex_lw),
        tex_img=col(lambda m: m.tex_img, np.int32),
        sub_a=sub_a,
        sub_b=sub_b,
        blend_w=blend_w,
        smooth=col(lambda m: _is_smooth(m, mats), bool),
        two_sided=col(lambda m: _is_two_sided(m), bool),
        textures=None if textures is None else np.asarray(textures, np.float32),
    )


# convenience constructors mirroring the reference material set

def diffuse(kd=(0.8, 0.8, 0.8), **kw) -> MaterialDesc:
    return MaterialDesc(kind=KIND_DIFFUSE, kd=kd, **kw)


def phong(kd=(0.5, 0.5, 0.5), ks=(0.5, 0.5, 0.5), exponent=30.0,
          weight_specular=None, **kw) -> MaterialDesc:
    if weight_specular is None:
        # lobe-selection probability from average reflectances (loader convention)
        s = float(np.mean(ks)); d = float(np.mean(kd))
        weight_specular = s / max(s + d, 1e-8)
    return MaterialDesc(kind=KIND_PHONG, kd=kd, ks=ks, exponent=exponent,
                        weight_specular=weight_specular, **kw)


def glass(int_ior=1.5046, ext_ior=1.000277, kt=(1, 1, 1), ks=(1, 1, 1), **kw) -> MaterialDesc:
    return MaterialDesc(kind=KIND_GLASS, kt=kt, ks=ks, eta=int_ior / ext_ior, **kw)


def metal(ks=(1, 1, 1), eta_c=(0.200438, 0.924033, 1.10221),
          k_c=(3.91295, 2.45285, 2.14219), alpha=0.0, dist_ggx=False, **kw) -> MaterialDesc:
    return MaterialDesc(kind=KIND_METAL, ks=ks, eta_c=eta_c, k_c=k_c,
                        alpha=alpha, dist_ggx=dist_ggx, **kw)


def substrate(kd=(0.5, 0.5, 0.5), ks=(0.04, 0.04, 0.04), alpha=0.1,
              dist_ggx=False, **kw) -> MaterialDesc:
    return MaterialDesc(kind=KIND_SUBSTRATE, kd=kd, ks=ks, alpha=alpha,
                        dist_ggx=dist_ggx, **kw)


def blend(a: int, b: int, weight: float) -> MaterialDesc:
    return MaterialDesc(kind=KIND_BLEND, sub_a=a, sub_b=b, blend_w=weight)
