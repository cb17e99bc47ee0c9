"""Homogeneous participating medium + phase functions, wavefront-vectorized.

Reference: src/volume.rs. Distance sampling follows the same spectral
channel-selection scheme (tungsten convention): pick an RGB channel from the
random number, sample t ~ exp(sigma_t_c), and weight by
transmittance*sigma_s / pdf with the pdf averaged over channels. Returns both
the surface-clamped ("real") and unclamped ("continued") distances.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp

from ..utils import pytree
from ..utils import warps
from ..utils.frame import make_frame, to_world

_PI = jnp.pi

PHASE_ISOTROPIC = 0
PHASE_HG = 1


@pytree.dataclass
class HomogeneousVolume:
    sigma_a: Any   # [3]
    sigma_s: Any   # [3]
    phase_g: Any   # scalar; 0 => isotropic

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s


def make_volume(sigma_s, sigma_a=(0.0, 0.0, 0.0), g: float = 0.0) -> HomogeneousVolume:
    import numpy as _np
    return HomogeneousVolume(
        sigma_a=_np.asarray(sigma_a, _np.float32),
        sigma_s=_np.asarray(sigma_s, _np.float32),
        phase_g=_np.float32(g),
    )


# ------------------------------------------------------------ phase function

def phase_eval(g, wi, wo):
    """Phase value (scalar, gray); wi/wo both point away from the scatter point
    in the reference's convention (eval uses wi.dot(wo))."""
    cos = jnp.sum(wi * wo, axis=-1)
    iso = 1.0 / (4.0 * _PI)
    tmp = 1.0 + g * g + 2.0 * g * cos
    hg = (1.0 / (4.0 * _PI)) * (1.0 - g * g) / (tmp * jnp.sqrt(jnp.maximum(tmp, 1e-12)))
    return jnp.where(jnp.abs(g) < 1e-6, iso, hg)


def phase_pdf(g, wi, wo):
    return phase_eval(g, wi, wo)


def phase_sample(g, d_in, u):
    """Sample outgoing direction given incoming d_in (pointing toward the
    previous vertex). Perfect importance sampling: weight = 1."""
    gg = g
    sqr = (1.0 - gg * gg) / (1.0 - gg + 2.0 * gg * u[..., 0])
    cos_hg = (1.0 + gg * gg - sqr * sqr) / (2.0 * jnp.where(jnp.abs(gg) < 1e-6, 1.0, gg))
    cos_iso = 1.0 - 2.0 * u[..., 0]
    cos_t = jnp.where(jnp.abs(gg) < 1e-6, cos_iso, cos_hg)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * _PI * u[..., 1]
    local = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)
    d = to_world(make_frame(-d_in), local)
    pdf = phase_pdf(g, d_in, d)
    return d, jnp.ones(d.shape[:-1] + (3,), jnp.float32), pdf


# --------------------------------------------------------- distance sampling

class SampledDistance(NamedTuple):
    t: Any            # [n] real distance (clamped at surface)
    w: Any            # [n, 3] weight (Tr * sigma_s / pdf, or Tr/pdf if exited)
    continued_t: Any  # [n] unclamped distance
    continued_w: Any  # [n, 3]
    pdf: Any          # [n]
    exited: Any       # [n] bool — distance passed the surface hit


def volume_sample_distance(vol: HomogeneousVolume, tfar, u) -> SampledDistance:
    """Spectral channel-select free-flight sampling (reference volume.rs:95-135)."""
    sigma_t = vol.sigma_t
    sigma_s = vol.sigma_s
    comp = jnp.clip((u * 3.0).astype(jnp.int32), 0, 2)
    u2 = u * 3.0 - comp.astype(jnp.float32)
    s_c = jnp.where(comp == 0, sigma_t[0],
                    jnp.where(comp == 1, sigma_t[1], sigma_t[2]))
    t = -jnp.log(jnp.maximum(1.0 - u2, 1e-20)) / jnp.maximum(s_c, 1e-20)
    exited = t >= tfar
    t_min = jnp.minimum(t, tfar)

    tau = t_min[:, None] * sigma_t
    ctau = t[:, None] * sigma_t
    tr = jnp.exp(-tau)
    ctr = jnp.exp(-ctau)
    pdf_exit = jnp.mean(tr, axis=-1)
    pdf_inside = jnp.mean(sigma_t * tr, axis=-1)
    pdf = jnp.where(exited, pdf_exit, pdf_inside)
    w = jnp.where(exited[:, None], tr, sigma_s * tr) / jnp.maximum(pdf, 1e-30)[:, None]
    cw = (sigma_s * ctr) / jnp.maximum(jnp.mean(sigma_t * ctr, axis=-1), 1e-30)[:, None]
    return SampledDistance(t=t_min, w=w, continued_t=t, continued_w=cw,
                           pdf=pdf, exited=exited)


def transmittance(vol: HomogeneousVolume, dist):
    """exp(-sigma_t * dist); dist [n] -> [n, 3] (reference volume.rs:137-141)."""
    return jnp.exp(-vol.sigma_t * dist[..., None])


def distance_pdf(vol: HomogeneousVolume, dist, end_on_surface):
    tau = vol.sigma_t * dist[..., None]
    tr = jnp.exp(-tau)
    return jnp.where(end_on_surface, jnp.mean(tr, -1), jnp.mean(vol.sigma_t * tr, -1))
