"""Isotropic microfacet distributions (Beckmann + GGX), vectorized.

Reference behavior: src/bsdfs/distribution.rs:25-145. `dist_ggx` is a per-lane
bool so both models evaluate branch-free and blend by mask — the wavefront version of
the enum dispatch.
"""
from __future__ import annotations

import jax.numpy as jnp

_PI = jnp.pi


def mf_eval(dist_ggx, alpha, m):
    """D(m); m [..., 3] half-vector in local frame, alpha [...] roughness."""
    cz = m[..., 2]
    c2 = cz * cz
    safe_c2 = jnp.maximum(c2, 1e-20)
    a2 = alpha * alpha
    bexp = (m[..., 0] ** 2 + m[..., 1] ** 2) / jnp.maximum(a2, 1e-20) / safe_c2
    d_beck = jnp.exp(-bexp) / (_PI * jnp.maximum(a2, 1e-20) * safe_c2 * safe_c2)
    root = (1.0 + bexp) * safe_c2
    d_ggx = 1.0 / (_PI * jnp.maximum(a2, 1e-20) * root * root)
    d = jnp.where(dist_ggx, d_ggx, d_beck)
    d = jnp.where(cz > 0.0, d, 0.0)
    return jnp.where(d * cz < 1e-20, 0.0, d)


def mf_pdf(dist_ggx, alpha, m):
    return mf_eval(dist_ggx, alpha, m) * jnp.maximum(m[..., 2], 0.0)


def mf_sample(dist_ggx, alpha, u):
    """Sample half-vector m ~ D(m) cos; u [..., 2] -> (m, pdf)."""
    phi = 2.0 * _PI * u[..., 1]
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    a2 = jnp.maximum(alpha * alpha, 1e-20)
    ux = jnp.clip(u[..., 0], 0.0, 1.0 - 1e-7)

    # Beckmann
    tan2_b = a2 * (-jnp.log1p(-ux))
    cz_b = 1.0 / jnp.sqrt(1.0 + tan2_b)
    pdf_b = (1.0 - ux) / (_PI * a2 * cz_b ** 3)

    # GGX
    tan2_g = a2 * ux / (1.0 - ux)
    cz_g = 1.0 / jnp.sqrt(1.0 + tan2_g)
    tmp = 1.0 + tan2_g / a2
    pdf_g = 1.0 / (_PI * a2 * cz_g ** 3 * tmp * tmp)

    cz = jnp.where(dist_ggx, cz_g, cz_b)
    pdf = jnp.where(dist_ggx, pdf_g, pdf_b)
    pdf = jnp.where(pdf < 1e-20, 0.0, pdf)
    sz = jnp.sqrt(jnp.maximum(1.0 - cz * cz, 0.0))
    m = jnp.stack([sz * cp, sz * sp, cz], axis=-1)
    return m, pdf


def smith_g1(dist_ggx, alpha, v, m):
    """Smith shadowing-masking for one direction."""
    vz = v[..., 2]
    chi = (jnp.sum(v * m, axis=-1) * vz) > 0.0
    sin2 = jnp.maximum(1.0 - vz * vz, 0.0)
    tan_t = jnp.sqrt(sin2) / jnp.where(jnp.abs(vz) > 1e-20, jnp.abs(vz), 1e-20)

    # Beckmann rational approximation
    a = 1.0 / jnp.maximum(alpha * tan_t, 1e-20)
    a_sqr = a * a
    g_b = jnp.where(a >= 1.6, 1.0,
                    (3.535 * a + 2.181 * a_sqr) / (1.0 + 2.276 * a + 2.577 * a_sqr))
    # GGX
    root = alpha * tan_t
    g_g = 2.0 / (1.0 + jnp.sqrt(1.0 + root * root))

    g = jnp.where(dist_ggx, g_g, g_b)
    g = jnp.where(tan_t == 0.0, 1.0, g)
    return jnp.where(chi, g, 0.0)


def mf_g(dist_ggx, alpha, wi, wo, m):
    return smith_g1(dist_ggx, alpha, wi, m) * smith_g1(dist_ggx, alpha, wo, m)
