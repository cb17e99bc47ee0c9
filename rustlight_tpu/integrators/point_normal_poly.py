"""Taylor-polynomial product distance sampling for single scattering.

Reference: src/integrators/explicit/point_normal_poly.rs (degree-6 Taylor
expansions of the transmittance / Henyey-Greenstein factors around theta=0 in
the equiangular angle parametrization, with closed-form CDFs) and
src/integrators/explicit/point_normal.rs:391-640,757-940 (TaylorSampling /
PointNormalSampling / PointNormalTaylorSampling: clamp-angle heuristics,
Newton CDF inversion, and the analytic a*cos+b*sin "point-normal" factor).

Wavefront differences: every sampler here is a set of pure per-lane
vectorized functions — setup products are [N]-shaped arrays, the Newton
inversion is a fixed-iteration bisection-safeguarded loop (lax.fori_loop)
instead of the reference's early-exit `newton_raphson_iterate`, and invalid
lanes carry a `valid` mask instead of returning Option::None (callers fall
back to plain equiangular sampling on those lanes, keeping sample and pdf
consistent for strategy-MIS).

The reference's Poly4 variants and the Tr*phase product polynomial
(point_normal_poly.rs tr_phase) are defined but never dispatched live (only
the commented-out KullaHybridSampling uses them), so only the live Poly6
`phase` and `tr` expansions are implemented here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


# ----------------------------------------------------------------- Poly6

def poly6_phase(g):
    """Degree-6 Taylor coefficients (around theta=0) of the reduced HG kernel
    1/(1+g^2+2g sin(theta))^(3/2)  (point_normal_poly.rs Poly6::phase)."""
    g = jnp.asarray(g, jnp.float32)
    h = 1.0 + g * g
    hs = jnp.sqrt(h)
    h32, h52, h72 = 1.0 / (h * hs), 1.0 / (h ** 2 * hs), 1.0 / (h ** 3 * hs)
    h92, h112 = 1.0 / (h ** 4 * hs), 1.0 / (h ** 5 * hs)
    h132, h152 = 1.0 / (h ** 6 * hs), 1.0 / (h ** 7 * hs)
    g2, g3, g4, g5 = g * g, g ** 3, g ** 4, g ** 5
    g6, g7, g8, g9 = g ** 6, g ** 7, g ** 8, g ** 9
    return (
        h32,
        -3.0 * h52 * g,
        7.5 * h72 * g2,
        0.5 * (g - 33.0 * g3 + g5) * h92,
        -0.625 * (4.0 * g2 - 55.0 * g4 + 4.0 * g6) * h112,
        (-0.025 * g + 8.65 * g3 - 69.275 * g5 + 8.65 * g7 - 0.025 * g9) * h132,
        (g2 * (1.0 / 3.0 - 24.916666666666664 * g2 + 137.1875 * g4
               - 24.916666666666664 * g6 + (1.0 / 3.0) * g8)) * h152,
    )


def poly6_tr(d_l, sigma_t):
    """Degree-6 Taylor coefficients of exp(-sigma_t*(d_l*tan t + d_l/cos t))
    around theta=0, up to a constant that cancels in the normalized pdf
    (point_normal_poly.rs Poly6::tr). `d_l` is per-lane."""
    x = d_l * sigma_t
    return (
        jnp.ones_like(x),
        -x,
        x * (-1.0 + x) / 2.0,
        -x * (-2.0 + x) * (-1.0 + x) / 6.0,
        x * (-5.0 + x * (11.0 + x * (-6.0 + x))) / 24.0,
        -x * (16.0 + x * (-45.0 + x * (35.0 + x * (-10.0 + x)))) / 120.0,
        x * (-61.0 + x * (211.0 + x * (-210.0 + x * (85.0 + x * (-15.0 + x)))))
        / 720.0,
    )


def poly_eval(c, x):
    acc = c[-1] * jnp.ones_like(x)
    for ci in reversed(c[:-1]):
        acc = acc * x + ci
    return acc


def poly_cdf(c, x):
    """∫_0^x poly — term-wise integration (Poly6::cdf), Horner on the
    integrated coefficients c_i/(i+1)."""
    acc = (c[-1] / len(c)) * jnp.ones_like(x)
    for i in range(len(c) - 2, -1, -1):
        acc = acc * x + c[i] / (i + 1.0)
    return acc * x


def poly_cdf_pn(c, a, b, min_theta, max_theta):
    """Closed form of ∫ poly(t)·(a·cos t + b·sin t) dt over [min,max]
    (Poly6::cdf_pn — repeated integration by parts folded into two
    polynomials multiplying cos/sin at the endpoints)."""
    t = c
    c1 = (
        -(b * t[0]) + a * t[1] - 6.0 * a * (t[3] - 20.0 * t[5])
        + 2.0 * b * (t[2] - 12.0 * t[4] + 360.0 * t[6]),
        -(b * t[1]) + 2.0 * a * t[2] + 6.0 * b * (t[3] - 20.0 * t[5])
        - 24.0 * a * (t[4] - 30.0 * t[6]),
        -(b * t[2]) + 3.0 * a * t[3] - 60.0 * a * t[5]
        + 12.0 * b * (t[4] - 30.0 * t[6]),
        -(b * t[3]) + 4.0 * a * t[4] + 20.0 * b * t[5] - 120.0 * a * t[6],
        -(b * t[4]) + 5.0 * a * t[5] + 30.0 * b * t[6],
        -(b * t[5]) + 6.0 * a * t[6],
        -(b * t[6]),
    )
    c2 = (
        a * t[0] + b * t[1] - 6.0 * b * (t[3] - 20.0 * t[5])
        - 2.0 * a * (t[2] - 12.0 * t[4] + 360.0 * t[6]),
        a * t[1] + 2.0 * b * t[2] - 6.0 * a * (t[3] - 20.0 * t[5])
        - 24.0 * b * (t[4] - 30.0 * t[6]),
        a * t[2] + 3.0 * b * t[3] - 60.0 * b * t[5]
        - 12.0 * a * (t[4] - 30.0 * t[6]),
        a * t[3] + 4.0 * b * t[4] - 20.0 * a * t[5] - 120.0 * b * t[6],
        a * t[4] + 5.0 * b * t[5] - 30.0 * a * t[6],
        a * t[5] + 6.0 * b * t[6],
        a * t[6],
    )
    return (poly_eval(c1, max_theta) * jnp.cos(max_theta)
            - poly_eval(c1, min_theta) * jnp.cos(min_theta)
            + poly_eval(c2, max_theta) * jnp.sin(max_theta)
            - poly_eval(c2, min_theta) * jnp.sin(min_theta))


# ----------------------------------------------- clamp-angle heuristics

def clamp_angle_tr(sigma_t, d_l):
    """Fitted domain clamp for the Tr expansion (point_normal.rs:391-394)."""
    return jnp.exp(0.210824 - 0.15974 * d_l * sigma_t)


def clamp_angle_phase(g):
    """Fitted domain clamp for the HG expansion (point_normal.rs:395-399)."""
    return (18.8217 - 93.8831 * g + 184.173 * g ** 2 - 160.212 * g ** 3
            + 51.7683 * g ** 4)


# ----------------------------------------------- safeguarded Newton

def _newton_invert(cdf_fn, pdf_fn, lo, hi, target, iters: int = 20):
    """Solve cdf_fn(x) == target on [lo, hi], fixed-iteration Newton with
    bisection safeguard (vectorized analogue of math::newton_raphson_iterate,
    reference src/math.rs)."""
    x = 0.5 * (lo + hi)

    def body(_, carry):
        x, lo, hi = carry
        f = cdf_fn(x) - target
        lo = jnp.where(f < 0, x, lo)
        hi = jnp.where(f > 0, x, hi)
        df = pdf_fn(x)
        x_new = x - f / jnp.where(jnp.abs(df) > 1e-10, df, 1.0)
        bad = (x_new <= lo) | (x_new >= hi) | (~jnp.isfinite(x_new)) \
            | (jnp.abs(df) <= 1e-10)
        return jnp.where(bad, 0.5 * (lo + hi), x_new), lo, hi

    x, _, _ = jax.lax.fori_loop(0, iters, body, (x, lo, hi))
    return x


# --------------------------------------------------- TaylorSampling (eq)

def taylor_setup(c, theta_a, theta_b, clamp_angle):
    """Per-lane mixture setup (TaylorSampling::new, point_normal.rs:410-455):
    poly-CDF sampling on [theta_a, clamp] + uniform tail on [clamp, theta_b].
    Returns a dict of per-lane arrays incl. `valid`."""
    clamp = jnp.clip(clamp_angle, theta_a, theta_b)
    cdf_a = poly_cdf(c, theta_a)
    norm = poly_cdf(c, clamp) - cdf_a
    nn = jnp.maximum(norm, 0.0)
    pdf_cl = jnp.maximum(poly_eval(c, clamp), 0.0)
    cdf_other = pdf_cl * (theta_b - clamp)
    denom = nn + cdf_other
    prob_poly = jnp.where(denom > 0.0, nn / jnp.maximum(denom, 1e-30), 0.0)
    # clamp==theta_a degenerates to pure uniform (valid); otherwise the poly
    # region must have positive mass somewhere in the mixture
    valid = denom > 0.0
    return dict(clamp=clamp, cdf_a=cdf_a, norm=nn, prob_poly=prob_poly,
                valid=valid, theta_a=theta_a, theta_b=theta_b)


def taylor_sample(c, st, u):
    """(theta, pdf_angular) — both mixture branches evaluated, mask-selected
    (TaylorSampling::sample, point_normal.rs:457-512)."""
    prob = st["prob_poly"]
    take_poly = u < prob
    # poly branch: invert the normalized CDF on [theta_a, clamp]
    u_p = jnp.clip(u / jnp.maximum(prob, 1e-12), 0.0, 1.0)
    nrm = jnp.maximum(st["norm"], 1e-30)
    theta_p = _newton_invert(
        lambda v: (poly_cdf(c, v) - st["cdf_a"]) / nrm,
        lambda v: poly_eval(c, v) / nrm,
        st["theta_a"], st["clamp"], u_p)
    pdf_p = prob * jnp.maximum(poly_eval(c, theta_p), 0.0) / nrm
    # uniform tail
    u_u = jnp.clip((u - prob) / jnp.maximum(1.0 - prob, 1e-12), 0.0, 1.0)
    rng = jnp.maximum(st["theta_b"] - st["clamp"], 1e-12)
    theta_u = st["clamp"] + u_u * rng
    pdf_u = (1.0 - prob) / rng
    theta = jnp.where(take_poly, theta_p, theta_u)
    pdf = jnp.where(take_poly, pdf_p, pdf_u)
    return theta, pdf


def taylor_pdf(c, st, theta):
    """Angular mixture pdf at theta (for strategy-MIS; the reference leaves
    DistanceSampling::pdf unimplemented because it never MIS-combines the
    Taylor strategy — here it is derivable, so we provide it)."""
    in_dom = (theta >= st["theta_a"]) & (theta <= st["theta_b"])
    nrm = jnp.maximum(st["norm"], 1e-30)
    pdf_p = st["prob_poly"] * jnp.maximum(poly_eval(c, theta), 0.0) / nrm
    rng = jnp.maximum(st["theta_b"] - st["clamp"], 1e-12)
    pdf_u = (1.0 - st["prob_poly"]) / rng
    pdf = jnp.where(theta <= st["clamp"], pdf_p, pdf_u)
    return jnp.where(in_dom & st["valid"], pdf, 0.0)


# -------------------------------------- PointNormalSampling (a·cos+b·sin)

def pn_coeffs(o, d, p_light, n_light, delta, d_l):
    """Raw point-normal factors a,b with pdf_ang ∝ a·cos(theta)+b·sin(theta)
    (PointNormalSampling::new, point_normal.rs:661-687)."""
    dd = (o + d * delta[:, None] - p_light) / jnp.maximum(d_l, 1e-20)[:, None]
    a = jnp.sum(n_light * dd, -1)
    b = jnp.sum(n_light * d, -1)
    return a, b


def pn_norm(a, b, theta_a, theta_b):
    return (a * (jnp.sin(theta_b) - jnp.sin(theta_a))
            - b * (jnp.cos(theta_b) - jnp.cos(theta_a)))


def pn_invert(a, b, theta_a, theta_b, u):
    """Closed-form inversion of the normalized a·cos+b·sin CDF on
    [theta_a, theta_b]; a,b must be normalized so the CDF spans [0,1]
    (PointNormalSampling::sample, point_normal.rs:707-731)."""
    s2 = u + a * jnp.sin(theta_a) - b * jnp.cos(theta_a)
    v = jnp.sqrt(jnp.maximum(a * a + b * b - s2 * s2, 0.0))
    sgn = jnp.where(a >= 0.0, 1.0, -1.0)
    q, r = a * s2, b * v * sgn
    s, t = -b * s2, v * jnp.abs(a)
    sol1 = jnp.arctan2(q + r, s + t)
    ok1 = (sol1 >= theta_a) & (sol1 <= theta_b)
    sol = jnp.where(ok1, sol1, jnp.arctan2(q - r, s - t))
    return jnp.clip(sol, theta_a, theta_b)


# ------------------------------------- PointNormalTaylorSampling (pn×poly)

def pn_taylor_setup(c, a0, b0, theta_a, theta_b, clamp_angle):
    """Mixture of poly(theta)·(a·cos+b·sin) on [theta_a, clamp] (Newton on
    the closed-form cdf_pn) and plain point-normal on [clamp, theta_b]
    (PointNormalTaylorSampling::new, point_normal.rs:770-857). a0,b0 raw."""
    clamp = jnp.clip(clamp_angle, theta_a, theta_b)
    has_poly = clamp > theta_a + 1e-7
    has_other = theta_b > clamp + 1e-7

    norm_pp = pn_norm(a0, b0, theta_a, clamp)          # poly-region pn norm
    safe_pp = jnp.where(jnp.abs(norm_pp) > 1e-20, norm_pp, 1.0)
    a_p, b_p = a0 / safe_pp, b0 / safe_pp
    norm_poly = jnp.where(has_poly & (norm_pp > 0.0),
                          poly_cdf_pn(c, a_p, b_p, theta_a, clamp), 0.0)
    norm_poly = jnp.maximum(norm_poly, 0.0)

    norm_o = pn_norm(a0, b0, clamp, theta_b)           # tail pn norm
    safe_o = jnp.where(jnp.abs(norm_o) > 1e-20, norm_o, 1.0)
    a_o, b_o = a0 / safe_o, b0 / safe_o

    pdf_cl = jnp.maximum(poly_eval(c, clamp), 0.0) * jnp.maximum(
        a_p * jnp.cos(clamp) + b_p * jnp.sin(clamp), 0.0)
    cdf_other = jnp.where(has_other & (norm_o > 0.0),
                          pdf_cl * (theta_b - clamp), 0.0)
    denom = norm_poly + cdf_other
    prob_poly = jnp.where(denom > 0.0, norm_poly / jnp.maximum(denom, 1e-30),
                          jnp.where(has_other & (norm_o > 0.0), 0.0, jnp.nan))
    # lanes where neither branch has positive mass are invalid
    valid = (denom > 0.0) | (has_other & (norm_o > 0.0))
    prob_poly = jnp.where(valid, jnp.nan_to_num(prob_poly), 0.0)
    return dict(clamp=clamp, a_p=a_p, b_p=b_p, norm_poly=norm_poly,
                a_o=a_o, b_o=b_o, prob_poly=prob_poly, valid=valid,
                theta_a=theta_a, theta_b=theta_b)


def pn_taylor_sample(c, st, u):
    """(theta, pdf_angular) (PointNormalTaylorSampling::sample,
    point_normal.rs:859-940)."""
    prob = st["prob_poly"]
    take_poly = u < prob
    nrm = jnp.maximum(st["norm_poly"], 1e-30)
    a_p, b_p = st["a_p"], st["b_p"]
    u_p = jnp.clip(u / jnp.maximum(prob, 1e-12), 0.0, 1.0)
    theta_p = _newton_invert(
        lambda v: poly_cdf_pn(c, a_p, b_p, st["theta_a"], v) / nrm,
        lambda v: poly_eval(c, v) * (a_p * jnp.cos(v) + b_p * jnp.sin(v)) / nrm,
        st["theta_a"], st["clamp"], u_p)
    pdf_p = prob * jnp.maximum(
        poly_eval(c, theta_p) * (a_p * jnp.cos(theta_p)
                                 + b_p * jnp.sin(theta_p)), 0.0) / nrm

    u_u = jnp.clip((u - prob) / jnp.maximum(1.0 - prob, 1e-12), 0.0, 1.0)
    theta_u = pn_invert(st["a_o"], st["b_o"], st["clamp"], st["theta_b"], u_u)
    pdf_u = (1.0 - prob) * jnp.abs(st["a_o"] * jnp.cos(theta_u)
                                   + st["b_o"] * jnp.sin(theta_u))
    theta = jnp.where(take_poly, theta_p, theta_u)
    pdf = jnp.where(take_poly, pdf_p, pdf_u)
    return jnp.clip(theta, st["theta_a"], st["theta_b"]), pdf


def pn_taylor_pdf(c, st, theta):
    """Angular pdf (PointNormalTaylorSampling::pdf_normalized,
    point_normal.rs:771-781)."""
    in_dom = (theta >= st["theta_a"]) & (theta <= st["theta_b"])
    nrm = jnp.maximum(st["norm_poly"], 1e-30)
    pdf_p = st["prob_poly"] * jnp.maximum(
        poly_eval(c, theta) * (st["a_p"] * jnp.cos(theta)
                               + st["b_p"] * jnp.sin(theta)), 0.0) / nrm
    pdf_u = (1.0 - st["prob_poly"]) * jnp.abs(
        st["a_o"] * jnp.cos(theta) + st["b_o"] * jnp.sin(theta))
    pdf = jnp.where(theta <= st["clamp"], pdf_p, pdf_u)
    return jnp.where(in_dom & st["valid"], pdf, 0.0)
