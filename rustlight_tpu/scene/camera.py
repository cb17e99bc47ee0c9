"""Perspective pinhole camera.

Equivalent of the reference camera (src/camera.rs:5-150): sample-space
[0,1)^2 <-> camera space via a perspective projection, plus the adjoint
`sample_direct` (world point -> pixel + importance W_e) used by light tracing
and VPL splatting. Matrices are built host-side (numpy); per-ray math is
batched jnp and jit-friendly.
"""
from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils import pytree


def _perspective(fov_rad: float, near: float, far: float) -> np.ndarray:
    """OpenGL-style perspective matrix with aspect 1 (cgmath `perspective`)."""
    f = 1.0 / np.tan(fov_rad / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def _scale(x, y, z) -> np.ndarray:
    return np.diag([x, y, z, 1.0]).astype(np.float32)


def _translate(x, y, z) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def look_at(origin, target, up) -> np.ndarray:
    """Camera-to-world matrix with -z... matching cgmath/Mitsuba convention:
    camera looks down +z in its local frame after the sample->camera transform
    (the reference's `generate` normalizes near-plane points with positive z).
    """
    origin = np.asarray(origin, np.float32)
    d = np.asarray(target, np.float32) - origin
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float32)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


@pytree.dataclass
class Camera:
    """Device-side camera tables. Static ints live in the treedef (static fields)."""
    width: int = pytree.field(static=True)
    height: int = pytree.field(static=True)
    sample_to_camera: Any  # [4,4]
    camera_to_sample: Any  # [4,4]
    to_world: Any          # [4,4]
    to_local: Any          # [4,4]
    image_rect_min: Any    # [2]
    image_rect_max: Any    # [2]
    # construction parameters retained so the projection can be re-derived
    # for a new film size (see resize_camera); defaults keep older pickles /
    # direct constructions working
    fov: float = pytree.field(static=True, default=45.0)
    fov_axis: str = pytree.field(static=True, default="x")
    flip: bool = pytree.field(static=True, default=False)

    @property
    def position(self):
        return self.to_world[:3, 3]


def make_camera(width: int, height: int, fov: float, to_world: np.ndarray,
                fov_axis: str = "x", flip: bool = False) -> Camera:
    """fov in degrees. `fov_axis`/`flip` mirror the reference Fov::X/Y + flip flag."""
    aspect = width / height
    if fov_axis == "x":
        fov_rad = np.deg2rad(fov)
    else:
        fov_rad = np.deg2rad(fov * aspect)
    x_v = 1.0 if flip else -1.0
    camera_to_sample = (
        _scale(-0.5, -0.5 * aspect, 1.0)
        @ _translate(-1.0, -1.0 / aspect, 0.0)
        @ _perspective(fov_rad, 1e-2, 1000.0)
        @ _scale(x_v, 1.0, -1.0)
    )
    sample_to_camera = np.linalg.inv(camera_to_sample)

    def _xform_pt(m, p):
        q = m @ np.array([p[0], p[1], p[2], 1.0], np.float32)
        return q[:3] / q[3]

    p0 = _xform_pt(sample_to_camera, (0.0, 0.0, 0.0))
    p1 = _xform_pt(sample_to_camera, (1.0, 1.0, 0.0))
    zmin = min(p0[2], p1[2])
    rect_min = np.array([min(p0[0], p1[0]), min(p0[1], p1[1])], np.float32) / zmin
    rect_max = np.array([max(p0[0], p1[0]), max(p0[1], p1[1])], np.float32) / max(p0[2], p1[2])

    to_world = np.asarray(to_world, np.float32)
    # numpy leaves: the whole scene is device_put once at compile time
    return Camera(
        width=width, height=height,
        sample_to_camera=sample_to_camera.astype(np.float32),
        camera_to_sample=camera_to_sample.astype(np.float32),
        to_world=to_world,
        to_local=np.linalg.inv(to_world).astype(np.float32),
        image_rect_min=rect_min,
        image_rect_max=rect_max,
        fov=float(fov), fov_axis=fov_axis, flip=flip,
    )


def resize_camera(cam: Camera, width: int, height: int) -> Camera:
    """Re-derive the full projection for a new film size.

    `cam.replace(width=..., height=...)` only changes the static dims —
    `sample_to_camera`/`camera_to_sample` keep the ORIGINAL aspect ratio
    baked in, so renders of non-square scenes come out anamorphically
    distorted. This rebuilds the camera from its retained construction
    parameters (reference analog: Camera::scale_image re-derives matrices,
    camera.rs:73)."""
    return make_camera(width, height, cam.fov, np.asarray(cam.to_world),
                       fov_axis=cam.fov_axis, flip=cam.flip)


# f32 products at full precision: a default-precision f32 product may run
# in TF32 on the GPU and bend camera rays
_HIGHEST = lax.Precision.HIGHEST


def _transform_point(m, p):
    q = jnp.dot(p, m[:3, :3].T, precision=_HIGHEST) + m[:3, 3]
    w = jnp.dot(p, m[3:4, :3].T, precision=_HIGHEST) + m[3, 3]
    return q / w


def _transform_vector(m, v):
    return jnp.dot(v, m[:3, :3].T, precision=_HIGHEST)


def generate_rays(cam: Camera, px) -> Tuple[Any, Any]:
    """px [..., 2] continuous pixel coords -> (origins [..., 3], dirs [..., 3])."""
    s = jnp.stack(
        [px[..., 0] / cam.width, px[..., 1] / cam.height, jnp.zeros_like(px[..., 0])],
        axis=-1,
    )
    near_p = _transform_point(cam.sample_to_camera, s)
    d = near_p / jnp.linalg.norm(near_p, axis=-1, keepdims=True)
    d_world = _transform_vector(cam.to_world, d)
    o = jnp.broadcast_to(cam.position, d_world.shape)
    return o, d_world


def sample_direct(cam: Camera, p):
    """Splat world points to the image plane (reference camera.rs:94-138).

    Returns (importance [...] f32 — W_e / dist^2, zero if off-screen or behind,
             pixel [..., 2] continuous coords).
    """
    ref_p = _transform_point(cam.to_local, p)
    z_ok = ref_p[..., 2] > 0.0

    screen = _transform_point(cam.camera_to_sample, ref_p)
    sx, sy = screen[..., 0], screen[..., 1]
    on_screen = (sx >= 0.0) & (sx <= 1.0) & (sy >= 0.0) & (sy <= 1.0)
    pixel = jnp.stack([sx * cam.width, sy * cam.height], axis=-1)

    dist = jnp.linalg.norm(ref_p, axis=-1)
    inv_dist = 1.0 / jnp.maximum(dist, 1e-20)
    local_d = ref_p * inv_dist[..., None]

    cos_theta = local_d[..., 2]
    inv_ct = 1.0 / jnp.maximum(cos_theta, 1e-20)
    px_plane = local_d[..., 0] * inv_ct
    py_plane = local_d[..., 1] * inv_ct
    in_rect = (
        (px_plane >= cam.image_rect_min[0]) & (px_plane <= cam.image_rect_max[0])
        & (py_plane >= cam.image_rect_min[1]) & (py_plane <= cam.image_rect_max[1])
    )
    area = (cam.image_rect_max[0] - cam.image_rect_min[0]) * (
        cam.image_rect_max[1] - cam.image_rect_min[1]
    )
    importance = (1.0 / area) * inv_ct ** 3
    valid = z_ok & on_screen & in_rect & (cos_theta > 0.0)
    w = jnp.where(valid, importance * inv_dist * inv_dist, 0.0)
    return w, pixel
