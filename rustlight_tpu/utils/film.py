"""Film plane / AOV buffers.

Wavefront `BufferCollection` (reference src/integrators/mod.rs:48-216): the
film is a dict of dense [h, w, c] arrays. The reference's 16x16 block machinery
disappears — a wavefront splats into the whole film with one scatter-add, and
multi-device films merge with a single `psum`/`all_reduce`.
"""
from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
import numpy as np

from . import image as _image


class Film:
    """Host-side film: named AOV buffers + save/scale/merge utilities."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.buffers: Dict[str, np.ndarray] = {}

    def register(self, name: str = "primal", channels: int = 3) -> None:
        self.buffers[name] = np.zeros((self.height, self.width, channels), np.float32)

    def accumulate(self, name: str, values) -> None:
        self.buffers[name] += np.asarray(values, dtype=np.float32)

    def scale(self, s: float, name: str | None = None) -> None:
        for k in [name] if name else list(self.buffers):
            self.buffers[k] = self.buffers[k] * np.float32(s)

    def average_with(self, other: "Film", n_prev: int) -> None:
        """Running average over passes (reference avg.rs): self = (self*n + other)/(n+1)."""
        for k in self.buffers:
            self.buffers[k] = (self.buffers[k] * n_prev + other.buffers[k]) / (n_prev + 1)

    def save(self, path, name: str = "primal") -> None:
        _image.save(path, self.buffers[name])

    def dump_all(self, base_path: str, suffix: str = "") -> None:
        """Write every AOV as <stem>_<name><suffix><ext> (reference dump_all)."""
        from pathlib import Path
        p = Path(base_path)
        for k, v in self.buffers.items():
            _image.save(str(p.with_name(f"{p.stem}_{k}{suffix}{p.suffix}")), v)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.buffers[name]


def splat_add(film_img, pixel_ids, values, *, width: int):
    """Scatter-add lane contributions into a [h, w, c] device film.

    pixel_ids [n] int32 linear ids (y*width + x); values [n, c]. Duplicate ids
    accumulate (the wavefront replacement for the reference's mutex-merged blocks,
    P2/P6 in SURVEY.md §2.10).
    """
    h, w, c = film_img.shape
    flat = film_img.reshape(h * w, c)
    flat = flat.at[pixel_ids].add(values, mode="drop")
    return flat.reshape(h, w, c)


def accumulate_safe(values, finite_only: bool = True):
    """Zero out non-finite / negative splats (reference accumulate_safe :160-175)."""
    ok = jnp.all(jnp.isfinite(values) & (values >= 0.0), axis=-1, keepdims=True)
    return jnp.where(ok, values, 0.0)
