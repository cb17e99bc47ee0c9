"""Counter-based RNG streams for wavefront rendering.

Replaces the reference's per-thread `SmallRng` sampler clones
(src/samplers/independent.rs) with a wavefront scheme: a *scalar* threefry key
plus a dimension counter. Each `next` call derives key ⊕ counter and generates
one uniform per wavefront lane in a single vectorized draw — no per-lane key
storage, deterministic for a given seed, and trivially jit/shard_map friendly.
"""
from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from . import pytree


@pytree.dataclass
class RngStream:
    key: Any      # raw uint32[2] threefry key
    counter: Any  # scalar int32 dimension counter


def make_stream(seed_or_key) -> RngStream:
    """Default threefry draws the same bits on every backend, so renders
    are reproducible across them up to float rounding.
    JAX_DEFAULT_PRNG_IMPL=rbg swaps in XLA's RngBitGenerator for every
    stream (bits are implementation-defined, so refs won't match; its speed
    on the H100 is not measured)."""
    if isinstance(seed_or_key, int):
        key = jax.random.PRNGKey(seed_or_key)
    else:
        key = seed_or_key
    return RngStream(key=key, counter=jnp.int32(0))


def _derived(stream: RngStream):
    return jax.random.fold_in(stream.key, stream.counter)


def stream_next(stream: RngStream, shape=()) -> Tuple[Any, RngStream]:
    """One uniform in [0,1) per lane; `shape` is the wavefront shape."""
    u = jax.random.uniform(_derived(stream), shape, dtype=jnp.float32)
    return u, stream.replace(counter=stream.counter + 1)


def stream_next2d(stream: RngStream, shape=()) -> Tuple[Any, RngStream]:
    """Two uniforms per lane, shaped [*shape, 2]."""
    u = jax.random.uniform(_derived(stream), tuple(shape) + (2,), dtype=jnp.float32)
    return u, stream.replace(counter=stream.counter + 1)


def stream_fold(stream: RngStream, data) -> RngStream:
    """Derive an independent sub-stream (e.g. per sample-pass or per device)."""
    return RngStream(key=jax.random.fold_in(stream.key, data), counter=jnp.int32(0))


@pytree.dataclass
class ArrayStream:
    """Primary-sample-space stream: dimensions read from an explicit array.

    The wavefront replacement for the reference's lazily-mutated replay
    sampler (src/samplers/mcmc.rs:69-221): every MCMC chain keeps a dense
    [n_dims] vector of primary samples; all chains advance in lockstep and a
    `stream_next` reads one column. Reading past n_dims wraps with a decorrelating
    hash-like reindex (matches the reference's fallback to fresh uniforms only
    in effect: wavefront integrators consume a fixed dimension count, so the
    wrap is a safety net)."""
    values: Any   # [n, d]
    counter: Any  # scalar int32


def make_array_stream(values) -> ArrayStream:
    return ArrayStream(values=values, counter=jnp.int32(0))


def _array_col(stream: ArrayStream, offset):
    d = stream.values.shape[1]
    idx = jnp.remainder(stream.counter + offset, d)
    return jax.lax.dynamic_index_in_dim(stream.values, idx, axis=1, keepdims=False)


def astream_next(stream: ArrayStream, shape=()):
    u = _array_col(stream, 0)
    return u, stream.replace(counter=stream.counter + 1)


def astream_next2d(stream: ArrayStream, shape=()):
    u = jnp.stack([_array_col(stream, 0), _array_col(stream, 1)], axis=-1)
    return u, stream.replace(counter=stream.counter + 2)


@pytree.dataclass
class StratifiedStream:
    """Wraps a base stream so the first NB_DIM 1D draws and first NB_DIM 2D
    draws are stratified over the sample-pass axis (reference
    src/samplers/stratified.rs with the CLI's nb_dim = 4,
    examples/cli.rs:891-894; dimensions count in consumption order, pixel
    jitter = 2D dim 0). The dim counters are DYNAMIC so the stream carries
    through `lax.while_loop` bodies; draws beyond NB_DIM blend back to the
    plain uniforms, matching the reference's fall-through past its tables."""
    inner: Any
    pixel_ids: Any  # [n] int32
    pass_idx: Any   # scalar
    spp: int = pytree.field(static=True)
    # PASS-INDEPENDENT key for the stratum permutations: inner.key is folded
    # per pass, so keying the permutation off it would redraw the (a, b)
    # permutation every pass and void the coverage guarantee
    base_key: Any = None
    d1: Any = None  # traced int32: 1D dims consumed
    d2: Any = None  # traced int32: 2D dims consumed

    def __post_init__(self):
        if self.base_key is None:
            object.__setattr__(self, "base_key", self.inner.key)
        if self.d1 is None:
            object.__setattr__(self, "d1", jnp.int32(0))
        if self.d2 is None:
            object.__setattr__(self, "d2", jnp.int32(0))


# polymorphic front-ends: integrators call these regardless of stream type
_orig_stream_next = stream_next
_orig_stream_next2d = stream_next2d


def stream_next(stream, shape=()):  # noqa: F811
    if isinstance(stream, ArrayStream):
        return astream_next(stream, shape)
    if isinstance(stream, StratifiedStream):
        from ..samplers.stratified import NB_DIM, stratified_1d
        u, inner = stream_next(stream.inner, shape)
        us = stratified_1d(stream.base_key, stream.pixel_ids,
                           stream.pass_idx, stream.spp, stream.d1, u)
        u = jnp.where(stream.d1 < NB_DIM, us, u)
        return u, stream.replace(inner=inner, d1=stream.d1 + 1)
    return _orig_stream_next(stream, shape)


def stream_next2d(stream, shape=()):  # noqa: F811
    if isinstance(stream, ArrayStream):
        return astream_next2d(stream, shape)
    if isinstance(stream, StratifiedStream):
        from ..samplers.stratified import NB_DIM, stratified_2d
        u, inner = stream_next2d(stream.inner, shape)
        us = stratified_2d(stream.base_key, stream.pixel_ids,
                           stream.pass_idx, stream.spp, stream.d2, u)
        u = jnp.where(stream.d2 < NB_DIM, us, u)
        return u, stream.replace(inner=inner, d2=stream.d2 + 1)
    return _orig_stream_next2d(stream, shape)
