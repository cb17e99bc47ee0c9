"""Table gathers as one-hot matrix products.

The renderer's hot tables (materials, triangles, emitter atoms) are small,
so gathers below MAX_ONEHOT_ROWS rows are one-hot matmuls:
onehot(idx) [n, t] @ table [t, c]. The form was chosen on the machine the
renderer first ran on, where row gathers were serial; on the H100 a native
row gather may well be faster, which is not yet measured.

`make_taker` builds the one-hot once per (index-array, table-set) site and
reuses it across every column gathered with the same indices — the dominant
pattern in fill_hit / material fetch / emitter sampling.

Precision: the one-hot operand is exact 0/1; f32 matmul with
Precision.HIGHEST is ~f32-accurate (error-free for selection up to final
rounding; never TF32); ints/bools below 2^24 round-trip exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Tables up to MAX_ONEHOT_ROWS rows gather by one one-hot matmul; up to
# MAX_CHUNKED_ROWS by a scan of one-hot matmuls over 4096-row chunks (cost
# grows with the chunk count); larger tables by XLA's native row gather,
# which is exact for every dtype. Both limits are not yet tuned on the H100.
MAX_ONEHOT_ROWS = 4096
MAX_CHUNKED_ROWS = 32768


def make_taker(idx, n_rows: int):
    """Return take(table) gathering table rows at `idx` (1-D int array).

    Indices are clipped to range; callers mask invalid lanes themselves.
    """
    idx = jnp.clip(idx, 0, n_rows - 1).astype(jnp.int32)
    if n_rows > MAX_CHUNKED_ROWS:
        def take_native(table):
            assert table.shape[0] == n_rows, (table.shape[0], n_rows)
            return jnp.take(table, idx, axis=0)
        return take_native
    if n_rows > MAX_ONEHOT_ROWS:
        # chunked one-hot: scan 4096-row blocks and accumulate the (single)
        # matching block's contribution — ceil(T/4096) matmuls
        n_chunks = (n_rows + MAX_ONEHOT_ROWS - 1) // MAX_ONEHOT_ROWS
        pad_rows = n_chunks * MAX_ONEHOT_ROWS

        def take_chunked(table):
            t = table.shape[0]
            assert t == n_rows, (t, n_rows)
            trailing = table.shape[1:]
            flat = table.reshape(t, -1)
            dt = flat.dtype
            f32 = flat.astype(jnp.float32) if dt != jnp.float32 else flat
            if pad_rows != n_rows:
                f32 = jnp.concatenate(
                    [f32, jnp.zeros((pad_rows - n_rows, f32.shape[1]),
                                    jnp.float32)], 0)
            blocks = f32.reshape(n_chunks, MAX_ONEHOT_ROWS, -1)
            iota = lax.broadcasted_iota(
                jnp.int32, (idx.shape[0], MAX_ONEHOT_ROWS), 1)

            def body(acc, args):
                blk, base = args
                oh = ((idx[:, None] - base) == iota).astype(jnp.float32)
                return acc + jnp.dot(oh, blk,
                                     precision=lax.Precision.HIGHEST), None

            bases = (lax.iota(jnp.int32, n_chunks) * MAX_ONEHOT_ROWS)
            acc0 = jnp.zeros((idx.shape[0], f32.shape[1]), jnp.float32)
            vals, _ = lax.scan(body, acc0, (blocks, bases))
            if dt == jnp.bool_:
                out = vals > 0.5
            elif jnp.issubdtype(dt, jnp.integer):
                out = jnp.round(vals).astype(dt)
            else:
                out = vals
            return out.reshape(idx.shape + trailing)

        return take_chunked

    iota = lax.broadcasted_iota(jnp.int32, (idx.shape[0], n_rows), 1)
    oh = (idx[:, None] == iota).astype(jnp.float32)

    def take(table):
        t = table.shape[0]
        assert t == n_rows, (t, n_rows)
        trailing = table.shape[1:]
        flat = table.reshape(t, -1)
        if flat.dtype == jnp.bool_:
            vals = jnp.dot(oh, flat.astype(jnp.float32),
                           precision=lax.Precision.HIGHEST)
            out = vals > 0.5
        elif jnp.issubdtype(flat.dtype, jnp.integer):
            vals = jnp.dot(oh, flat.astype(jnp.float32),
                           precision=lax.Precision.HIGHEST)
            out = jnp.round(vals).astype(table.dtype)
        else:
            out = jnp.dot(oh, flat, precision=lax.Precision.HIGHEST)
        return out.reshape(idx.shape + trailing)

    return take


def table_take(table, idx, axis: int = 0):
    """Drop-in for jnp.take(table, idx, axis=0) with clipped indices."""
    assert axis == 0
    shape = idx.shape
    take = make_taker(idx.reshape(-1), table.shape[0])
    out = take(table)
    return out.reshape(shape + table.shape[1:])
