"""Device->host readback helpers.

Every readback in this package goes through these helpers: buffer
prefixes are read as power-of-two bucketed slabs with a 128 KiB floor
(so the slicing programs compile once per bucket, not per length),
several carry buffers share one transfer, and scalars are packed into
one padded slab.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import _config  # noqa: F401

PAD_I32 = 1 << 15  # 32k int32 = 128 KiB


@functools.partial(jax.jit, static_argnames=("bucket",))
def _prefix_jit(buf, bucket: int):
    return jax.lax.dynamic_slice(buf, (0,), (bucket,))


def read_prefix(buf, n: int) -> np.ndarray:
    """Read the first n elements of a 1-D device buffer (bucketed)."""
    if n == 0:
        return np.empty(0, buf.dtype)
    bucket = PAD_I32
    while bucket < n:
        bucket <<= 1
    bucket = min(bucket, buf.shape[0])
    return np.asarray(_prefix_jit(buf, bucket))[:n]


@functools.partial(jax.jit, static_argnames=("bucket",))
def _prefixes_jit(bufs, bucket: int):
    rows = [
        jax.lax.dynamic_slice(
            jax.lax.bitcast_convert_type(b, jnp.uint32), (0,), (bucket,)
        )
        for b in bufs
    ]
    return jnp.stack(rows)


def read_prefixes(bufs, n: int) -> list[np.ndarray]:
    """Read the first n elements of several same-length 1-D 32-bit device
    buffers in ONE bucketed transfer instead of len(bufs)."""
    if n == 0:
        return [np.empty(0, b.dtype) for b in bufs]
    bucket = PAD_I32
    while bucket < n:
        bucket <<= 1
    bucket = min(bucket, bufs[0].shape[0])
    slab = np.asarray(_prefixes_jit(tuple(bufs), bucket))
    return [slab[i, :n].view(b.dtype) for i, b in enumerate(bufs)]


@jax.jit
def _pad_flat_jit(arr):
    flat = arr.ravel()
    if flat.size >= PAD_I32:
        return flat
    return jnp.zeros(PAD_I32, flat.dtype).at[: flat.size].set(flat)


def read_array(arr) -> np.ndarray:
    """Read a whole device array, padding tiny ones to the 128 KiB floor.

    Multi-controller (jax.distributed) arrays sharded over all hosts'
    devices are not fully addressable from any one process; every
    process gathers the full value so downstream host-side merges run
    replicated (the standard multi-controller pattern)."""
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.array(multihost_utils.process_allgather(arr, tiled=True))
    shape = arr.shape
    flat = np.asarray(_pad_flat_jit(arr))
    n = int(np.prod(shape)) if shape else 1
    return flat[:n].reshape(shape)


@jax.jit
def pack_scalars_jit(*scalars):
    out = jnp.zeros(PAD_I32, jnp.int32)
    for i, s in enumerate(scalars):
        out = out.at[i].set(s.astype(jnp.int32))
    return out


def read_scalars(*scalars) -> list[int]:
    """Read device scalars in one padded transfer."""
    packed = np.asarray(pack_scalars_jit(*scalars))
    return [int(packed[i]) for i in range(len(scalars))]
