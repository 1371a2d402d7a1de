"""The collectives of a mesh axis, over a list of shards — the port's
counterparts of ``jax.lax.all_to_all(tiled=True)``, ``ppermute``,
``psum``, ``all_gather`` and ``axis_index``, which the JAX package's
``parallel/sharded.py`` and ``ops/fft_sharded.py`` call inside
``shard_map``.

A shard list holds one tensor per device along the axis, in axis order;
each shard's device is its place. Data moves with ``.to(device)``, so on
a mesh whose places share one card an exchange is a device-to-device copy
there, and across cards a peer copy."""

from __future__ import annotations

import torch


def axis_index(shards):
    """Each place's index along the axis."""
    return list(range(len(shards)))


def all_to_all(shards, split_axis, concat_axis):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    place i cuts its shard into n chunks along ``split_axis`` and sends
    chunk j to place j; place j joins the chunks it receives along
    ``concat_axis`` in source order."""
    n = len(shards)
    chunks = [torch.chunk(s, n, dim=split_axis) for s in shards]
    if any(len(c) != n or c[0].shape[split_axis] * n != s.shape[split_axis]
           for c, s in zip(chunks, shards)):
        raise ValueError(f"all_to_all: split axis {split_axis} of "
                         f"{tuple(shards[0].shape)} does not split into {n}")
    return [torch.cat([chunks[src][dst].to(shards[dst].device) for src in range(n)],
                      dim=concat_axis) for dst in range(n)]


def ppermute(shards, perm):
    """``lax.ppermute``: for each (src, dst) in ``perm`` place dst receives
    place src's shard; a place that receives nothing gets zeros."""
    out = [None] * len(shards)
    for src, dst in perm:
        out[dst] = shards[src].to(shards[dst].device)
    return [torch.zeros_like(s) if o is None else o for o, s in zip(out, shards)]


def psum(values):
    """``lax.psum``: the sum of every place's value, added in place order,
    and a copy of it on every place."""
    total = values[0]
    for v in values[1:]:
        total = total + v.to(total.device)
    return [total.to(v.device) for v in values]


def all_gather(shards, axis=0):
    """``lax.all_gather(x, axis_name, axis=axis, tiled=True)``: every place
    receives all shards joined along ``axis``."""
    return [torch.cat([s.to(dst.device) for s in shards], dim=axis) for dst in shards]
