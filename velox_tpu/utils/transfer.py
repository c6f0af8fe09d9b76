"""Device->host transfer discipline.

Every device->host fetch pays a round trip, and bytes on the link cost time.
Two rules follow, and every host read in the engine goes through this module
to enforce them:

1. **One round trip, many buffers**: stage ``copy_to_host_async`` on every
   array of a result tree before the first blocking read, so N fetches cost one
   latency instead of N (reference counterpart: the exchange's batched page
   fetches, velox/exec/ExchangeClient.cpp).
2. **Fetch result-sized, not capacity-sized**: dynamic result prefixes are cut
   on device to the next power-of-two bucket before fetching, so the bytes on
   the wire scale with the result, not with the static tile capacity.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import numpy as np


def _stage(tree) -> None:
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array):
            leaf.copy_to_host_async()


def fetch_tree(tree):
    """Fetch every jax array in a pytree with a single round-trip latency."""
    _stage(tree)
    return jax.tree_util.tree_map(
        lambda l: np.asarray(l) if isinstance(l, jax.Array) else l, tree
    )


def bucket_of(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


@functools.lru_cache(maxsize=64)
def _prefix_slicer(bucket: int):
    return jax.jit(lambda arrs: tuple(a[:bucket] for a in arrs))


def fetch_prefix(arrays: Sequence[jax.Array], n: int):
    """Fetch the first ``n`` rows of same-length device arrays.

    Cuts to the next power-of-two bucket on device (one tiny jit per bucket
    size, cached), then fetches all buffers in one round trip and trims to
    ``n`` on the host.
    """
    arrays = tuple(arrays)
    if not arrays:
        return []
    if n <= 0:
        return [np.asarray(a[:0]) for a in _prefix_slicer(1)(arrays)]
    bucket = min(bucket_of(n), arrays[0].shape[0])
    cut = _prefix_slicer(bucket)(arrays)
    out = fetch_tree(list(cut))
    return [a[:n] for a in out]
