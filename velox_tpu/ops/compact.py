"""Mask→dense compaction (the device form of filter result materialization).

Reference: the reference produces dictionary-wrapped vectors after filters
(velox/exec/FilterProject.cpp); here filters narrow a boolean selection mask and
this kernel produces the dense permutation when an operator boundary needs
density (exchange, join build, output).

A stable dense gather: indices of selected rows first (in order), padding rows
after.  Uses argsort on the inverted mask — XLA lowers this to a single sort, no
host round-trip, and it is shape-stable.
"""

from __future__ import annotations

from typing import Tuple

import dataclasses
import jax
import jax.numpy as jnp

from ..vector.column import Batch


def compaction_indices(mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Returns (perm, count): perm is a stable permutation putting selected rows
    first; count is the number selected."""
    # stable argsort of ~mask: False (selected) sorts before True, order kept
    perm = jnp.argsort(~mask, stable=True)
    return perm.astype(jnp.int32), jnp.sum(mask).astype(jnp.int32)


def compact(batch: Batch) -> Batch:
    """Densify a batch: live rows first, selection cleared, length=num_active."""
    mask = batch.active_mask()
    perm, count = compaction_indices(mask)
    cols = tuple(c.gather(perm).flatten(batch.capacity) for c in batch.columns)
    return dataclasses.replace(
        batch, columns=cols, length=count, selection=None
    )


def compaction_word(mask: jax.Array) -> jax.Array:
    """The compaction permutation as ONE packed sort word (dead flag << idxb
    | row id) — sorting it through the canonical shared program
    (ops/shared_sort.py) replaces the in-program argsort when programs must
    stay sort-free (config.split_sort_programs)."""
    n = mask.shape[0]
    idxb = max((n - 1).bit_length(), 1)
    iota = jnp.arange(n, dtype=jnp.int64)
    return ((~mask).astype(jnp.int64) << idxb) | iota


def compact_from_sorted_word(batch: Batch, s_word: jax.Array) -> Batch:
    """Post-sort half of the split compaction."""
    n = batch.capacity
    idxb = max((n - 1).bit_length(), 1)
    perm = (s_word & ((jnp.int64(1) << idxb) - 1)).astype(jnp.int32)
    count = jnp.sum(batch.active_mask()).astype(jnp.int32)
    cols = tuple(c.gather(perm).flatten(n) for c in batch.columns)
    return dataclasses.replace(
        batch, columns=cols, length=count, selection=None
    )
