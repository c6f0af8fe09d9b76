"""Memory pools, arbitration, and host/disk spilling.

Reference: velox/common/memory/Memory.h:126 (MemoryManager), MemoryPool.h:109
(hierarchical pools with limits/tracking), MemoryArbitrator.h:43 (+ reclaimers:
pause -> spill -> resume), exec/Spiller.h:26 and docs/develop/spilling.rst.

Device re-orientation: the scarce resource is HBM; "disk" is host RAM first and
files second (hosts usually have far more RAM than device memory).  The pool tree
tracks *logical* byte reservations of device-resident state (tiles, join build
tables, accumulated partials); when a reservation would exceed the pool's
limit, the arbitrator runs registered reclaimers (largest first), which spill
operator state to the host/disk via the page serde and release their
reservation — the reference's pause/spill/resume contract without threads.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np

from ..io.table import Table


class MemoryPoolError(RuntimeError):
    pass


class MemoryPool:
    """Hierarchical byte-reservation pool (reference: memory::MemoryPool)."""

    def __init__(
        self,
        name: str,
        limit: Optional[int] = None,
        parent: Optional["MemoryPool"] = None,
    ):
        self.name = name
        self.limit = limit
        self.parent = parent
        self.reserved = 0
        self.peak = 0
        self.children: List["MemoryPool"] = []
        self._reclaimers: List[Callable[[int], int]] = []
        if parent is not None:
            parent.children.append(self)

    def add_child(self, name: str, limit: Optional[int] = None) -> "MemoryPool":
        return MemoryPool(name, limit, self)

    def add_reclaimer(self, fn: Callable[[int], int]) -> None:
        """fn(target_bytes) -> bytes actually released (reference: MemoryReclaimer)."""
        self._reclaimers.append(fn)

    def reserve(self, nbytes: int) -> None:
        # check limits (arbitrating if needed) along the whole chain BEFORE
        # committing any increment, so reclaimers see consistent usage
        pool = self
        while pool is not None:
            if pool.limit is not None and pool.reserved + nbytes > pool.limit:
                freed = pool._arbitrate(pool.reserved + nbytes - pool.limit)
                if pool.reserved + nbytes > pool.limit:
                    raise MemoryPoolError(
                        f"pool {pool.name}: reservation of {nbytes} bytes exceeds "
                        f"limit {pool.limit} (reserved {pool.reserved}, "
                        f"reclaimed {freed})"
                    )
            pool = pool.parent
        pool = self
        while pool is not None:
            pool.reserved += nbytes
            pool.peak = max(pool.peak, pool.reserved)
            pool = pool.parent

    def release(self, nbytes: int) -> None:
        pool = self
        while pool is not None:
            pool.reserved = max(0, pool.reserved - nbytes)
            pool = pool.parent

    def detach(self) -> None:
        """Remove this pool from its parent, releasing whatever the subtree
        still holds (reference: MemoryPool destruction releasing to parent)."""
        if self.parent is None:
            return
        try:
            self.parent.children.remove(self)
        except ValueError:
            pass
        pool = self.parent
        while pool is not None:
            pool.reserved = max(0, pool.reserved - self.reserved)
            pool = pool.parent
        self.parent = None

    def _arbitrate(self, target: int) -> int:
        """Run reclaimers bottom-up, largest child first (SharedArbitrator)."""
        freed = 0
        for child in sorted(self.children, key=lambda c: -c.reserved):
            freed += child._arbitrate(target - freed)
            if freed >= target:
                return freed
        for fn in self._reclaimers:
            freed += fn(target - freed)
            if freed >= target:
                break
        return freed

    def usage_tree(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [
            f"{pad}{self.name}: reserved={self.reserved:,} peak={self.peak:,}"
            + (f" limit={self.limit:,}" if self.limit else "")
        ]
        for c in self.children:
            lines.append(c.usage_tree(indent + 1))
        return "\n".join(lines)


# The process root pool (reference: MemoryManager singleton).
ROOT_POOL = MemoryPool("root")


def device_tree_bytes(tree) -> int:
    """Total bytes of every device array in a pytree (HBM accounting unit)."""
    import jax

    total = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        nbytes = getattr(leaf, "nbytes", None)
        if nbytes is not None:
            total += int(nbytes)
    return total


def table_nbytes(table: Table) -> int:
    total = 0
    for arr in table.columns.values():
        total += np.asarray(arr).nbytes
    for v in table.validities.values():
        total += np.asarray(v).nbytes
    return total


class Spiller:
    """Spills host Tables to disk as serde pages and restores them in order.

    Reference: exec/Spiller.h + SpillState/SpillFile (the file format there is
    VectorStream pages + compression; here it is serde.page).  Partial-aggregate
    chunks are key-ordered per tile, so restore-and-merge preserves exactness.
    """

    def __init__(self, directory: Optional[str] = None, compress: bool = True):
        self._own = directory is None
        self.directory = directory or tempfile.mkdtemp(prefix="velox_tpu_spill_")
        self.compress = compress
        self.files: List[str] = []
        self.spilled_bytes = 0
        self.spilled_rows = 0

    def spill(self, table: Table) -> None:
        from ..utils.testvalue import adjust

        adjust("Spiller::spill", table)
        from ..serde.page import serialize_page

        path = os.path.join(self.directory, f"spill_{len(self.files)}.page")
        buf = serialize_page(table, compress=self.compress)
        with open(path, "wb") as f:
            f.write(buf)
        self.files.append(path)
        self.spilled_bytes += len(buf)
        self.spilled_rows += table.num_rows

    def restore(self):
        from ..serde.page import deserialize_page

        for path in self.files:
            with open(path, "rb") as f:
                yield deserialize_page(f.read())

    def cleanup(self) -> None:
        for path in self.files:
            try:
                os.unlink(path)
            except OSError:
                pass
        self.files.clear()
        if self._own:
            try:
                os.rmdir(self.directory)
            except OSError:
                pass
