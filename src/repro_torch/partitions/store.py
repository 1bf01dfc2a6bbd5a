"""Partitioned row storage for the catalog tier (DESIGN.md §14); the
port of ``repro/partitions/store.py``, host numpy as there.

A :class:`PartitionStore` is the minimal storage abstraction the picker
needs: an ordered list of ``(c, a)`` row blocks it can read one partition
at a time (the "petabyte-shaped" contract — the engine never concatenates
them unless it deliberately chooses the dense flat path). Rows are kept
as host float64, matching what ``build_synopsis`` would consume, so the
dense path is bit-identical to handing the original arrays to the flat
builder.

:func:`partition_rows` splits one flat dataset into contiguous
equal-sized partitions **preserving row order**, which makes
``store.all_rows()`` exactly the original arrays — the property the
p=1 bit-identity test pins down.
"""
from __future__ import annotations

import numpy as np


class PartitionStore:
    """Ordered collection of per-partition row blocks.

    ``parts`` is a sequence of ``(c, a)`` pairs: ``c`` (n_p, d) predicate
    columns (1-D accepted and reshaped), ``a`` (n_p,) measure values.
    Every partition must agree on d; empty partitions are allowed.
    """

    def __init__(self, parts):
        if not parts:
            raise ValueError("PartitionStore needs at least one partition")
        self._c, self._a = [], []
        d = None
        for c, a in parts:
            c2 = np.asarray(c, np.float64)
            if c2.ndim == 1:
                c2 = c2[:, None]
            a1 = np.asarray(a, np.float64).reshape(-1)
            if c2.shape[0] != a1.shape[0]:
                raise ValueError(
                    f"partition rows disagree: c {c2.shape[0]} vs a "
                    f"{a1.shape[0]}")
            if d is None:
                d = c2.shape[1]
            elif c2.shape[1] != d:
                raise ValueError(
                    f"partition dims disagree: {c2.shape[1]} vs {d}")
            self._c.append(c2)
            self._a.append(a1)
        self.d = int(d)

    @property
    def num_partitions(self) -> int:
        return len(self._a)

    @property
    def total_rows(self) -> int:
        return int(sum(a.shape[0] for a in self._a))

    def rows(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        """The (c, a) block of partition ``p`` (host f64 views)."""
        return self._c[p], self._a[p]

    def parts(self):
        """Iterate ``(c, a)`` blocks in partition order."""
        return list(zip(self._c, self._a))

    def all_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """Concatenation in partition order — for contiguous splits this
        reproduces the original arrays exactly (dense flat path)."""
        return (np.concatenate(self._c, axis=0),
                np.concatenate(self._a, axis=0))


def partition_rows(c, a, num_partitions: int) -> PartitionStore:
    """Split flat rows into ``num_partitions`` contiguous order-preserving
    blocks (the synthetic stand-in for files/row-groups of a real lake)."""
    c2 = np.asarray(c, np.float64)
    if c2.ndim == 1:
        c2 = c2[:, None]
    a1 = np.asarray(a, np.float64).reshape(-1)
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
    bounds = np.linspace(0, a1.shape[0], num_partitions + 1).astype(np.int64)
    return PartitionStore([(c2[bounds[i]:bounds[i + 1]],
                            a1[bounds[i]:bounds[i + 1]])
                           for i in range(num_partitions)])


__all__ = ["PartitionStore", "partition_rows"]
