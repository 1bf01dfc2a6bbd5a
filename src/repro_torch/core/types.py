"""Core tensor types for PASS synopses.

Dataclasses of tensors with the same fields, shapes and dtypes as the JAX
package's pytrees, so a synopsis carried across with
:func:`synopsis_from_numpy` serves the very same state in both. Ragged
strata are padded; validity is carried by masks and true counts.

Aggregate layout:
    agg[..., 0] = SUM
    agg[..., 1] = SUMSQ
    agg[..., 2] = COUNT
    agg[..., 3] = MIN   (+inf for empty)
    agg[..., 4] = MAX   (-inf for empty)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

AGG_SUM, AGG_SUMSQ, AGG_COUNT, AGG_MIN, AGG_MAX = 0, 1, 2, 3, 4
NUM_AGGS = 5

# Classification codes for leaf-vs-query relation (paper §2.3).
REL_NONE, REL_PARTIAL, REL_COVER = 0, 1, 2


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field on ``device``
    (fields already there are shared, not copied)."""
    moved = {f.name: getattr(obj, f.name).to(device)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **moved)


@dataclasses.dataclass
class PartitionTree:
    """Flat-array partition tree (paper §3.2, Definition 3.1).

    Nodes are stored level-major (root first). ``leaf_id[v] >= 0`` iff node
    v is a leaf; leaves index the stratified-sample arrays of the Synopsis.
    ``lo``/``hi`` are the data bounding boxes of each node.
    """
    lo: torch.Tensor        # (num_nodes, d)
    hi: torch.Tensor        # (num_nodes, d)
    agg: torch.Tensor       # (num_nodes, NUM_AGGS)
    left: torch.Tensor      # (num_nodes,) int32, -1 if leaf
    right: torch.Tensor     # (num_nodes,) int32, -1 if leaf
    leaf_id: torch.Tensor   # (num_nodes,) int32, -1 if internal
    level: torch.Tensor     # (num_nodes,) int32 depth (root = 0)

    @property
    def num_nodes(self) -> int:
        return self.lo.shape[0]

    @property
    def dims(self) -> int:
        return self.lo.shape[1]

    def to(self, device) -> "PartitionTree":
        return _to(self, device)


@dataclasses.dataclass
class Synopsis:
    """A complete PASS synopsis: leaf partitions + aggregates + strata.

    ``leaf_lo/leaf_hi`` (k, d) f32 per-leaf data bounding boxes;
    ``leaf_agg`` (k, NUM_AGGS) f32 exact per-leaf aggregates;
    ``sample_c`` (k, s, d) / ``sample_a`` (k, s) f32 per-leaf uniform
    samples, ``sample_valid`` (k, s) bool masks padding; ``k_per_leaf``
    (k,) int32 true sample count per stratum; ``n_rows`` (k,) f32 exact
    row count per leaf; ``total_rows`` a float32 0-d tensor.
    """
    leaf_lo: torch.Tensor
    leaf_hi: torch.Tensor
    leaf_agg: torch.Tensor
    n_rows: torch.Tensor
    sample_c: torch.Tensor
    sample_a: torch.Tensor
    sample_valid: torch.Tensor
    k_per_leaf: torch.Tensor
    tree: PartitionTree
    num_leaves: int
    d: int
    total_rows: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.leaf_lo.device

    def to(self, device) -> "Synopsis":
        return dataclasses.replace(_to(self, device),
                                   tree=self.tree.to(device))

    def storage_floats(self) -> int:
        """Synopsis size in stored scalars (for BSS accounting, §5.1.4)."""
        return int(sum(x.numel() for x in
                       (self.leaf_lo, self.leaf_hi, self.leaf_agg,
                        self.sample_c, self.sample_a))
                   + self.tree.agg.numel() + self.tree.lo.numel()
                   + self.tree.hi.numel())


@dataclasses.dataclass
class QueryBatch:
    """Rectangular predicates: lo <= C_i <= hi, inclusive (paper §3.1)."""
    lo: torch.Tensor  # (Q, d)
    hi: torch.Tensor  # (Q, d)

    @property
    def num_queries(self) -> int:
        return self.lo.shape[0]

    def to(self, device) -> "QueryBatch":
        return _to(self, device)


@dataclasses.dataclass
class QueryResult:
    """Estimates + confidence interval + deterministic hard bounds.

    ``ci_lo``/``ci_hi`` are set by ``answer(..., ci=level)`` and for
    MIN/MAX (the deterministic envelope); otherwise :meth:`interval` falls
    back to ``estimate -/+ ci_half``.
    """
    estimate: torch.Tensor           # (Q,)
    ci_half: torch.Tensor            # (Q,)
    lower: torch.Tensor              # (Q,) deterministic lower bound (§2.3)
    upper: torch.Tensor              # (Q,) deterministic upper bound
    frac_rows_touched: torch.Tensor  # (Q,) fraction of rows NOT skipped
    ci_lo: torch.Tensor | None = None
    ci_hi: torch.Tensor | None = None

    def interval(self):
        """(estimate, lo, hi)."""
        if self.ci_lo is not None and self.ci_hi is not None:
            return self.estimate, self.ci_lo, self.ci_hi
        return (self.estimate, self.estimate - self.ci_half,
                self.estimate + self.ci_half)


_TREE_FIELDS = ("lo", "hi", "agg", "left", "right", "leaf_id", "level")
_SYN_FIELDS = ("leaf_lo", "leaf_hi", "leaf_agg", "n_rows", "sample_c",
               "sample_a", "sample_valid", "k_per_leaf", "total_rows")


def synopsis_from_numpy(fields: dict[str, np.ndarray], *, num_leaves: int,
                        d: int, device=None) -> Synopsis:
    """Build a :class:`Synopsis` from host arrays, dtypes kept as given.

    ``fields`` maps each Synopsis field name to an array, with the tree's
    arrays flattened as ``tree.lo``, ``tree.hi`` and so on. Carries a
    synopsis built by the JAX package (``{f: np.asarray(getattr(syn, f))}``)
    into the port bit for bit; a sharded ingestor's base and merged
    synopsis carry over the same way (their state goes through
    ``streaming.ingest.stream_state_from_numpy``).
    """
    dev = resolve_device(device)

    def t(name):
        return torch.tensor(np.asarray(fields[name]), device=dev)

    tree = PartitionTree(**{f: t(f"tree.{f}") for f in _TREE_FIELDS})
    return Synopsis(**{f: t(f) for f in _SYN_FIELDS}, tree=tree,
                    num_leaves=int(num_leaves), d=int(d))


def aqppp_from_numpy(fields: dict, *, device=None):
    """Build the AQP++ baseline (:class:`~repro_torch.core.baselines.AQPPP`)
    from host arrays: float64 boxes, aggregates and sample, int64 sample
    partition ids, on ``device``. ``fields`` holds the dataclass's fields
    by name (``bound_lo``, ``bound_hi``, ``agg``, ``sample_c``,
    ``sample_a``, ``sample_leaf``, ``n``), so the JAX package's structure
    (``dataclasses.asdict``) carries into the port unchanged."""
    from .baselines import AQPPP
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(fields[name]), dtype=dtype, device=dev)

    return AQPPP(bound_lo=t("bound_lo", torch.float64),
                 bound_hi=t("bound_hi", torch.float64),
                 agg=t("agg", torch.float64),
                 sample_c=t("sample_c", torch.float64),
                 sample_a=t("sample_a", torch.float64),
                 sample_leaf=t("sample_leaf", torch.int64),
                 n=int(fields["n"]))


__all__ = [
    "PartitionTree", "Synopsis", "QueryBatch", "QueryResult",
    "synopsis_from_numpy", "aqppp_from_numpy",
    "AGG_SUM", "AGG_SUMSQ", "AGG_COUNT", "AGG_MIN", "AGG_MAX", "NUM_AGGS",
    "REL_NONE", "REL_PARTIAL", "REL_COVER",
]
