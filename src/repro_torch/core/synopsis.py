"""End-to-end PASS synopsis construction (paper §3.1, §4.1, §4.5).

The build is host float64 numpy, step for step the JAX package's:

    1-D : ADP (sampling + discretization DP) or EQ partitioning
    d-D : KD-PASS greedy max-variance k-d refinement (kdtree.py)
    then: exact leaf aggregates, bottom-up tree, per-leaf stratified
          samples,

followed by one float32 conversion and one copy to the serving device.
``delta_encode`` / ``delta_decode`` store sample values as deltas from
their stratum mean (§3.4), elementwise on the synopsis's device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import minmax
from ..device import resolve_device
from . import dp as dp_mod
from . import kdtree
from . import partition_tree as pt
from . import sampling
from .types import Synopsis, PartitionTree, AGG_COUNT


@dataclasses.dataclass
class BuildReport:
    seconds_total: float
    seconds_partition: float
    seconds_aggregate: float
    seconds_sample: float
    k: int
    total_samples: int
    max_variance: float


def partition_assign(c2, a, *, k: int, method: str = "adp",
                     kind: str = "sum", opt_samples: int = 4096,
                     delta_frac: float = 0.01, seed: int = 0
                     ) -> tuple[np.ndarray, int, float]:
    """Row -> leaf assignment: the partitioning stage of the build.
    Returns (assign (n,) int32, realized k, max partition variance)."""
    c2 = np.asarray(c2, dtype=np.float64)
    if c2.ndim == 1:
        c2 = c2[:, None]
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    n, d = c2.shape
    vmax = 0.0
    if d == 1 and method in ("adp", "eq"):
        if method == "adp":
            _, assign, vmax = dp_mod.adp_partition(
                c2[:, 0], a, k=k, m=opt_samples, kind=kind,
                delta_frac=delta_frac, seed=seed)
        else:
            order = np.argsort(c2[:, 0], kind="stable")
            ranks = np.empty(n, dtype=np.int64)
            ranks[order] = np.arange(n)
            cuts = dp_mod.equal_depth_boundaries(n, k)
            assign = np.searchsorted(cuts[1:-1], ranks, side="right")
    else:
        assign, _boxes = kdtree.kd_partition(
            c2, a, k=k, m=opt_samples, kind=kind, delta_frac=delta_frac,
            seed=seed)
        k = int(assign.max()) + 1 if assign.size else k
    return np.asarray(assign, dtype=np.int32), k, float(vmax)


def build_synopsis(c, a, *, k: int = 64, sample_budget: int | None = None,
                   sample_rate: float | None = 0.005, kind: str = "sum",
                   method: str = "adp", opt_samples: int = 4096,
                   delta_frac: float = 0.01, seed: int = 0,
                   allocation: str = "equal", device=None,
                   ) -> tuple[Synopsis, BuildReport]:
    """Construct a PASS synopsis over rows (c, a) on ``device``.

    method: 'adp' (paper **), 'eq' (equal depth), 'kd' (multi-D KD-PASS).
    allocation: 'equal' (paper §5.1.3: K/B per stratum) or 'proportional'.
    ``device=None`` is the CUDA card (raises when there is none).
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    c = np.asarray(c, dtype=np.float64)
    c2 = c[:, None] if c.ndim == 1 else c
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    n, d = c2.shape
    if sample_budget is None:
        sample_budget = int(np.ceil((sample_rate or 0.005) * n))

    assign, k, vmax = partition_assign(
        c2, a, k=k, method=method, kind=kind, opt_samples=opt_samples,
        delta_frac=delta_frac, seed=seed)
    t1 = time.perf_counter()

    syn, info = synopsis_from_assignment(
        c2, a, assign, k, sample_budget=sample_budget,
        allocation=allocation, seed=seed + 1, device=dev)
    t3 = time.perf_counter()
    report = BuildReport(
        seconds_total=t3 - t0, seconds_partition=t1 - t0,
        seconds_aggregate=info["seconds_aggregate"],
        seconds_sample=info["seconds_sample"], k=k,
        total_samples=info["total_samples"], max_variance=float(vmax))
    return syn, report


def _f32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def synopsis_from_assignment(c, a, assign, k, *, s_per_leaf=None,
                             sample_budget: int | None = None,
                             allocation: str = "equal", seed: int = 0,
                             device=None) -> tuple[Synopsis, dict]:
    """Assemble a Synopsis from a row -> leaf assignment: exact per-leaf
    stats and boxes on host f64, bottom-up tree, stratified samples, then
    float32 tensors on ``device``. ``s_per_leaf`` overrides the
    budget/allocation computation. Returns (synopsis, info) with stage
    timings and the realized sample count."""
    dev = resolve_device(device)
    c2 = np.asarray(c, dtype=np.float64)
    if c2.ndim == 1:
        c2 = c2[:, None]
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    assign = np.asarray(assign)
    n, d = c2.shape

    t1 = time.perf_counter()
    agg, lo, hi = pt.leaf_stats(c2, a, assign, k)
    tree = pt.build_tree_from_leaves(agg, lo, hi)
    t2 = time.perf_counter()

    if s_per_leaf is None:
        if allocation == "proportional":
            s_per_leaf = sampling.proportional_allocation(agg[:, AGG_COUNT],
                                                          sample_budget)
        else:
            s_per_leaf = max(1, sample_budget // max(k, 1))
    sample_c, sample_a, valid, k_per_leaf = sampling.stratified_sample(
        c2, a, assign, k, s_per_leaf, seed=seed)
    if (allocation == "proportional" and sample_budget is not None
            and int(k_per_leaf.sum()) > sample_budget):
        raise AssertionError((int(k_per_leaf.sum()), sample_budget))
    t3 = time.perf_counter()

    syn = Synopsis(
        leaf_lo=_f32(lo), leaf_hi=_f32(hi), leaf_agg=_f32(agg),
        n_rows=_f32(agg[:, AGG_COUNT]),
        sample_c=_f32(sample_c), sample_a=_f32(sample_a),
        sample_valid=torch.from_numpy(valid),
        k_per_leaf=torch.from_numpy(k_per_leaf),
        tree=PartitionTree(
            lo=_f32(tree.lo.numpy()), hi=_f32(tree.hi.numpy()),
            agg=_f32(tree.agg.numpy()), left=tree.left, right=tree.right,
            leaf_id=tree.leaf_id, level=tree.level),
        num_leaves=k, d=d, total_rows=_f32(np.float32(n))).to(dev)
    info = {"seconds_aggregate": t2 - t1, "seconds_sample": t3 - t2,
            "total_samples": int(k_per_leaf.sum())}
    return syn, info


def _stratum_mean(syn: Synopsis) -> torch.Tensor:
    count = syn.leaf_agg[:, AGG_COUNT]
    return syn.leaf_agg[:, 0] / minmax.maximum(count, torch.ones_like(count))


def _absmax(x: torch.Tensor, valid: torch.Tensor) -> float:
    """max |x| over the valid slots (0.0 when there is none)."""
    return float(minmax.masked_max(x.abs().reshape(-1), valid.reshape(-1),
                                   0.0, 0))


def delta_encode(syn: Synopsis) -> tuple[Synopsis, dict]:
    """Delta-encode sample values against their stratum mean (§3.4).

    Returns a synopsis whose ``sample_a`` stores deltas (0.0 on invalid
    slots) plus the dynamic-range statistics ``orig_absmax`` and
    ``delta_absmax``. Elementwise float32 on the synopsis's device, the
    JAX package's operations bit for bit. ``delta_decode`` adds the mean
    back; in float32 that restores a value to within one rounding of the
    subtraction and one of the addition, not always to its bits.
    """
    mean = _stratum_mean(syn)
    deltas = torch.where(syn.sample_valid, syn.sample_a - mean[:, None], 0.0)
    enc = dataclasses.replace(syn, sample_a=deltas)
    stats = {"orig_absmax": _absmax(syn.sample_a, syn.sample_valid),
             "delta_absmax": _absmax(deltas, syn.sample_valid)}
    return enc, stats


def delta_decode(syn: Synopsis) -> Synopsis:
    """Invert :func:`delta_encode`: sample values = deltas + stratum mean
    on valid slots, 0.0 elsewhere."""
    mean = _stratum_mean(syn)
    vals = torch.where(syn.sample_valid, syn.sample_a + mean[:, None], 0.0)
    return dataclasses.replace(syn, sample_a=vals)


__all__ = ["build_synopsis", "synopsis_from_assignment", "partition_assign",
           "BuildReport", "delta_encode", "delta_decode"]
