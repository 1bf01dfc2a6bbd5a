"""The epilogue of an fk-join answer (row 11): every requested kind's
estimate, half-width, hard bounds and clipped interval in one launch.

``join_epilogue_cuda`` launches the hand-written kernel of
``csrc/join_epilogue.cu``. The JAX package has no Pallas kernel for this
stage: its epilogue is plain jnp (``repro/joins/assemble.py:64``
``assemble_join``; ``repro/uncertainty/intervals.py:198,217,308``
``_join_fb_half``, ``compose_join_interval``, ``_with_interval``), which
XLA fuses on the TPU. ``join_epilogue_plain`` is the port's composition
of those functions (``joins.assemble``, ``uncertainty.intervals``), one
kind after the other: the version CPU tensors take and the reference the
kernel is held against on the card.

Both take the join synopsis (``cell_agg``, ``u_overflow``,
``num_leaves``, ``num_partitions``), the batch's join artifacts (row 9's
eight planes, ``sampled``, ``exact3`` and ``touched``; ``joins.executor``
``JoinArtifacts``) and the request: the kinds (a subset of sum, count,
avg), ``lam`` (the plain half-width's scale), ``level`` (None: no
calibrated interval), ``small_n_threshold`` and ``delta_budget``. Both
return {kind: QueryResult}; without a level ``ci_lo`` / ``ci_hi`` are
None.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.types import QueryResult
from . import native
from .join_moments import PLANES

NAME = "join_epilogue"
KINDS = ("sum", "count", "avg")
# The rows of the kernel's output a kind, in order.
FIELDS = ("estimate", "ci_half", "lower", "upper", "frac_rows_touched",
          "ci_lo", "ci_hi")
# The launch (csrc/join_epilogue.cu): a block of EPI_THREADS a query, each
# thread taking EPI_CHUNK consecutive cells at a time.
EPI_THREADS, EPI_CHUNK = 256, 4


def request_kinds(kinds, level, delta_budget) -> tuple:
    """The distinct requested kinds, in order; raises ValueError on a kind
    the join epilogue has no estimator for, or (with a level) on an
    unknown ``delta_budget``, as the plain composition does."""
    out = tuple(dict.fromkeys(kinds))
    for kind in out:
        if kind not in KINDS:
            raise ValueError(f"unsupported join kind: {kind} "
                             "(join serving supports sum/count/avg)")
    if level is not None and delta_budget not in ("stratum", "union"):
        raise ValueError(f"unknown delta_budget: {delta_budget!r}")
    return out


def join_epilogue_plain(jsyn, jart, kinds, *, lam: float,
                        level: float | None, small_n_threshold: int,
                        delta_budget: str) -> dict:
    """``assemble_join``, then with a level ``compose_join_interval`` and
    ``_with_interval(clip_bounds=True)``, for each kind."""
    from ..joins.assemble import assemble_join
    from ..uncertainty.intervals import (_z_of, _with_interval,
                                         compose_join_interval)
    scale = lam if level is None else _z_of(level, jart.sampled.device)
    out = {}
    for kind in kinds:
        res = assemble_join(jsyn, jart, kind, scale)
        if level is not None:
            half, _ = compose_join_interval(
                jsyn, jart, kind, level,
                small_n_threshold=small_n_threshold,
                delta_budget=delta_budget)
            res = _with_interval(res, half, clip_bounds=True)
        out[kind] = res
    return out


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = native.library("join_epilogue")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_join_epilogue.argtypes = (
            [p] * 16 + [i] * 9 + [f] * 3 + [p])
        lib.repro_join_epilogue.restype = ctypes.c_int
        _lib = lib
    return _lib.repro_join_epilogue


def check_epilogue_limits(name, Q, kp, P):
    """Raise ValueError unless the kernel takes these sizes: a block a
    query (gridDim.x), cell ids in a C int."""
    if not (1 <= Q < 2 ** 31 and 1 <= P <= kp <= 2 ** 31 - 1 - EPI_CHUNK):
        raise ValueError(
            f"{name}: needs 1 <= Q < 2**31 and 1 <= P <= k*P <= "
            f"{2 ** 31 - 1 - EPI_CHUNK}, got Q={Q} k*P={kp} P={P}")


def _interval_scalars(level: float, delta_budget: str, device):
    """(z, log_term, inv_delta): z and, under "stratum", log(3 / delta) as
    0-d float32 tensors on ``device``, made by the plain version's torch
    ops (so their bits are its); 1 / delta rounded as torch's division of
    a tensor by the Python float delta rounds it on the card."""
    from ..uncertainty.intervals import _z_of
    delta = 1.0 - level
    z = _z_of(level, device)
    log_term = None
    if delta_budget == "stratum":
        log_term = torch.log(torch.tensor(3.0 / delta, dtype=torch.float32,
                                          device=device))
    return z, log_term, float(np.float32(1.0) / np.float32(delta))


def join_epilogue_cuda(jsyn, jart, kinds, *, lam: float,
                       level: float | None, small_n_threshold: int,
                       delta_budget: str) -> dict:
    """One launch on the tensors' device and current stream. The results'
    fields are rows of the launch's one (n_kinds, 7, Q) buffer."""
    kinds = request_kinds(kinds, level, delta_budget)
    if not kinds:
        return {}
    # Row 9's planes, in the order of the kernel's pointers.
    planes = [getattr(jart, f) for f in PLANES]
    sampled, exact3, touched = jart.sampled, jart.exact3, jart.touched
    k, P = jsyn.num_leaves, jsyn.num_partitions
    kp = k * P
    cell_agg = jsyn.cell_agg
    if cell_agg.numel() == kp * 5:
        cell_agg = cell_agg.reshape(kp, 5)
    over = jsyn.u_overflow
    native.check_dtype(NAME, torch.float32, cell_agg=cell_agg,
                       exact3=exact3, touched=touched,
                       **dict(zip(PLANES, planes)))
    native.check_dtype(NAME, torch.bool, sampled=sampled)
    if over.dtype not in (torch.int32, torch.int64):
        raise native.DtypeError(f"{NAME}: u_overflow must be int32 or "
                                f"int64, got {over.dtype}")
    Q = sampled.shape[0] if sampled.dim() == 2 else -1
    if (sampled.shape != (Q, kp) or cell_agg.shape != (kp, 5)
            or over.shape != (k,) or exact3.shape != (Q, 3)
            or touched.shape != (Q,)
            or any(p.shape != (Q, kp) for p in planes)):
        raise ValueError(
            f"{NAME}: shapes sampled {tuple(sampled.shape)}, planes "
            f"{[tuple(p.shape) for p in planes]}, cell_agg "
            f"{tuple(cell_agg.shape)}, u_overflow {tuple(over.shape)}, "
            f"exact3 {tuple(exact3.shape)}, touched {tuple(touched.shape)} "
            f"for k={k} P={P}")
    check_epilogue_limits(NAME, Q, kp, P)
    native.check_tensors(NAME, sampled=sampled, cell_agg=cell_agg,
                         u_overflow=over, exact3=exact3, touched=touched,
                         **dict(zip(PLANES, planes)))
    dev = sampled.device
    z = log_term = None
    inv_delta = 1.0
    if level is not None:
        z, log_term, inv_delta = _interval_scalars(level, delta_budget,
                                                   dev)
    slot = {kind: i for i, kind in enumerate(kinds)}
    out = torch.empty((len(kinds), len(FIELDS), Q), dtype=torch.float32,
                      device=dev)
    native.launch(
        NAME, dev, _kernel(), *(p.data_ptr() for p in planes),
        sampled.data_ptr(), cell_agg.data_ptr(), over.data_ptr(),
        exact3.data_ptr(), touched.data_ptr(),
        None if z is None else z.data_ptr(),
        None if log_term is None else log_term.data_ptr(), out.data_ptr(),
        Q, kp, P, slot.get("sum", -1), slot.get("count", -1),
        slot.get("avg", -1), int(level is not None),
        int(delta_budget == "union"), int(over.dtype == torch.int64),
        float(lam), float(small_n_threshold), inv_delta)
    res = {}
    for kind, rows in zip(kinds, out.unbind(0)):
        est, half, lower, upper, tch, lo, hi = rows.unbind(0)
        res[kind] = QueryResult(est, half, lower, upper, tch,
                                lo if level is not None else None,
                                hi if level is not None else None)
    return res


__all__ = ["join_epilogue_plain", "join_epilogue_cuda", "request_kinds",
           "check_epilogue_limits", "KINDS", "FIELDS",
           "PLANES", "EPI_THREADS", "EPI_CHUNK"]
