#!/usr/bin/env python3
"""How far the JAX package's own float32 ``partition_stats`` sums lie from
the float64 ``build_catalog`` on the taxi lake.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_catalog_envelope.py

The lake is the one ``chip_smoke.py`` phases 21-22 serve:
``nyc_taxi(scale=1.0)`` (7.7 M trips, sorted by pickup time) in 1024
contiguous time buckets of ~7,500 rows, 1-D and 3-D. For each bucket the
reference's one-pass sketch (``repro.partitions.partition_stats``, the jnp
backend on the CPU) is compared with ``repro.partitions.build_catalog``,
which sums each bucket in float64 and casts to float32. Prints, per
dimension count, the largest relative difference of ``col_sum``,
``col_sumsq`` and the measure's SUM / SUMSQ, the bound
``(n + 1) * 2**-24`` of the largest bucket (``chip_smoke.py``
``f32_sum_rtol``), and whether the integer fields (counts, boxes, MIN /
MAX, histogram row sums) are equal. One JSON line a dimension count.

It imports the JAX package only; it runs on the CPU in a few minutes, in
blocks of 128 buckets so that memory stays small.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

os.environ.setdefault("REPRO_KERNEL_BACKEND", "jnp")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

P, BINS, BLOCK = 1024, 16, 128


def rel_diff(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 1e-30)
    return float(np.max(np.abs(got - want) / scale))


def envelope(dims: int) -> dict:
    from repro.data.synthetic import nyc_taxi
    from repro.partitions import build_catalog, partition_rows, \
        partition_stats
    t0 = time.perf_counter()
    c, a = nyc_taxi(scale=1.0, dims=dims)
    store = partition_rows(c, a, P)
    parts = [store.rows(p) for p in range(P)]
    cat = build_catalog(parts, bins=BINS)
    blo, bhi = np.asarray(cat.bin_lo), np.asarray(cat.bin_hi)
    worst = {"col_sum": 0.0, "col_sumsq": 0.0, "m_sum": 0.0,
             "m_sumsq": 0.0}
    exact = True
    for p0 in range(0, P, BLOCK):
        blk = parts[p0:p0 + BLOCK]
        cb = np.concatenate([x[0] for x in blk]).astype(np.float32)
        ab = np.concatenate([x[1] for x in blk]).astype(np.float32)
        pid = np.repeat(np.arange(len(blk), dtype=np.int32),
                        [x[1].shape[0] for x in blk])
        got = partition_stats(cb, ab, pid, len(blk), bins=BINS,
                              bin_lo=blo, bin_hi=bhi)
        sl = slice(p0, p0 + len(blk))
        want_m = np.asarray(cat.m_agg)[sl]
        got_m = np.asarray(got.m_agg)
        worst["col_sum"] = max(worst["col_sum"], rel_diff(
            got.col_sum, np.asarray(cat.col_sum)[sl]))
        worst["col_sumsq"] = max(worst["col_sumsq"], rel_diff(
            got.col_sumsq, np.asarray(cat.col_sumsq)[sl]))
        worst["m_sum"] = max(worst["m_sum"], rel_diff(got_m[:, 0],
                                                      want_m[:, 0]))
        worst["m_sumsq"] = max(worst["m_sumsq"], rel_diff(got_m[:, 1],
                                                          want_m[:, 1]))
        for g, w in ((got.n, np.asarray(cat.n)[sl]),
                     (got.col_lo, np.asarray(cat.col_lo)[sl]),
                     (got.col_hi, np.asarray(cat.col_hi)[sl]),
                     (got_m[:, 2:], want_m[:, 2:]),
                     (np.asarray(got.hist).sum(2),
                      np.asarray(cat.hist)[sl].sum(2))):
            exact &= bool(np.array_equal(np.asarray(g), w))
    n_max = int(np.asarray(cat.n).max())
    return {"dims": dims, "buckets": P, "rows": int(a.shape[0]),
            "max_bucket_rows": n_max,
            "max_rel_diff": worst,
            "f32_sum_rtol": (n_max + 1) * 2.0 ** -24,
            "integer_fields_equal": exact,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    for dims in (1, 3):
        print(json.dumps(envelope(dims)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
