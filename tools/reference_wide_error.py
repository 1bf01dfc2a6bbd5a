#!/usr/bin/env python3
"""The JAX package's own median SUM error on the 24-column wide table.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_wide_error.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_wide_error.py \\
        --scale 0.1 --queries 256

The table is the one ``chip_smoke.py`` phase 30 serves (``wide_table``:
``nyc_taxi(dims=5)``'s five columns and 19 generated ones, the value trip
distance), here at ``--scale`` (0.1 by default: 770,000 rows), under the
phase's query rule (``wide_queries``: each rectangle bounds 2-4 columns by
``random_queries``' rule on them, every other column at its [min, max]),
with the phase's seeds. ``repro.core.synopsis.build_synopsis(k=1024,
method="kd")`` with 75 slots a stratum (the phase's 1 % of 7.7 M rows; at
scale 0.1 a sample budget of 1024 x 75), served by ``repro.api.PassEngine``
(kind sum, ``ci=0.95``) in chunks of queries. The truth is a float64 scan
of every row with membership on the float32 coordinates and bounds, as
the phase's ``truth_scan``. Prints one JSON line: the median relative SUM
error over the non-empty queries among the first 64 (the phase holds its
bar there) and over the whole batch, with the counts.

The JAX package runs on the CPU with its ``jnp`` backend; the default run
takes a few minutes and a few GB of memory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("REPRO_KERNEL_BACKEND", "jnp")
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

K, SLOTS, HEAD, CHUNK = 1024, 75, 64, 16


def truth_sum(c, a, q_lo, q_hi, rows: int = 1 << 17) -> np.ndarray:
    """SUM of each query by a float64 scan, membership on float32."""
    out = np.zeros(q_lo.shape[0])
    for s in range(0, c.shape[0], rows):
        cc = c[s:s + rows].astype(np.float32)[None]
        inside = ((q_lo[:, None] <= cc) & (cc <= q_hi[:, None])).all(-1)
        out += inside.astype(np.float64) @ a[s:s + rows].astype(np.float64)
    return out


def medians(est, truth) -> dict:
    nonempty = truth != 0
    err = np.abs(est - truth) / np.maximum(np.abs(truth), 1e-12)
    head = nonempty[:HEAD]
    return {"median_sum_err_first64": float(np.median(err[:HEAD][head])),
            "nonempty_first64": int(head.sum()),
            "median_sum_err_all": float(np.median(err[nonempty])),
            "nonempty_all": int(nonempty.sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--queries", type=int, default=256)
    args = ap.parse_args(argv)
    import jax.numpy as jnp
    from chip_smoke import WIDE_Q, WIDE_SEED, wide_queries, wide_table
    from repro.api import PassEngine, ServingConfig
    from repro.core.synopsis import build_synopsis
    from repro.core.types import QueryBatch
    from repro.data.synthetic import nyc_taxi
    t0 = time.perf_counter()
    c, a = wide_table(nyc_taxi, args.scale)
    q_lo, q_hi = wide_queries(c, WIDE_Q, WIDE_SEED)
    q_lo, q_hi = q_lo[:args.queries], q_hi[:args.queries]
    syn, report = build_synopsis(c, a, k=K, sample_budget=K * SLOTS,
                                 sample_rate=None, method="kd")
    eng = PassEngine(syn, ServingConfig(kinds=("sum",)), ci=0.95)
    est = np.concatenate([
        np.asarray(eng.answer(QueryBatch(jnp.asarray(q_lo[i:i + CHUNK]),
                                         jnp.asarray(q_hi[i:i + CHUNK])))
                   ["sum"].estimate, np.float64)
        for i in range(0, q_lo.shape[0], CHUNK)])
    truth = truth_sum(c, a, q_lo, q_hi)
    out = {"table": "wide 24 columns", "rows": int(a.shape[0]),
           "scale": args.scale, "k": K, "slots_per_stratum": SLOTS,
           "samples": int(report.total_samples), "queries": int(q_lo.shape[0]),
           "reference": medians(est, truth),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
