#!/usr/bin/env python3
"""The JAX package's own median SUM error on the 3-D catalog cell.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_catalog_error.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_catalog_error.py --port

The cell is the one ``chip_smoke.py`` phase 22 serves:
``nyc_taxi(scale=1.0, dims=3)`` (7.7 M trips, sorted by pickup time) in
1024 contiguous time buckets (``partition_rows``), served by
``repro.api.PassEngine.from_catalog`` with ``CatalogConfig(k=16,
s_per_leaf=75, max_partitions=64, seed=0, method="kd")``, kinds
sum/count/avg and ``ci=0.95``, on one batch of ``random_queries(c, Q,
seed=3)`` (Q = 512 by default). The truth is ``repro.core.query.
ground_truth`` (a float64 scan of every row). Prints one JSON line: the
median relative SUM error over the non-empty queries among the first 64
(the phase's bar is held there) and over the whole batch, with the counts
of non-empty queries.

``--port`` also serves the same batch through ``repro_torch`` on the CPU
(its picker draws the reference's selection) and prints the port's medians
and the largest relative difference of the two SUM estimates.

The JAX package runs on the CPU with its ``jnp`` backend; a run takes a
few minutes and about 2 GB of memory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

os.environ.setdefault("REPRO_KERNEL_BACKEND", "jnp")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

P = 1024
CFG = dict(k=16, s_per_leaf=75, max_partitions=64, seed=0, method="kd")
KINDS = ("sum", "count", "avg")
HEAD = 64


def medians(est, truth) -> dict:
    est = np.asarray(est, np.float64)
    nonempty = truth != 0
    err = np.abs(est - truth) / np.maximum(np.abs(truth), 1e-12)
    head = nonempty[:HEAD]
    return {"median_sum_err_first64": float(np.median(err[:HEAD][head])),
            "nonempty_first64": int(head.sum()),
            "median_sum_err_all": float(np.median(err[nonempty])),
            "nonempty_all": int(nonempty.sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--port", action="store_true",
                    help="also serve the batch through repro_torch on the "
                         "CPU")
    args = ap.parse_args(argv)
    from repro.api import CatalogConfig, PassEngine, ServingConfig
    from repro.core.query import ground_truth, random_queries
    from repro.data.synthetic import nyc_taxi
    from repro.partitions import partition_rows
    t0 = time.perf_counter()
    c, a = nyc_taxi(scale=1.0, dims=3)
    q = random_queries(c, args.queries, seed=3)
    eng = PassEngine.from_catalog(partition_rows(c, a, P),
                                  catalog=CatalogConfig(**CFG),
                                  serving=ServingConfig(kinds=KINDS),
                                  ci=0.95)
    est = np.asarray(eng.answer(q)["sum"].estimate)
    t_answer = time.perf_counter() - t0
    truth = ground_truth(c, a, q, kind="sum")
    out = {"cell": "catalog 3d", "rows": int(a.shape[0]), "buckets": P,
           "queries": args.queries, "config": CFG,
           "reference": medians(est, truth),
           "reference_seconds": t_answer}
    if args.port:
        import torch
        from repro_torch.api import CatalogConfig as TCat
        from repro_torch.api import PassEngine as TEngine
        from repro_torch.api import ServingConfig as TServing
        from repro_torch.core.types import QueryBatch
        from repro_torch.partitions import partition_rows as tpartition_rows
        teng = TEngine.from_catalog(tpartition_rows(c, a, P),
                                    catalog=TCat(**CFG),
                                    serving=TServing(kinds=KINDS), ci=0.95,
                                    device="cpu")
        tq = QueryBatch(torch.tensor(np.asarray(q.lo)),
                        torch.tensor(np.asarray(q.hi)))
        test = teng.answer(tq)["sum"].estimate.numpy().astype(np.float64)
        out["port_cpu"] = medians(test, truth)
        scale = np.maximum(np.abs(est.astype(np.float64)), 1e-12)
        out["port_max_rel_diff"] = float(np.max(np.abs(test - est) / scale))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
