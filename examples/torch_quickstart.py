"""Quickstart on the PyTorch port: build a PASS synopsis once, serve many
queries through the `PassEngine` facade on the CUDA card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The flow and numbers of examples/quickstart.py (the JAX package's). Every
line of output names the device it was measured on: the card's name and
power limit, or `cpu`.
"""
import argparse

import numpy as np

from repro_torch.api import PassEngine, ServingConfig
from repro_torch.core import (build_synopsis, ground_truth, random_queries,
                              relative_error, ci_ratio)
from repro_torch.data import synthetic
from repro_torch.device import device_label, resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--queries", type=int, default=500)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = f"[{device_label(dev)}]"

    # ~380k taxi-like rows: predicate = pickup time, aggregate = distance.
    c, a = synthetic.nyc_taxi(scale=args.scale)
    print(f"{where} dataset: {len(a):,} rows")

    # Budgets (paper §3.1): k leaf partitions (construction budget tau_c),
    # 0.5% stratified samples (query-latency budget tau_q).
    syn, report = build_synopsis(c, a, k=args.k, sample_rate=0.005,
                                 kind="sum", method="adp", device=dev)
    print(f"{where} built PASS synopsis in {report.seconds_total:.2f}s "
          f"(k={report.k}, samples={report.total_samples})")

    # Configure once, serve many: every kind below comes from ONE shared
    # classification + moment pass per batch.
    kinds = ("sum", "count", "avg", "min", "max")
    eng = PassEngine(syn, serving=ServingConfig(kinds=kinds), device=dev)

    queries = random_queries(c, args.queries, seed=0, device=dev)
    res = eng.answer(queries)
    summary = {"device": device_label(dev), "rows": int(len(a)),
               "median_rel_err": {}, "containment": {}}
    for kind in kinds:
        gt = ground_truth(c, a, queries, kind=kind)
        keep = np.abs(gt) > 1e-9
        err = float(np.median(relative_error(res[kind], gt)[keep]))
        summary["median_rel_err"][kind] = err
        line = f"{where} {kind:6s} median rel err {err*100:6.3f}%"
        if kind in ("sum", "count", "avg"):
            ci = np.median(ci_ratio(res[kind], gt)[keep])
            inside = float(np.mean(
                (res[kind].lower.cpu().numpy() <= gt)
                & (gt <= res[kind].upper.cpu().numpy())))
            summary["containment"][kind] = inside
            line += (f"   CI ratio {ci*100:5.2f}%   hard-bound containment "
                     f"{inside*100:.1f}%")
        print(line)

    # Steady-state serving: pin the batch shape once, then every call
    # reuses the prepared entry (no per-call Python re-setup).
    prepared = eng.prepare(queries)
    prepared(queries)
    again = prepared(random_queries(c, args.queries, seed=1, device=dev))
    print(f"{where} prepared handle answered {again['sum'].estimate.shape[0]} "
          f"queries; engine stats: {eng.stats()}")
    summary["stats"] = eng.stats()
    return summary


if __name__ == "__main__":
    main()
