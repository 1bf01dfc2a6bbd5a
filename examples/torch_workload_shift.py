"""Workload shift (paper §5.4.1) and data shift (§4.5) on the PyTorch port:
a KD-PASS synopsis built for a 2-D query template keeps helping when the
workload drifts to 1-D/3-D/4-D templates that share attributes, and when
the *data* drifts the streaming subsystem keeps serving fresh answers via
batched ingest + delta-merge on the CUDA card, re-optimizing the partition
once the drift policy trips.

The flow and numbers of examples/workload_shift.py (the JAX package's).
Every line of output names the device it was measured on.

    PYTHONPATH=src python examples/torch_workload_shift.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import PassEngine, ServingConfig
from repro_torch.core import (build_synopsis, ground_truth, random_queries,
                              relative_error)
from repro_torch.core.estimators import skip_rate
from repro_torch.core.types import QueryBatch
from repro_torch.data import synthetic
from repro_torch.device import device_label, resolve_device
from repro_torch.streaming import StreamingIngestor, DriftPolicy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--queries", type=int, default=200)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = f"[{device_label(dev)}]"
    nq = args.queries

    c, a = synthetic.nyc_taxi(scale=args.scale, dims=4)
    print(f"{where} dataset: {len(a):,} rows x 4 predicate columns")
    # Synopsis optimized for the 2-D template (pickup time x dropoff time).
    syn, rep = build_synopsis(c[:, :2], a, k=args.k, sample_rate=0.01,
                              kind="sum", method="kd", device=dev)
    print(f"{where} KD-PASS built for the 2-D template in "
          f"{rep.seconds_total:.2f}s")

    eng = PassEngine(syn, serving=ServingConfig(kinds=("sum",)), device=dev)
    templates = {}
    for t in (1, 2, 3, 4):
        qs_t = random_queries(c[:, :t], nq, seed=42 + t, min_frac=0.1,
                              max_frac=0.5, device="cpu")
        shared = min(t, 2)
        lo = np.full((nq, 2), -np.inf, np.float32)
        hi = np.full((nq, 2), np.inf, np.float32)
        lo[:, :shared] = qs_t.lo.numpy()[:, :shared]
        hi[:, :shared] = qs_t.hi.numpy()[:, :shared]
        qs2 = QueryBatch(torch.from_numpy(lo).to(dev),
                         torch.from_numpy(hi).to(dev))
        res = eng.answer(qs2)["sum"]
        gt = ground_truth(c[:, :2], a, qs2, kind="sum")
        keep = np.abs(gt) > 1e-9
        err = float(np.median(relative_error(res, gt)[keep]))
        sr = float(np.median(skip_rate(syn, qs2).cpu().numpy()))
        templates[t] = {"median_rel_err": err, "skip_rate": sr}
        print(f"{where} Q{t} template ({shared} shared attrs): median rel "
              f"err {err*100:6.3f}%   skip rate {sr*100:5.1f}%")

    return {"device": device_label(dev), "templates": templates,
            "stream": streaming_demo(dev, where, args.scale, nq)}


def streaming_demo(dev, where, scale, nq) -> dict:
    """Continuous ingest + delta-merge serving + drift-triggered reopt."""
    print(f"\n{where} -- data shift: continuous ingest (streaming "
          "subsystem) --")
    c4, a = synthetic.nyc_taxi(scale=scale, dims=1)
    c = np.asarray(c4).reshape(-1)
    a = np.asarray(a)
    syn, _ = build_synopsis(c, a, k=64, sample_rate=0.02, kind="sum",
                            device=dev)
    rng = np.random.default_rng(7)
    n_new = len(a) // 2
    c_new = rng.uniform(c.max(), c.max() * 1.5, n_new)  # new territory
    a_new = rng.lognormal(1.5, 1.0, n_new)

    ing = StreamingIngestor(syn, seed=1, device=dev)
    batch = 2048
    for i in range(0, n_new - batch + 1, batch):
        ing.ingest(c_new[i:i + batch], a_new[i:i + batch])
    streamed = (n_new // batch) * batch
    print(f"{where} streamed {streamed:,} rows in {streamed // batch} "
          f"vectorized batches; staleness {ing.staleness():.2f}, "
          f"out-of-box {ing.oob_frac():.2f}")

    c_all = np.concatenate([c, c_new[:streamed]])
    a_all = np.concatenate([a, a_new[:streamed]])
    qs = random_queries(c_all, nq, seed=9, min_frac=0.05, max_frac=0.4,
                        device=dev)
    gt = ground_truth(c_all, a_all, qs, kind="sum")
    keep = np.abs(gt) > 1e-9
    drift_q = (qs.hi.cpu().numpy().reshape(-1) > c.max())[keep]
    out = {}

    def report(label, res):
        rel = relative_error(res, gt)[keep]
        out[label] = (float(np.median(rel)), float(np.median(rel[drift_q])))
        print(f"{where}   {label:34s} median rel err "
              f"{out[label][0]*100:6.3f}% (drift-touching queries "
              f"{out[label][1]*100:6.3f}%)")

    report("frozen base (stale)", PassEngine(syn, device=dev).answer(qs)["sum"])
    # One engine serves the live stream; replace_source() swaps in the
    # re-optimized ingestor and invalidates every prepared plan.
    live = PassEngine(ing, device=dev)
    report("delta-merged stream", live.answer(qs)["sum"])
    pol = DriftPolicy(staleness_threshold=0.2)
    ing2, rep = pol.maybe_reoptimize(ing, c_all, a_all)
    assert rep is not None
    live.replace_source(ing2)
    report("re-optimized (dp_monotone_device)", live.answer(qs)["sum"])
    return out


if __name__ == "__main__":
    main()
