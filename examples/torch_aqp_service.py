"""AQP serving on the PyTorch port: batched approximate queries against a
PASS synopsis on the CUDA card through `PassEngine`, with the query-sharded
path of `repro_torch.core.distributed` on request.

The flow and numbers of examples/aqp_service.py (the JAX package's): a
synopsis is built offline, then a stream of query batches is answered with
latency stats, hard bounds and ESS / skip-rate accounting (paper §3.3).
Each request asks for several aggregate kinds at once (`--kinds
sum,count,avg`), all answered from one shared classification + moment pass
per batch. `--distributed` cuts every batch into `--shards` blocks on the
card's logical shard axis (the port's stand-in for a device mesh). Every
line of output names the device it was measured on.

    PYTHONPATH=src python examples/torch_aqp_service.py [--batches 20]
    PYTHONPATH=src python examples/torch_aqp_service.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import PassEngine, ServingConfig
from repro_torch.core import build_synopsis, ground_truth, random_queries
from repro_torch.core.estimators import ess, skip_rate
from repro_torch.core import distributed as dist
from repro_torch.data import synthetic
from repro_torch.device import device_label, resolve_device
from repro_torch.sharded.mesh import make_mesh


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--kinds", type=str, default="sum,count,avg",
                    help="comma-separated aggregate kinds per request")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    kinds = tuple(args.kinds.split(","))
    dev = resolve_device(args.device)
    where = f"[{device_label(dev)}]"

    c, a = synthetic.nyc_taxi(scale=args.scale)
    syn, rep = build_synopsis(c, a, k=args.k, sample_rate=0.01, kind="sum",
                              device=dev)
    print(f"{where} [service] synopsis ready ({rep.seconds_total:.2f}s "
          f"build, k={rep.k}, {rep.total_samples} samples, "
          f"{syn.storage_floats()*4/2**20:.2f} MiB)")

    mesh = None
    if args.distributed:
        mesh = make_mesh((args.shards,), ("data",), device=dev)
        print(f"{where} [service] distributed mode over {args.shards} "
              "logical shards")
        if kinds != ("sum",):
            print("[service] note: the sharded serving path answers SUM "
                  f"only; ignoring --kinds {args.kinds}")
            kinds = ("sum",)

    # Configure once, serve many: the engine pins a prepared plan per batch
    # shape, so the steady-state loop below never re-does Python-side setup.
    eng = PassEngine(syn, serving=ServingConfig(kinds=kinds), device=dev)
    prepared = eng.prepare((args.batch_size, syn.d))
    warm = random_queries(c, args.batch_size, seed=99, device=dev)
    prepared(warm)
    prepared(warm)
    _sync(dev)

    lat, errs = [], {kd: [] for kd in kinds}
    for b in range(args.batches):
        qs = random_queries(c, args.batch_size, seed=100 + b, device=dev)
        t0 = time.perf_counter()
        if mesh is not None:
            est, _ci, _lo, _hi = dist.serve_queries_sharded(mesh, syn, qs,
                                                            kind="sum")
            _sync(dev)
            res = {"sum": est.cpu().numpy()}
        else:
            out = prepared(qs)
            _sync(dev)
            res = {kd: out[kd].estimate.cpu().numpy() for kd in kinds}
        lat.append(time.perf_counter() - t0)
        for kd, est in res.items():
            gt = ground_truth(c, a, qs, kind=kd)
            keep = np.abs(gt) > 1e-9
            errs[kd].append(np.median(np.abs(est - gt)[keep]
                                      / np.abs(gt)[keep]))
    qs = random_queries(c, args.batch_size, seed=0, device=dev)
    e = ess(syn, qs).cpu().numpy()
    s = skip_rate(syn, qs).cpu().numpy()
    served = len(kinds) if mesh is None else 1
    med_lat = float(np.median(lat))
    print(f"{where} [service] {args.batches} batches x {args.batch_size} "
          f"queries x {served} aggregate kind(s)/request")
    print(f"{where} [service] median latency/batch {med_lat*1000:.2f} ms "
          f"({med_lat/args.batch_size*1e6:.1f} us/query, steady-state, host "
          "clock to a synchronize; one classification + one moment pass "
          "per batch)")
    for kd, ee in errs.items():
        if ee:
            print(f"{where} [service] median rel err [{kd}] "
                  f"{np.median(ee)*100:.3f}%")
    print(f"{where} [service] mean ESS {e.mean():.1f} samples/query, "
          f"mean skip rate {s.mean()*100:.1f}%")
    return {"device": device_label(dev), "median_latency_ms": med_lat * 1e3,
            "median_rel_err": {kd: float(np.median(ee))
                               for kd, ee in errs.items() if ee},
            "mean_ess": float(e.mean()), "mean_skip_rate": float(s.mean())}


if __name__ == "__main__":
    main()
