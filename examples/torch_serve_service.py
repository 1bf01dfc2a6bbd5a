"""Multi-tenant AQP service on the PyTorch port: concurrent tenants against
one PassEngine on the CUDA card through the request coalescer.

The flow and numbers of examples/serve_service.py (the JAX package's): a
synopsis is built offline, a `RequestCoalescer` + `TickDriver` front it,
and N tenant threads fire small ragged query batches concurrently. The
coalescer packs each tick's queue into padded shape-class batches (one
engine dispatch per class) and demuxes bit-identical per-tenant results
back through futures. Shed requests (admission control) are retried with
backoff, as a real client would.

Artifacts land in a run directory (`--out`): `stats.json` with the
coalescer + engine + per-tenant accounting snapshot and the device it ran
on, and a printed summary of dispatch amortization and queue-wait
percentiles. Every line of output names the device.

    PYTHONPATH=src python examples/torch_serve_service.py [--tenants 8]
    PYTHONPATH=src python examples/torch_serve_service.py --ci 0.95 --seconds 3
"""
import argparse
import json
import pathlib
import threading
import time

import numpy as np

from repro_torch.api import PassEngine, ServingConfig, CIConfig, CoalescerConfig
from repro_torch.core import build_synopsis, random_queries
from repro_torch.data import synthetic
from repro_torch.device import device_label, resolve_device
from repro_torch.serve import RequestCoalescer, TickDriver, Overloaded


def tenant_loop(name, co, c, stop, out, seed, dev, batch_lo=3, batch_hi=18):
    """One tenant: ragged submissions, retry-with-backoff on shed."""
    rng = np.random.default_rng(seed)
    served = shed = 0
    while not stop.is_set():
        qs = random_queries(c, int(rng.integers(batch_lo, batch_hi)),
                            seed=int(rng.integers(1 << 31)), device=dev)
        try:
            res = co.answer(name, qs, timeout=30.0)
            assert set(res) == set(co.engine.serving.kinds)
            served += 1
        except Overloaded:
            shed += 1
            time.sleep(0.002 * (1 + rng.random()))   # jittered backoff
    out[name] = {"served_requests": served, "shed_retries": shed}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--kinds", type=str, default="sum,count,avg")
    ap.add_argument("--ci", type=float, default=None,
                    help="confidence level (e.g. 0.95), served per tick "
                         "through the same coalesced dispatches")
    ap.add_argument("--tick-ms", type=float, default=2.0)
    ap.add_argument("--shape-classes", type=str, default="8,32,128")
    ap.add_argument("--out", type=str, default="runs/serve_service")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)
    where = f"[{label}]"

    c, a = synthetic.nyc_taxi(scale=args.scale)
    syn, rep = build_synopsis(c, a, k=args.k, sample_rate=0.01, kind="sum",
                              device=dev)
    print(f"{where} [serve] synopsis ready ({rep.seconds_total:.2f}s build, "
          f"k={rep.k}, {rep.total_samples} samples)")

    eng = PassEngine(
        syn,
        serving=ServingConfig(kinds=tuple(args.kinds.split(","))),
        ci=CIConfig(level=args.ci) if args.ci else None, device=dev)
    co = RequestCoalescer(eng, CoalescerConfig(
        tick_ms=args.tick_ms,
        shape_classes=tuple(int(s) for s in args.shape_classes.split(",")),
        max_outstanding=4, max_queue_depth=16 * args.tenants))

    # Warm the per-class prepared entries so tenant latencies below measure
    # serving, not the first call's set-up (and the kernels' first load).
    for b in co.config.shape_classes:
        warm = random_queries(c, b, seed=7, device=dev)
        prepared = eng.prepare((b, syn.d))
        prepared(warm)
        prepared(warm)
    print(f"{where} [serve] warmed shape classes {co.config.shape_classes}")

    stop = threading.Event()
    tenant_stats: dict = {}
    threads = [threading.Thread(
        target=tenant_loop, name=f"tenant-{i}",
        args=(f"tenant-{i}", co, c, stop, tenant_stats, 1000 + i, dev),
        daemon=True) for i in range(args.tenants)]
    with TickDriver(co):
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
        # driver exit flushes anything still queued

    s = co.stats()
    waits = [t["wait_p95_ms"] for t in s["tenants"].values()]
    print(f"{where} [serve] {args.tenants} tenants for {args.seconds:.1f}s: "
          f"{s['served']} requests served, {s['shed']} shed, "
          f"{s['dispatches']} engine dispatches over {s['ticks']} ticks")
    if s["dispatches"]:
        print(f"{where} [serve] amortization "
              f"{s['coalesced_rows'] / s['dispatches']:.1f} rows/dispatch "
              f"(pad overhead "
              f"{s['padded_rows'] / max(s['coalesced_rows'], 1):.2f}), "
              f"queue-wait p95 {max(waits):.2f} ms worst tenant")
    run_dir = pathlib.Path(args.out)
    run_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "device": label,
        "config": {"tenants": args.tenants, "seconds": args.seconds,
                   "k": args.k, "kinds": args.kinds, "ci": args.ci,
                   "tick_ms": args.tick_ms,
                   "shape_classes": args.shape_classes},
        "coalescer": s,
        "engine": {k: v for k, v in eng.stats().items()
                   if k != "coalescer"},
        "tenant_clients": tenant_stats,
    }
    path = run_dir / "stats.json"
    path.write_text(json.dumps(payload, indent=2, sort_keys=True,
                               default=str))
    print(f"{where} [serve] wrote {path}")
    return payload


if __name__ == "__main__":
    main()
