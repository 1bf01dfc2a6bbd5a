#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py     # the whole check, one card

Phases, each of which fails the run:

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: the hand-written CUDA kernels from src/repro_torch/kernels/csrc.
3. Kernel against plain on the card at edge shapes (ragged Q and k, d up
   to 16, inverted empty leaves, ragged validity, s = 1, several tiles).
4. 1-D main path: nyc_taxi(scale=1.0) (7.7 M trips) -> build_synopsis(k=1024,
   sample_rate=0.01) -> random_queries(2048) -> PassEngine(all five kinds,
   ci=0.95).answer(), through the entry points a user calls. Both kernels'
   launch counts must rise in that window. Then: kernel = plain at these
   shapes, the answer = the port's CPU answer (first 512 queries), the truth
   inside [lower, upper] for 64 queries and every kind, median relative
   error of SUM.
5. 3-D path: nyc_taxi(scale=1.0, dims=3) with method="kd", the same checks.
6. Times (CUDA events, medians after warm-up) of answer() and of each
   kernel and its plain version at the main-path shapes, and a
   torch.profiler window over answer() for the device-busy share (its
   table goes to chiprun_out/).

The line before the last is the kernels JSON line; the last line is
{"ok": true, "device": {...}}. Any failure raises, so nothing is printed
after it and the exit code is not 0.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))

KINDS = ("sum", "count", "avg", "min", "max")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor) operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# Kernel vs plain: the bar tests/test_kernels.py sets for Pallas (fp32 sums
# taken in another order).
K_RTOL, K_ATOL = 3e-5, 1e-3
SOURCES = {
    "query_eval": ("src/repro_torch/kernels/csrc/query_eval.cu",
                   "src/repro/kernels/query_eval.py:64"),
    "stratified_moments": (
        "src/repro_torch/kernels/csrc/stratified_moments.cu",
        "src/repro/kernels/stratified_estimate.py:102"),
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs, each
    bracketed by CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(torch, fn, reps: int = 20) -> float:
    """Median host wall time of ``fn()`` ending in a synchronize, in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def close(name, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return
    the max absolute error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    both_inf = np.isinf(got) & np.isinf(want) & (np.sign(got) ==
                                                 np.sign(want))
    err = np.where(both_inf, 0.0, np.abs(got - want))
    bad = ~(err <= atol + rtol * np.abs(np.where(both_inf, 0.0, want)))
    if bad.any():
        i = np.argwhere(bad)[0]
        raise AssertionError(f"{name}: {int(bad.sum())} entries off, first "
                             f"at {tuple(i)}: {got[tuple(i)]} vs "
                             f"{want[tuple(i)]}")
    return float(err.max()) if err.size else 0.0


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_vs_plain(torch, tag, leaf_lo, leaf_hi, leaf_agg, sample_c,
                    sample_a, sample_valid, q_lo, q_hi) -> dict:
    """Both kernels against their plain versions on the same CUDA inputs.
    Relation codes and counts must be equal; exact[:, :3] and the sums meet
    rtol=3e-5, atol=1e-3. Returns the max absolute errors."""
    from repro_torch.kernels.query_eval import (query_eval_cuda,
                                                query_eval_plain)
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_moments_plain)
    rel_k, ex_k = query_eval_cuda(leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi)
    rel_p, ex_p = query_eval_plain(leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi)
    mom_k = stratified_moments_cuda(sample_c, sample_a, sample_valid, q_lo,
                                    q_hi)
    mom_p = stratified_moments_plain(sample_c, sample_a, sample_valid, q_lo,
                                     q_hi)
    torch.cuda.synchronize()
    if not torch.equal(rel_k, rel_p):
        n = int((rel_k != rel_p).sum())
        raise AssertionError(f"{tag}: query_eval rel differs in {n} pairs")
    if not torch.equal(mom_k[..., 0], mom_p[..., 0]):
        raise AssertionError(f"{tag}: stratified_moments counts differ")
    errs = {
        "query_eval": close(f"{tag} query_eval exact",
                            ex_k[:, :3].cpu(), ex_p[:, :3].cpu(),
                            K_RTOL, K_ATOL),
        "stratified_moments": max(
            close(f"{tag} stratified_moments[{i}]", mom_k[..., i].cpu(),
                  mom_p[..., i].cpu(), K_RTOL, K_ATOL) for i in (1, 2)),
    }
    emit(check="kernel_vs_plain", shape=tag,
         covered_pairs=int((rel_k == 2).sum()), max_abs_err=errs)
    return errs


def edge_cases(torch, dev) -> None:
    """Kernel = plain at shapes no block size divides, with inverted empty
    leaves, ragged validity, s = 1, several leaf tiles and slot chunks."""
    shapes = [(1, 1, 1, 1), (17, 5, 1, 3), (130, 53, 7, 3),
              (129, 257, 75, 1), (300, 600, 300, 2), (5, 9, 3, 16)]
    for Q, k, s, d in shapes:
        rng = np.random.default_rng(Q * 7919 + k)
        lo = rng.uniform(-1, 0.5, (k, d)).astype(np.float32)
        hi = lo + rng.uniform(0, 1, (k, d)).astype(np.float32)
        agg = rng.normal(0, 1, (k, 5)).astype(np.float32)
        agg[:, 2] = rng.integers(1, 50, k)
        if k > 2:
            lo[k // 2], hi[k // 2] = np.inf, -np.inf
            agg[k // 2] = [0, 0, 0, np.inf, -np.inf]
            hi[1] = lo[1] - 0.5
        c = rng.uniform(-1, 1, (k, s, d)).astype(np.float32)
        a = rng.normal(0, 3, (k, s)).astype(np.float32)
        valid = rng.random((k, s)) < 0.7
        valid[0] = False
        q_lo = rng.uniform(-1, 0, (Q, d)).astype(np.float32)
        q_hi = q_lo + rng.uniform(0, 1.5, (Q, d)).astype(np.float32)
        t = [torch.from_numpy(x).to(dev)
             for x in (lo, hi, agg, c, a, valid, q_lo, q_hi)]
        kernel_vs_plain(torch, f"edge Q={Q} k={k} s={s} d={d}", *t)


# ---------------------------------------------------------------------------
# Truth and the answer checks
# ---------------------------------------------------------------------------

def truth_1d(c, a, q_lo, q_hi) -> dict:
    """Exact answers of 1-D queries over the sorted column: float64 prefix
    sums for SUM/COUNT, slices for MIN/MAX. Membership is decided on the
    float32 coordinates against the float32 bounds, as the card stores
    them."""
    c32 = c.astype(np.float32)
    prefix = np.concatenate([[0.0], np.cumsum(a, dtype=np.float64)])
    lo_i = np.searchsorted(c32, q_lo[:, 0], side="left")
    hi_i = np.searchsorted(c32, q_hi[:, 0], side="right")
    hi_i = np.maximum(hi_i, lo_i)
    s = prefix[hi_i] - prefix[lo_i]
    cnt = (hi_i - lo_i).astype(np.float64)
    mn = np.array([a[i:j].min() if j > i else np.inf
                   for i, j in zip(lo_i, hi_i)])
    mx = np.array([a[i:j].max() if j > i else -np.inf
                   for i, j in zip(lo_i, hi_i)])
    return {"sum": s, "count": cnt, "avg": s / np.maximum(cnt, 1),
            "min": mn, "max": mx}


def truth_scan(torch, c, a, q_lo, q_hi, chunk: int = 1 << 20) -> dict:
    """Exact answers by a chunked float64 scan of every row on the card,
    independent of the engine; membership on float32 coordinates."""
    dev = torch.device("cuda")
    lo = torch.from_numpy(q_lo).to(dev)[:, None, :]
    hi = torch.from_numpy(q_hi).to(dev)[:, None, :]
    Q = q_lo.shape[0]
    s = torch.zeros(Q, dtype=torch.float64, device=dev)
    cnt = torch.zeros(Q, dtype=torch.float64, device=dev)
    mn = torch.full((Q,), float("inf"), dtype=torch.float64, device=dev)
    mx = torch.full((Q,), float("-inf"), dtype=torch.float64, device=dev)
    for start in range(0, c.shape[0], chunk):
        cc = torch.from_numpy(c[start:start + chunk].astype(np.float32)
                              ).to(dev)[None]
        aa = torch.from_numpy(a[start:start + chunk]).to(dev)[None]
        pred = ((lo <= cc) & (cc <= hi)).all(-1)              # (Q, chunk)
        s += torch.where(pred, aa, 0.0).sum(1)
        cnt += pred.sum(1)
        mn = torch.minimum(mn, torch.where(pred, aa, float("inf")).amin(1))
        mx = torch.maximum(mx, torch.where(pred, aa, float("-inf")).amax(1))
    s, cnt, mn, mx = (x.cpu().numpy() for x in (s, cnt, mn, mx))
    return {"sum": s, "count": cnt, "avg": s / np.maximum(cnt, 1),
            "min": mn, "max": mx}


def check_truth(tag, res, truth, n, max_median_err) -> dict:
    """Every defined truth inside [lower, upper]: SUM/COUNT always, AVG/
    MIN/MAX on non-empty queries (undefined on an empty set). Slack for
    the float32 storage of aggregates: 1e-4 relative for the fp32 sums over
    up to 1024 strata (SUM/COUNT/AVG), 1e-6 for MIN/MAX (one rounding)."""
    nonempty = truth["count"] > 0
    out = {"queries": n, "nonempty": int(nonempty.sum())}
    for kind in KINDS:
        t = truth[kind]
        lo = res[kind].lower[:n].cpu().numpy().astype(np.float64)
        hi = res[kind].upper[:n].cpu().numpy().astype(np.float64)
        slack = (1e-4 if kind in ("sum", "count", "avg") else 1e-6) \
            * np.abs(t) + 1e-6
        defined = np.ones(n, bool) if kind in ("sum", "count") else nonempty
        inside = (lo - slack <= t) & (t <= hi + slack)
        if not inside[defined].all():
            i = int(np.argwhere(defined & ~inside)[0, 0])
            raise AssertionError(f"{tag} {kind}: truth {t[i]} outside "
                                 f"[{lo[i]}, {hi[i]}] at query {i}")
    est = res["sum"].estimate[:n].cpu().numpy().astype(np.float64)
    t = truth["sum"]
    err = np.abs(est - t)[nonempty] / np.abs(t[nonempty])
    med = float(np.median(err)) if err.size else 0.0
    out["sum_median_rel_err"] = med
    if med > max_median_err:
        raise AssertionError(f"{tag}: median SUM relative error {med} > "
                             f"{max_median_err}")
    ci_in = [float(np.mean(((res[k].ci_lo[:n].cpu().numpy() <= t * 1.00001)
                            & (t * 0.99999 <= res[k].ci_hi[:n].cpu().numpy())
                            )[nonempty]))
             for k, t in ((k, truth[k]) for k in ("sum", "count", "avg"))]
    out["ci95_coverage_sum_count_avg"] = ci_in
    return out


def check_cpu_parity(torch, tag, syn, q, res, n: int = 512) -> None:
    """The same answer computed by the port on the CPU, for the first n
    queries. estimate/lower/upper/frac_rows_touched at rtol=3e-5 with atol
    3e-5 * max|estimate| (fp32 sums in another order); ci_half/ci_lo/ci_hi
    at rtol=1e-4 with atol 1e-4 * max|estimate| (differences of two fp32
    sums lose relative precision)."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.types import QueryBatch
    qc = QueryBatch(q.lo[:n].cpu(), q.hi[:n].cpu())
    cpu = PassEngine(syn.to("cpu"), ServingConfig(kinds=KINDS), ci=0.95,
                     device="cpu").answer(qc)
    for kind in KINDS:
        # Scale of the batch: empty queries' MIN/MAX estimates sit at the
        # +-3.4e38 sentinel and must not set it.
        want_est = np.abs(cpu[kind].estimate.numpy().astype(np.float64))
        want_est = want_est[want_est < 1e30]
        scale = float(want_est.max()) if want_est.size else 1.0
        for field, rtol, atol in (
                ("estimate", 3e-5, 3e-5 * scale),
                ("lower", 3e-5, 3e-5 * scale), ("upper", 3e-5, 3e-5 * scale),
                ("frac_rows_touched", 3e-5, 3e-5),
                ("ci_half", 1e-4, 1e-4 * scale),
                ("ci_lo", 1e-4, 1e-4 * scale), ("ci_hi", 1e-4, 1e-4 * scale)):
            close(f"{tag} cpu parity {kind}.{field}",
                  getattr(res[kind], field)[:n].cpu(),
                  getattr(cpu[kind], field), rtol, atol)
    emit(check="cpu_parity", path=tag, queries=n, ok=True)


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------

def main_path(torch, tag, c, a, method, truth_fn, max_median_err) -> dict:
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.query import random_queries
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.engine import executor
    from repro_torch.kernels import native

    native.reset_launches()
    executor.reset_op_counts()
    t0 = time.perf_counter()
    syn, report = build_synopsis(c, a, k=1024, sample_rate=0.01,
                                 method=method)
    q = random_queries(c, 2048, seed=3)
    eng = PassEngine(syn, ServingConfig(kinds=KINDS), ci=0.95)
    res = eng.answer(q)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    emit(path=tag, rows=int(a.shape[0]), sample_c=list(syn.sample_c.shape),
         samples=report.total_samples, build_s=report.seconds_total,
         build_and_first_answer_s=seconds, launches=launches,
         artifact_passes=dict(executor.OP_COUNTS))
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{tag}: kernel {name} was not launched by "
                                 "PassEngine.answer")
    for kind in KINDS:
        for field in ("estimate", "lower", "upper", "ci_lo", "ci_hi"):
            x = getattr(res[kind], field)
            if x.shape != (2048,) or x.device.type != "cuda":
                raise AssertionError(f"{tag} {kind}.{field}: {x.shape} on "
                                     f"{x.device}")
        if not torch.isfinite(res[kind].estimate).all():
            raise AssertionError(f"{tag} {kind}: non-finite estimate")

    errs = kernel_vs_plain(torch, f"{tag} main Q=2048 k=1024",
                           syn.leaf_lo, syn.leaf_hi, syn.leaf_agg,
                           syn.sample_c, syn.sample_a, syn.sample_valid,
                           q.lo, q.hi)
    check_cpu_parity(torch, tag, syn, q, res)
    n = 64
    q_lo = q.lo[:n].cpu().numpy()
    q_hi = q.hi[:n].cpu().numpy()
    truth = truth_fn(c, a, q_lo, q_hi)
    emit(check="truth", path=tag,
         **check_truth(tag, res, truth, n, max_median_err))
    return {"syn": syn, "q": q, "eng": eng, "launches": launches,
            "errs": errs}


# ---------------------------------------------------------------------------
# Times and bounds
# ---------------------------------------------------------------------------

def bounds(syn, q, rel, k_pred) -> dict:
    """Least time the card could take for each kernel's work on these
    inputs: max(bytes / HBM rate, operations / fp32 rate), each input read
    once and each output written once; data-dependent work counted as this
    run's data needs it (covered pairs, relevant samples)."""
    Q, d = q.lo.shape
    k, s = syn.sample_a.shape
    A = syn.leaf_agg.shape[1]
    covered = int((rel == 2).sum())
    relevant = float(k_pred.sum())
    valid = int(syn.sample_valid.sum())
    qe_bytes = 4 * (2 * k * d + k * A + 2 * Q * d) + 4 * Q * k + 4 * Q * A
    qe_ops = Q * k * (4 * d + 1) + covered * A
    sm_bytes = 4 * k * s * d + 4 * k * s + k * s + 8 * Q * d + 12 * Q * k
    sm_ops = 2 * d * Q * valid + 4 * relevant
    out = {}
    for name, nbytes, ops in (("query_eval", qe_bytes, qe_ops),
                              ("stratified_moments", sm_bytes, sm_ops)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_OPS_S * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "bytes": nbytes, "operations": ops}
    return out


def timings(torch, tag, run, card) -> dict:
    """CUDA-event medians at the main-path shapes."""
    from repro_torch.engine.executor import compute_artifacts
    from repro_torch.kernels import ops
    from repro_torch.kernels.query_eval import (query_eval_cuda,
                                                query_eval_plain)
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_moments_plain)
    syn, q, eng = run["syn"], run["q"], run["eng"]
    qe_args = (syn.leaf_lo, syn.leaf_hi, syn.leaf_agg, q.lo, q.hi)
    sm_args = (syn.sample_c, syn.sample_a, syn.sample_valid, q.lo, q.hi)
    rel, _ = query_eval_cuda(*qe_args)
    k_pred = stratified_moments_cuda(*sm_args)[..., 0]
    bnd = bounds(syn, q, rel, k_pred)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    eng.answer(q)
    torch.cuda.synchronize()
    answer_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 - base_mb
    times = {
        "answer": cuda_ms(torch, lambda: eng.answer(q)),
        "answer_host": host_ms(torch, lambda: eng.answer(q)),
        "artifacts": cuda_ms(torch, lambda: compute_artifacts(
            syn, q, KINDS)),
        "sample_extremes": cuda_ms(torch, lambda: ops.sample_extremes(
            *sm_args)),
        "query_eval": cuda_ms(torch, lambda: query_eval_cuda(*qe_args)),
        "query_eval_plain": cuda_ms(torch, lambda: query_eval_plain(
            *qe_args)),
        "stratified_moments": cuda_ms(torch, lambda: stratified_moments_cuda(
            *sm_args)),
        "stratified_moments_plain": cuda_ms(
            torch, lambda: stratified_moments_plain(*sm_args)),
    }
    emit(times_ms=times, path=tag, Q=int(q.lo.shape[0]),
         k=int(syn.num_leaves), s=int(syn.sample_a.shape[1]),
         d=int(syn.d), answer_peak_mb_above_resident=answer_peak_mb,
         bounds=bnd, card=card)
    return {"times": times, "bounds": bnd}


def profile_answer(torch, tag, run) -> None:
    """torch.profiler over 5 answers: device-busy time and kernels per
    answer; the table of the top device ops goes to chiprun_out/."""
    from torch.profiler import ProfilerActivity, profile
    eng, q = run["eng"], run["q"]
    for _ in range(3):
        eng.answer(q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            eng.answer(q)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(e.device_time if hasattr(e, "device_time") else e.cuda_time
                  for e in kernels)
    OUT.mkdir(exist_ok=True)
    sort_key = ("self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total")
        else "self_cuda_time_total")
    table = prof.key_averages().table(sort_by=sort_key, row_limit=25)
    (OUT / f"profile_{tag}.txt").write_text(table)
    emit(profile=tag, device_busy_ms_per_answer=busy_us / 1e3 / 5,
         device_kernels_per_answer=len(kernels) / 5)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import nyc_taxi
    from repro_torch.kernels import native

    # 1. Device.
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit(phase="device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. Build.
    t0 = time.perf_counter()
    logs = native.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         built=sorted(logs))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "error" in line:
                print(f"nvcc {name}: {line.strip()}", flush=True)

    # 3. Kernels against plain at edge shapes.
    edge_cases(torch, dev)

    # 4. 1-D main path; 5. 3-D path.
    t0 = time.perf_counter()
    c1, a1 = nyc_taxi(scale=1.0)
    c3, a3 = nyc_taxi(scale=1.0, dims=3)
    emit(phase="data", seconds=time.perf_counter() - t0,
         rows=int(a1.shape[0]))
    run1 = main_path(torch, "1d", c1, a1, "adp", truth_1d, 0.05)
    # Random 3-D boxes over the taxi columns select ~0.5 % of the rows and
    # many are empty, so the 3-D median error bar is looser (a CPU run at
    # scale 0.1 with the same 75 samples per stratum gave 0.057).
    run3 = main_path(torch, "3d", c3, a3, "kd",
                     lambda c, a, lo, hi: truth_scan(torch, c, a, lo, hi),
                     0.15)

    # 6. Times.
    t1 = timings(torch, "1d", run1, card)
    t3 = timings(torch, "3d", run3, card)
    profile_answer(torch, "1d", run1)
    profile_answer(torch, "3d", run3)

    # 7. The kernels line (1-D main-path shapes and launches).
    rows = []
    for name, (source, replaces) in SOURCES.items():
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run1["launches"][name],
            "launches_3d": run3["launches"][name],
            "max_abs_err": max(run1["errs"][name], run3["errs"][name]),
            "ms": t1["times"][name], "plain_ms": t1["times"][f"{name}_plain"],
            "bound_ms": t1["bounds"][name]["bound_ms"],
            "bound_by": t1["bounds"][name]["bound_by"],
            "library_ms": None,
            "ms_3d": t3["times"][name],
            "plain_ms_3d": t3["times"][f"{name}_plain"],
            "bound_ms_3d": t3["bounds"][name]["bound_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
