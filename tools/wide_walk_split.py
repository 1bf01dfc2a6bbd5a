"""Where row 2's wide one pass spends its time: the kernel built from this
checkout's sources and from copies with one part taken out, timed on the
card at chip_smoke.py phase 30's shape (the 24-column table at paper
size: build_synopsis(k=1024, sample_rate=0.01, method="kd"), its 2048
queries).

    python3 tools/wide_walk_split.py [--reps N] [--out FILE]

The variants patch csrc/pair_tiles.cuh in a copy and build
csrc/stratified_moments.cu with the port's nvcc flags. Each patch names
the text it replaces; a variant whose text is no longer found exactly once
in the source (the walk was edited since) is left out and reported as
stale, so the tool times what still applies:

    full       the kernel as it is;
    no_walk    the listed pairs are never walked (classes, tiles, stores);
    no_stage   the walks stage no column (they test stale rows);
    no_test    the walks stage but test no column;
    no_add     the walks fold no slot (they still write the pair);
    no_walk_no_cuts  no walk, and the classes note no cut column;
    two_blocks the kernel held to 128 registers (two blocks an SM), not
               64 (four);
    one_window the walks stage one window at a time;
    one_tile   a block a query tile (more blocks than one wave);
    dense_only the walks test every slot of a window (no one-by-one test);
    always_sparse  the walks test the held slots one by one;
    no_hold    the classes compare every column, not only those where the
               query does not hold the tile's box;
    no_box_once  the leaves' boxes formed for each query tile and column
               block, as above BOX_D columns, not once a block.

A taken-out part changes the results, so nothing here is checked against
plain: the times only say what each part costs. Each variant is timed by
CUDA events (the median of --reps calls, after a warm-up) and by the
profiler's device record, in turns (full first and last); the card's name
and power limit lead the output, one JSON line a variant follows.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PATCHES = {
    "no_walk": [("CUT_TILES ||\n        qt + p.groups >= p.n_qt) {\n"
                 "      walk_all(n_walk);\n",
                 "CUT_TILES ||\n        qt + p.groups >= p.n_qt) {\n")],
    "no_stage": [("      if (nuc > 0) {\n        // [leaf][column]",
                  "      if (false) {\n        // [leaf][column]")],
    "no_test": [("          if (every && mw != 0u) {",
                 "          if (false) {"),
                ("            if (use)\n              mw = dense ?",
                 "            if (false)\n              mw = dense ?")],
    "no_add": [("        if (last && on) {\n          const float* ar",
                "        if (false) {\n          const float* ar")],
    "no_walk_no_cuts": [
        ("CUT_TILES ||\n        qt + p.groups >= p.n_qt) {\n"
         "      walk_all(n_walk);\n",
         "CUT_TILES ||\n        qt + p.groups >= p.n_qt) {\n"),
        ("#pragma unroll\n        for (int o = 1; o < LT; o <<= 1)\n"
         "          cm |= __shfl_xor_sync(0xffffffffu, cm, o);\n"
         "        if (keep_cuts && pl == 0 && q < nq && cm != 0u) {",
         "        if (false) {")],
    "two_blocks": [("__launch_bounds__(NT, 4)\npair_tile_wide_kernel",
                    "__launch_bounds__(NT, 2)\npair_tile_wide_kernel")],
    "one_window": [("    wps = max(1, min(WALK_ROWS / nlr, cap / (nlr * room)));",
                    "    wps = 1;")],
    "one_tile": [("  set_groups(k, (long long)occ[dev][variant] * sms, &p);",
                  "  set_groups(k, wide ? 1LL << 40 : (long long)occ[dev]"
                  "[variant] * sms, &p);")],
    "dense_only": [("constexpr int SPARSE_MAX = 8;",
                    "constexpr int SPARSE_MAX = -1;")],
    "always_sparse": [("constexpr int SPARSE_MAX = 8;",
                       "constexpr int SPARSE_MAX = 32;")],
    "no_hold": [("          for (unsigned todo = ~s_hold[q] & ((1u << nj) - 1u);",
                 "          for (unsigned todo = (1u << nj) - 1u;")],
    "no_box_once": [("box_once = d <= BOX_D;", "box_once = false;")],
}


def build(name: str, patches, out_dir: Path):
    """Copy csrc, apply ``patches`` to pair_tiles.cuh, start nvcc; None
    when a patch's text is not found exactly once."""
    from repro_torch.kernels import native
    text = (native.CSRC / "pair_tiles.cuh").read_text()
    for old, new in patches:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    src = out_dir / name
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(native.CSRC, src)
    header = src / "pair_tiles.cuh"
    header.write_text(text)
    lib = out_dir / f"{name}.so"
    proc = subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib),
         str(src / "stratified_moments.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wide_walk_split: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.data.synthetic import nyc_taxi
    from repro_torch.kernels.stratified_estimate import pair_scratch_floats
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "wide_walk_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {n: build(n, p, out_dir)
            for n, p in {"full": [], **PATCHES}.items()}
    stale = [n for n, job in jobs.items() if job is None]
    libs = {}
    for name, job in jobs.items():
        if job is None:
            continue
        proc, lib = job
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).repro_stratified_moments
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    c, a = cs.wide_table(nyc_taxi, 1.0)
    q_lo, q_hi = cs.wide_queries(c, cs.WIDE_Q, cs.WIDE_SEED,
                                 sort=lambda x: torch.sort(torch.from_numpy(
                                     x).to(dev)).values.cpu().numpy())
    syn, _ = build_synopsis(c, a, k=1024, sample_rate=0.01, method="kd")
    del c, a
    ql = torch.from_numpy(np.ascontiguousarray(q_lo)).to(dev)
    qh = torch.from_numpy(np.ascontiguousarray(q_hi)).to(dev)
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    k, s, d = syn.sample_c.shape
    Q = ql.shape[0]
    if pair_scratch_floats(Q, k, s, d, 3):
        raise SystemExit("wide_walk_split: times the one pass (s <= 2048)")
    out = torch.empty((Q, k, 3), dtype=torch.float32, device=dev)

    def call(name):
        def run():
            err = libs[name](*(x.data_ptr() for x in (*sm, ql, qh, out)),
                             None, 0, Q, k, s, d,
                             torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cuda error {err}")
        return run

    card = cs.card_line()
    print(card, flush=True)
    if stale:
        print(json.dumps({"stale": stale}), flush=True)
    order = ["full", *(n for n in PATCHES if n in libs), "full"]
    rows = {}
    for name in order:
        fn = call(name)
        ev = cs.cuda_ms(torch, fn, reps=args.reps)
        dv = cs.device_ms(torch, fn, reps=args.reps, one_op=True, tries=3)
        row = rows.setdefault(name, {"ms": [], "device_ms": []})
        row["ms"].append(ev)
        row["device_ms"].append(dv)
    lines = []
    for name, row in rows.items():
        line = {"variant": name, "ms": statistics.mean(row["ms"]),
                "device_ms": cs.mean_of(row["device_ms"]),
                "readings": row, "Q": int(Q), "k": int(k), "s": int(s),
                "d": int(d), "card": card, "build_s": build_s}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out is not None:
        args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
