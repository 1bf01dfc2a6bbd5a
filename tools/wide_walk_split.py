"""Where a wide (d > 16) kernel spends its time: the kernel built from
this checkout's sources and from copies with one part taken out, timed on
the card at chip_smoke.py phase 30's shape (the 24-column table at paper
size: build_synopsis(k=1024, sample_rate=0.01, method="kd"), its 2048
queries).

    python3 tools/wide_walk_split.py
        [--target stratified|weighted|join|query_eval|route]
        [--reps N] [--out FILE] [--csrc DIR]

The variants patch a source in a copy of csrc/ (this checkout's, or
--csrc DIR's) and build it with the port's nvcc flags. Each patch names
the text it replaces; a variant may list other patch sets for other
versions of the source, and the first whose texts are each found exactly
once applies. A variant none of whose sets applies (the code was edited
since) is left out and reported as stale, so the tool times what still
applies.

Target ``stratified`` (the default): row 2's one pass, csrc/pair_tiles.cuh
patched, csrc/stratified_moments.cu built:

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

Target ``weighted``: rows 3 (R = 1, the scan's launch) and 4 (R = 200,
the fused bootstrap's weights), csrc/weighted_moments.cu patched and
built; each variant also read by kernel (the profiler's mean record of
each weighted_*_kernel a launch):

    full        the kernels as they are;
    no_walk     no group walk (totals, boxes, classes, slot tests);
    no_stage    the test kernel stages no column (it tests stale rows);
    no_tests    the test kernel tests no column (a MAYBE pair keeps its
                valid bits, so the walks fold more);
    all_columns every MAYBE pair tests every column (no cut words);
    walk_no_fold    the walks fold no slot of a MAYBE pair;
    walk_no_writes  the walks write no row;
    bank_conflicts  the class kernel's bound rows unpadded (16 floats);
    no_hold     the class kernel compares every column, not only those
                where the query does not hold the tile's box;
    four_pairs, one_pair  the slot tests take 4 / 1 pairs a round, not 2;
    runs_256, runs_1024   the test kernel's runs of 256 / 1024 queries,
                not 512;
    one_group_units  a replicate-walk unit takes one group, not two
                neighbouring ones (a row's 96 bytes go out alone).

Target ``join``: row 9 (join_cell_moments) at phase 30's join shape
(wide_join_data: D = 25, Q = 2048, k = 1024, P = 16, 7.7 M fact rows,
p_u = 0.05), csrc/join_moments.cu patched and built; each variant also
read by kernel (the cells kernel, the tile kernel, the exact kernel).
The same variant names apply to the earlier column-block tile kernel
(``join_tile_kernel<VW, -1>``) and to the wide tile kernel that replaced
it (``join_tile_wide_kernel``), each through the patches that match its
source (--csrc times another checkout's):

    full        the kernels as they are;
    no_walk     the mixed pairs are never walked (their results stale);
    no_stores   no plane is stored (classes, walks);
    no_walk_no_stores  the class pass and the set-up alone;
    no_tests    (wide tile kernel) the walks stage but test no column;
    no_stage    (wide tile kernel) the walks stage no row (they test
                stale rows);
    no_fold     (wide tile kernel) the walks test but fold no slot;
    setup_only  (wide tile kernel) neither classes nor walks nor stores:
                the tile's totals, flags, runs and the rounds' bookkeeping;
    class_no_stage    (wide tile kernel) no walk or store, and the class
                pass stages no box or bound (it compares stale ones);
    class_no_compare  (wide tile kernel) no walk or store, and the class
                pass compares no pair (every live pair mixed).

Before the variants the join target prints the cut-column histograms of
chip_smoke.join_cut_histogram at that shape.

Target ``query_eval``: row 1 at phase 30's answer shape (the 24-column
synopsis's 1024 leaf boxes and aggregates, its 2048 queries),
csrc/query_eval.cu patched and built; the variants apply to the
column-block kernel (``query_eval_kernel<-1, VEC>`` before its redesign)
and to the wide kernel that replaced it, each through the patches that
match its source:

    full         the kernel as it is;
    no_box_loads the leaves' boxes never read from device memory (the
                 column-block kernel: constant boxes; the wide kernel: the
                 copies read 8 leaves' rows over and over, from L1);
    no_classify  no (query, leaf) compare (the non-empty pass and, in the
                 wide kernel, the tile box and cut masks stay);
    no_stores    no rel row written;
    no_walk      steps 3 and 4 (the covered lists and their walk) left out;
    all_columns  (wide kernel) every pair compared on every column, not
                 only its query's cut ones;
    no_tile_box  (wide kernel) the tile's box never folded over the
                 block (its partials and shuffles left out; stale cuts).

Before the variants it prints the cut-column histogram of each (query,
leaf tile), chip_smoke.qe_cut_histogram.

Target ``route``: row 7 at the wide stream's first 4096-row batch (phase
30's stream, wide_table(nyc_taxi, 0.1, seed=7)) against the same
synopsis's 1024 leaf boxes, csrc/route_multid.cu patched and built, its
launch plan the one the library's wrapper of its version uses:

    full          the kernel as it is;
    no_row_loads  the rows' coordinates never read from device memory
                  (constants; the redesigned kernel: stale shared memory);
    no_box_loads  the leaves' boxes never read (constants, or, in the
                  redesigned kernel, stale staged tiles);
    no_dist       each term the box's lower bound alone (no subtract, no
                  max): the distance loop's arithmetic left out.

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

STRATIFIED = {
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

WEIGHTED = {
    "no_walk": [("  // Above one chunk the walk writes the partials.\n",
                 "  return 0;\n")],
    "no_stage": [("        if (r < n && cc < nj)\n          cp_async4(dst",
                  "        if (false)\n          cp_async4(dst")],
    "no_tests": [
        ("      for (uint32_t todo = __ballot_sync(\n"
         "               0xffffffffu, live != 0u && col[u]",
         "      for (uint32_t todo = 0u * __ballot_sync(\n"
         "               0xffffffffu, live != 0u && col[u]"),
        ("    for (uint32_t todo = __ballot_sync(0xffffffffu, every && live",
         "    for (uint32_t todo = 0u * __ballot_sync(0xffffffffu, every && live")],
    "all_columns": [("  const bool keep_cuts = d <= CUT_COLS;\n  constexpr int PL",
                     "  const bool keep_cuts = false;\n  constexpr int PL")],
    "walk_no_fold": [
        ("              while (bits) {\n                const int j = o",
         "              while (false) {\n                const int j = o"),
        ("              while (bits) {\n                const float4 x",
         "              while (false) {\n                const float4 x")],
    "walk_no_writes": [
        ("  if (vec) {\n    constexpr int P = 3 * GROUP / 4;",
         "  if (lane >= 0) return;\n  if (vec) {\n"
         "    constexpr int P = 3 * GROUP / 4;")],
    "bank_conflicts": [("  constexpr int QP = WIDE_COLS + 1;",
                        "  constexpr int QP = WIDE_COLS;")],
    "no_hold": [("        for (uint32_t todo = test; todo != 0u; todo &= todo - 1u) {",
                 "        for (uint32_t todo = (1u << nj) - 1u; todo != 0u;\n"
                 "             todo &= todo - 1u) {")],
    "four_pairs": [("constexpr int NP = 2;", "constexpr int NP = 4;")],
    "one_pair": [("constexpr int NP = 2;", "constexpr int NP = 1;")],
    "runs_256": [("constexpr int TQ = 512;", "constexpr int TQ = 256;")],
    "runs_1024": [("constexpr int TQ = 512;", "constexpr int TQ = 1024;")],
    "one_group_units": [("  const int n_rb = (R + WRB - 1) / WRB, n_pair = (p.n_groups + 1) / 2;",
                         "  const int n_rb = (R + WRB - 1) / WRB, n_pair = p.n_groups;"),
                        ("  const int G2 = 2 * p.gs;                           // segments a unit",
                         "  const int G2 = p.gs;                           // segments a unit")],
}
# Row 9: each variant a list of patch sets, the column-block tile
# kernel's first (OLD_*), then the wide tile kernel's (NEW_*).
OLD_NO_WALK = [("        walk_run_wide(run,", "        if (false) walk_run_wide(run,")]
OLD_NO_STORES = [("          if (VW == 4)\n            __stcs(",
                  "          if (false)\n            __stcs("),
                 ("          else\n            __stcs(orow + st * plane + u, v[0]);",
                  "          else if (false)\n            __stcs(orow + st * plane + u, v[0]);")]
NEW_NO_WALK = [("    walk_cells(r, coord,", "    if (false) walk_cells(r, coord,")]
NEW_NO_STORES = [("    store_rows<VW>(r, out,",
                  "    if (false) store_rows<VW>(r, out,")]
JOIN = {
    "no_walk": [OLD_NO_WALK, NEW_NO_WALK],
    "no_stores": [OLD_NO_STORES, NEW_NO_STORES],
    "no_walk_no_stores": [OLD_NO_WALK + OLD_NO_STORES,
                          NEW_NO_WALK + NEW_NO_STORES],
    "no_tests": [[("      my = test_items(my,", "      if (false) my = test_items(my,")]],
    "no_stage": [[("    for (int e = lane; e < head; e += 32) cp_async4(",
                   "    for (int e = lane; false && e < head; e += 32) cp_async4("),
                  ("      cp_async16(x0 + head + 4 * k, src + head + 4 * k);",
                   "      if (false) cp_async16(x0 + head + 4 * k, src + head + 4 * k);"),
                  ("    for (int e = head + 4 * chunks + lane; e < total; e += 32)",
                   "    for (int e = head + 4 * chunks + lane; false && e < total; e += 32)")]],
    "no_fold": [[("      fold_window(acc,", "      if (false) fold_window(acc,")]],
    "setup_only": [NEW_NO_WALK + NEW_NO_STORES + [
        ("  classify_wide(r, cell_box,", "  if (false) classify_wide(r, cell_box,")]],
    "class_no_stage": [NEW_NO_WALK + NEW_NO_STORES + [
        ("    for (int i = tid; i < nc * 2 * nj; i += NT) {",
         "    for (int i = tid; false && i < nc * 2 * nj; i += NT) {"),
        ("    for (int i = tid; i < 2 * nq * nj; i += NT) {",
         "    for (int i = tid; false && i < 2 * nq * nj; i += NT) {")]],
    "class_no_compare": [NEW_NO_WALK + NEW_NO_STORES + [
        ("      if (!((walk >> i) & 1u)) continue;",
         "      if (true) continue;")]],
}
# Row 1: each variant a list of patch sets, the column-block branch
# of query_eval_kernel first (QE_OLD), then the wide kernel's (QE_NEW).
QE_OLD_STORES = ("          const bool disjoint = !nonempty | ((dis >> at) & 1u);\n"
                 "          code[u] = cover ? 2 : (disjoint ? 0 : 1);\n"
                 "          bits |= (unsigned)cover << u;\n        }\n"
                 "        int32_t* row = rel + (size_t)(q0 + qq) * k;\n"
                 "        if (VEC) {\n          if (leaf0 < k)")
QE_WALK = [("    if (warp < nq) {\n      unsigned m = s_mask[warp][lane];",
            "    if (false) {\n      unsigned m = s_mask[warp][lane];"),
           ("    if (walker) {\n      const int batches",
            "    if (false) {\n      const int batches")]
QE_NEW_COPY = ("        const size_t src = (size_t)(k0 + l) * d + j0 + 4 * c;")
QE_NEW_MASK = ("          const unsigned cm =\n"
               "              ((qq < 4 ? cut[0] : cut[1]) >> (WC * (qq & 3))) & 0xffu;")
QE_NEW_STORE = ("          if (k0 + l < k) row[k0 + l] = cover ? 2 : "
                "(disjoint ? 0 : 1);")
QUERY_EVAL = {
    "no_box_loads": [
        [("              lo[j][u] = in ? leaf_lo[row + j] : 1.f;\n"
          "              hi[j][u] = in ? leaf_hi[row + j] : -1.f;",
          "              lo[j][u] = in ? 0.25f * (j - u) : 1.f;\n"
          "              hi[j][u] = in ? 0.5f * (j + u) : -1.f;")],
        [(QE_NEW_COPY, QE_NEW_COPY.replace("(k0 + l)", "(k0 + (l & 7))"))]],
    "no_classify": [
        [("        for (int qq = 0; qq < nq; ++qq) {\n#pragma unroll\n"
          "          for (int u = 0; u < LPT; ++u) {\n"
          "            bool cover = true, disjoint = false;",
          "        for (int qq = 0; qq < 0; ++qq) {\n#pragma unroll\n"
          "          for (int u = 0; u < LPT; ++u) {\n"
          "            bool cover = true, disjoint = false;")],
        [("          if (cm == 0u) continue;", "          if (true) continue;")]],
    "no_stores": [[(QE_OLD_STORES,
                    QE_OLD_STORES.replace("leaf0 < k)", "leaf0 < 0)"))],
                  [(QE_NEW_STORE, QE_NEW_STORE.replace("k0 + l < k", "l < 0"))]],
    "no_walk": [QE_WALK],
    # (wide kernel) every column compared, not only the cut ones
    "all_columns": [[(QE_NEW_MASK,
                      "          const unsigned cm = (1u << nj) - 1u;")]],
    # (wide kernel) the tile's box never folded (every column cut: the
    # partials and their shuffles left out)
    "no_tile_box": [[("        if ((lane & 1) == 0) s_tred[warp][(lane >> 1) & 15] = v[0];",
                      "        if (lane < 0) s_tred[warp][(lane >> 1) & 15] = v[0];")]],
}
# Row 7: the column-block kernel's patches first, then the wide
# kernel's that replaced it.
RT_NEW_TERM = ("              const float t =\n"
               "                  fmaxf(fmaxf(la[u] - x[r][j], x[r][j] - ha[u]), 0.f);")
ROUTE = {
    "no_row_loads": [
        [("          x[r][j] = (row < B && j < nj) ? c[(size_t)row * d + j0 + j] : 0.f;",
          "          x[r][j] = (row < B && j < nj) ? 0.125f * (j + r) : 0.f;")],
        # the redesigned kernel: the rows read from (stale) shared memory
        [("      const float* src = c + (size_t)min(row0 + r * 32 + lane, B - 1) * d;",
          "      const float* src = s_lo + 4 * ((r * 32 + lane) % 8);")]],
    "no_box_loads": [
        [("              const float bl = lo[j], bh = hi[j];",
          "              const float bl = 0.5f * (j + l), bh = bl + 1.f;")],
        [("  if (vec) {\n    const int per = nj >> 2;",
          "  if (lane < 0) {\n    const int per = nj >> 2;"),
         ("    for (int i = lane; i < n * nj; i += 32) {\n"
          "      const int l = i / nj, j = i - l * nj;",
          "    for (int i = lane; false && i < n * nj; i += 32) {\n"
          "      const int l = i / nj, j = i - l * nj;")]],
    "no_dist": [
        [("                const float t = fmaxf(fmaxf(bl - x[r][j], x[r][j] - bh), 0.f);",
          "                const float t = bl;")],
        [(RT_NEW_TERM, "              const float t = la[u];")]],
}
# Per target: the file the patches edit, the source built, the variants.
TARGETS = {"stratified": ("pair_tiles.cuh", "stratified_moments.cu",
                          STRATIFIED),
           "weighted": ("weighted_moments.cu", "weighted_moments.cu",
                        WEIGHTED),
           "join": ("join_moments.cu", "join_moments.cu", JOIN),
           "query_eval": ("query_eval.cu", "query_eval.cu", QUERY_EVAL),
           "route": ("route_multid.cu", "route_multid.cu", ROUTE)}


def patched(text: str, patches):
    """``text`` with ``patches`` applied (a list of (old, new) pairs, or a
    list of such lists tried in order), or None when no set's texts are
    each found exactly once."""
    sets = patches if patches and isinstance(patches[0], list) else [patches]
    for one in sets:
        if all(text.count(old) == 1 for old, _ in one):
            for old, new in one:
                text = text.replace(old, new)
            return text
    return None


def build(name: str, target: str, patches, out_dir: Path, csrc: Path):
    """Copy csrc, apply ``patches`` to the target's file, start nvcc on its
    source; None when no patch set applies (patched)."""
    from repro_torch.kernels import native
    edited, source, _ = TARGETS[target]
    text = patched((csrc / edited).read_text(), patches)
    if text is None:
        return None
    src = out_dir / name
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(csrc, src)
    (src / edited).write_text(text)
    lib = out_dir / f"{name}.so"
    proc = subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib),
         str(src / source)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, lib


def stratified_calls(torch, libs, sm, ql, qh):
    """{(variant, ""): one launch of row 2} for each built variant."""
    from repro_torch.kernels.stratified_estimate import pair_scratch_floats
    k, s, d = sm[0].shape
    Q = ql.shape[0]
    if pair_scratch_floats(Q, k, s, d, 3):
        raise SystemExit("wide_walk_split: times the one pass (s <= 2048)")
    out = torch.empty((Q, k, 3), dtype=torch.float32, device=ql.device)
    calls = {}
    for name, lib in libs.items():
        fn = lib.repro_stratified_moments
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(fn=fn, name=name):
            err = fn(*(x.data_ptr() for x in (*sm, ql, qh, out)), None, 0,
                     Q, k, s, d, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cuda error {err}")
        calls[name, ""] = run
    return calls


def weighted_calls(torch, cs, libs, syn, ql, qh):
    """{(variant, "R=<R>"): one launch of rows 3 and 4's entry} at R = 1
    (W[0]) and R = 200."""
    from repro_torch.kernels.stratified_estimate import (
        weighted_scratch_floats)
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    k, s, d = sm[0].shape
    Q = ql.shape[0]
    W = cs.boot_weights(torch, syn, ql.device)
    calls = {}
    for R, w in ((1, W[0].contiguous()), (int(W.shape[0]), W)):
        n = weighted_scratch_floats(R, Q, k, s, d)
        scratch = torch.empty(n, dtype=torch.float32, device=ql.device)
        out = torch.empty((R, Q, k, 3), dtype=torch.float32,
                          device=ql.device)
        for name, lib in libs.items():
            fn = lib.repro_bootstrap_moments
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + \
                [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run(fn=fn, name=name, w=w, out=out, scratch=scratch, n=n,
                    R=R):
                err = fn(*(x.data_ptr() for x in (*sm, w, ql, qh, out,
                                                  scratch)), n, R, Q, k, s,
                         d, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} R={R}: cuda error {err}")
            calls[name, f"R={R}"] = run
    return calls


def join_calls(torch, libs, args, p_u):
    """{(variant, ""): one launch of row 9's entry} on row 9's arguments
    (chip_smoke.join_inputs)."""
    from repro_torch.kernels.join_moments import (PLANES, _scales,
                                                  join_scratch_floats)
    slots, q_lo, q_hi, cover, sampled, agg, total = args
    k, su, P, D = (slots.num_leaves, slots.capacity, slots.num_partitions,
                   slots.d)
    Q, kp = q_lo.shape[0], k * P
    dev = q_lo.device
    planes = torch.empty((len(PLANES), Q, kp), dtype=torch.float32,
                         device=dev)
    exact3 = torch.empty((Q, 3), dtype=torch.float32, device=dev)
    touched = torch.empty((Q,), dtype=torch.float32, device=dev)
    scratch = torch.empty(join_scratch_floats(kp), dtype=torch.float32,
                          device=dev)
    ptrs = [x.data_ptr() for x in (
        slots.s_coord, slots.s_a, slots.s_last, slots.cell_start,
        slots.cell_box, q_lo, q_hi, cover, sampled, agg, total, planes,
        exact3, touched, scratch)]
    calls = {}
    for name, lib in libs.items():
        fn = lib.repro_join_cell_moments
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

        def run(fn=fn, name=name):
            err = fn(*ptrs, scratch.numel(), Q, k, su, P, D, *_scales(p_u),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cuda error {err}")
        calls[name, ""] = run
    return calls


def query_eval_calls(torch, libs, qe):
    """{(variant, ""): one launch of row 1} on qe = (leaf_lo, leaf_hi,
    leaf_agg, q_lo, q_hi)."""
    k, d = qe[0].shape
    Q, A = qe[3].shape[0], qe[2].shape[1]
    rel = torch.empty((Q, k), dtype=torch.int32, device=qe[3].device)
    exact = torch.empty((Q, A), dtype=torch.float32, device=qe[3].device)
    calls = {}
    for name, lib in libs.items():
        fn = lib.repro_query_eval
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(fn=fn, name=name):
            err = fn(*(x.data_ptr() for x in (*qe, rel, exact)), Q, k, d, A,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cuda error {err}")
        calls[name, ""] = run
    return calls


def route_calls(torch, libs, lo, hi, c):
    """{(variant, ""): one launch of row 7} on boxes (k, d) and rows (B,
    d), each library with the plan its version's wrapper gives it
    (route_launch_plan)."""
    from repro_torch.kernels.route import route_launch_plan, route_plan
    k, d = lo.shape
    B = c.shape[0]
    leaf = torch.empty((B,), dtype=torch.int32, device=c.device)
    dist = torch.empty((B,), dtype=torch.float32, device=c.device)
    calls = {}
    for name, lib in libs.items():
        fn = lib.repro_route_multid
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = (route_launch_plan(B, k, d)
                if hasattr(lib, "repro_route_wide_warps")
                else route_plan(B, k))

        def run(fn=fn, name=name, plan=plan):
            err = fn(*(x.data_ptr() for x in (lo, hi, c, leaf, dist)), B, k,
                     d, *plan, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cuda error {err}")
        calls[name, ""] = run
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", choices=sorted(TARGETS),
                    default="stratified")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--csrc", type=Path, default=None,
                    help="build this csrc directory (another checkout's) "
                    "in place of this checkout's")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wide_walk_split: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.data.synthetic import nyc_taxi
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import native
    csrc = args.csrc.resolve() if args.csrc else native.CSRC
    out_dir = ROOT / "build" / "wide_walk_split" / args.target
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = TARGETS[args.target][2]
    t0 = time.perf_counter()
    jobs = {n: build(n, args.target, p, out_dir, csrc)
            for n, p in {"full": [], **variants}.items()}
    stale = [n for n, job in jobs.items() if job is None]
    libs = {}
    for name, job in jobs.items():
        if job is None:
            continue
        proc, lib = job
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    if args.target == "join":
        from repro_torch.joins.executor import join_slots
        data, jsyn, _ = cs.wide_join_data()
        q_lo = torch.from_numpy(data[5]).to(dev)
        q_hi = torch.from_numpy(data[6]).to(dev)
        del data
        jargs = cs.join_inputs(torch, join_slots(jsyn), jsyn, q_lo, q_hi)
        calls = join_calls(torch, libs, jargs, cs.JOIN_PU)
        Q, (k, s, d) = q_lo.shape[0], jargs[0].s_coord.shape
        print(json.dumps({"classes": cs.join_classes(torch, jargs),
                          **cs.join_cut_histogram(torch, jargs),
                          "cut_columns_128_cell_tiles": cs.join_cut_histogram(
                              torch, jargs, tile=128)["tile_cut_columns"]}),
              flush=True)
    else:
        c, a = cs.wide_table(nyc_taxi, 1.0)
        q_lo, q_hi = cs.wide_queries(
            c, cs.WIDE_Q, cs.WIDE_SEED, sort=lambda x: torch.sort(
                torch.from_numpy(x).to(dev)).values.cpu().numpy())
        syn, _ = build_synopsis(c, a, k=1024, sample_rate=0.01, method="kd")
        del c, a
        ql = torch.from_numpy(np.ascontiguousarray(q_lo)).to(dev)
        qh = torch.from_numpy(np.ascontiguousarray(q_hi)).to(dev)
        sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
        k, s, d = syn.sample_c.shape
        Q = ql.shape[0]
        if args.target == "weighted":
            calls = weighted_calls(torch, cs, libs, syn, ql, qh)
        elif args.target == "query_eval":
            qe = (syn.leaf_lo, syn.leaf_hi, syn.leaf_agg, ql, qh)
            print(json.dumps({"qe_cut_columns": cs.qe_cut_histogram(
                torch, *qe[:2], ql, qh)}), flush=True)
            calls = query_eval_calls(torch, libs, qe)
        elif args.target == "route":
            cs_, _ = cs.wide_table(nyc_taxi, 0.1, seed=7)
            cb = torch.from_numpy(np.ascontiguousarray(
                cs_[:cs.STREAM_BATCH], np.float32)).to(dev)
            del cs_
            calls = route_calls(torch, libs, syn.leaf_lo, syn.leaf_hi, cb)
            Q = cb.shape[0]
        else:
            calls = stratified_calls(torch, libs, sm, ql, qh)

    if stale:
        print(json.dumps({"stale": stale}), flush=True)
    order = ["full", *(n for n in variants if n in libs), "full"]
    shapes = sorted({shape for _, shape in calls})
    rows = {}
    for name in order:
        for shape in shapes:
            fn = calls[name, shape]
            ev = cs.cuda_ms(torch, fn, reps=args.reps)
            row = rows.setdefault((name, shape), {"ms": [], "device_ms": [],
                                                  "by_kernel": []})
            row["ms"].append(ev)
            if args.target not in ("stratified", "query_eval", "route"):
                kby = cs.device_by_name(torch, fn, reps=min(args.reps, 10),
                                        tries=3)
                row["by_kernel"].append({n: v["ms_per_record"]
                                         for n, v in kby.items()})
                row["device_ms"].append(cs.records_ms(kby))
            else:
                row["device_ms"].append(cs.device_ms(
                    torch, fn, reps=args.reps, one_op=True, tries=3))
    lines = []
    for (name, shape), row in rows.items():
        line = {"variant": name, "shape": shape,
                "ms": statistics.mean(row["ms"]),
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
