#!/usr/bin/env python3
"""How far rows 3 and 4's slot-order fold lies from the plain version at
several slot chunks, on the CPU.

    PYTHONPATH=src python3 tools/weighted_chunk_error.py

Rows 3 and 4 (``csrc/weighted_moments.cu``) fold each (query, stratum,
replicate) sum slot by slot in float32 from +0.0 over a chunk of
consecutive slots, then fold the chunks' partials in chunk order; the
plain version (``bootstrap_moments_plain``) sums the slots by a pairwise
tree. This replays the kernel's order in numpy (each product and sum
rounded to float32 once, as ``weighted_terms`` / ``weighted_add`` pin
them) at chunks of 32,768, 8,192 and 2,048 slots, on three shapes of
``chip_smoke.py``'s WEIGHTED_CHUNK_CASES with its ``chunk_case`` inputs
banded at 32,768 slots (values N(0, 3), so the sums cancel; Poisson and
non-integer weights), and prints, a JSON line each,
the largest |kernel - plain| over the bar atol + rtol |plain| (rtol 3e-5,
atol 1e-3, the reference's kernel tolerance) and the largest distance of
each from the float64 sum. A value above 1 fails the bar.

It imports neither the JAX package nor a card, and runs in a few
minutes.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CHUNKS = (32768, 8192, 2048)
# (Q, k, s, d, R, NaN coordinates on valid slots)
CASES = ((17, 17, 32_768, 3, 2, True), (20, 17, 40_000, 16, 2, True),
         (36, 1, 40_000, 1, 7, False))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.bootstrap import bootstrap_moments_plain
    from repro_torch.kernels.stratified_estimate import samples_inside
    for Q, k, s, d, R, nan in CASES:
        rng = np.random.default_rng(Q * 37 + k * 11 + s + d)
        c, a, valid, q_lo, q_hi = cs.chunk_case(rng, Q, k, s, d, nan=nan,
                                                chunk=32768)
        W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
        W[:, :, ::3] = rng.uniform(0, 2.5, W[:, :, ::3].shape)
        t = [torch.from_numpy(x) for x in (c, a, valid, W, q_lo, q_hi)]
        plain = bootstrap_moments_plain(*t).numpy()
        inside = samples_inside(t[0], t[2], t[4], t[5]).numpy()
        p = np.where(inside[None], W[:, None], 0).astype(np.float32)
        pa = (p * a[None, None]).astype(np.float32)
        terms = (p, pa, (pa * a[None, None]).astype(np.float32))
        exact = np.stack([x.astype(np.float64).sum(-1) for x in terms], -1)
        bar = 1e-3 + 3e-5 * np.abs(plain)
        for chunk in CHUNKS:
            out = None
            for s0 in range(0, s, chunk):
                acc = np.zeros(p.shape[:3] + (3,), np.float32)
                for j in range(s0, min(s, s0 + chunk)):
                    for m in range(3):
                        acc[..., m] = acc[..., m] + terms[m][..., j]
                out = acc if out is None else (out + acc).astype(np.float32)
            print(json.dumps({
                "case": {"Q": Q, "k": k, "s": s, "d": d, "R": R},
                "chunk": chunk,
                "max_err_over_bar": float((np.abs(out - plain) / bar).max()),
                "kernel_vs_f64": float(np.abs(out - exact).max()),
                "plain_vs_f64": float(np.abs(plain - exact).max())}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
