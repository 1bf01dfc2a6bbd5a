"""PASS approximate query processing on PyTorch and CUDA.

The PyTorch port of ``repro`` (the JAX package, which stays the reference):
the synopsis build is host numpy exactly as there, and serving runs on a
CUDA device through hand-written kernels (``kernels/csrc``). Every entry
point runs on the card unless the caller passes ``device="cpu"``; CPU
tensors take each kernel's plain PyTorch version.

    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.core.query import random_queries

    syn, _ = build_synopsis(c, a, k=1024, sample_rate=0.01)
    eng = PassEngine(syn, ServingConfig(kinds=("sum", "avg")), ci=0.95)
    res = eng.answer(random_queries(c, 2048, seed=3))
"""
