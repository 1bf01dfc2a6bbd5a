"""The port's public serving surface against the JAX package's snapshot.

``tests/test_api_surface.py`` pins ``repro.api.__all__`` and the
PassEngine / config / coalescer signatures in ``tests/data/api_surface.json``.
This test builds the same keys from ``repro_torch`` and compares them
with that file, read only, under the mapping ``repro.`` -> ``repro_torch.``.
Every difference the port is allowed is listed below with its reason; any
other drift fails. Nothing here writes a file.
"""
import dataclasses
import inspect
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as api
import repro_torch.serve as serve

SNAPSHOT = pathlib.Path(__file__).parent / "data" / "api_surface.json"

DEVICE = ("device=None: the port's entry points serve on the CUDA card "
          "unless the caller names another device")
# (signature key, reference text, port text, reason): each edit turns the
# snapshot's signature into the port's.
ALLOWED = [
    ("PassEngine.__init__", "plan_cache_size: 'int' = 32)",
     "plan_cache_size: 'int' = 32, device=None)", DEVICE),
    ("PassEngine.from_catalog", "plan_cache_size: 'int' = 32, **build_kw",
     "plan_cache_size: 'int' = 32, device=None, **build_kw", DEVICE),
    ("PassEngine.from_sharded", "plan_cache_size: 'int' = 32, **build_kw",
     "plan_cache_size: 'int' = 32, device=None, **build_kw", DEVICE),
]
# (name-list key, added name, reason).
ALLOWED_NAMES = [
    ("repro_torch.api.__all__", "merge_overrides",
     "merge_overrides is public in the port: the deprecated shims and the "
     "tests build configs with it, where the reference imports it from "
     "repro.api.config"),
]


def _sig(obj) -> str:
    return str(inspect.signature(obj))


def _config_fields(cls) -> dict:
    return {f.name: repr(f.default) if f.default is not dataclasses.MISSING
            else "<required>" for f in dataclasses.fields(cls)}


def current_surface() -> dict:
    """``tests/test_api_surface.py:current_surface`` over ``repro_torch``."""
    return {
        "repro_torch.api.__all__": sorted(api.__all__),
        "PassEngine.__init__": _sig(api.PassEngine.__init__),
        "PassEngine.answer": _sig(api.PassEngine.answer),
        "PassEngine.answer_join": _sig(api.PassEngine.answer_join),
        "PassEngine.from_catalog": _sig(api.PassEngine.from_catalog),
        "PassEngine.from_sharded": _sig(api.PassEngine.from_sharded),
        "PassEngine.prepare": _sig(api.PassEngine.prepare),
        "PassEngine.prepare_join": _sig(api.PassEngine.prepare_join),
        "PassEngine.stats": _sig(api.PassEngine.stats),
        "PassEngine.replace_source": _sig(api.PassEngine.replace_source),
        "PreparedQuery.__call__": _sig(api.PreparedQuery.__call__),
        "ServingConfig": _config_fields(api.ServingConfig),
        "CIConfig": _config_fields(api.CIConfig),
        "CatalogConfig": _config_fields(api.CatalogConfig),
        "CoalescerConfig": _config_fields(api.CoalescerConfig),
        "repro_torch.serve.__all__": sorted(serve.__all__),
        "RequestCoalescer.__init__": _sig(serve.RequestCoalescer.__init__),
        "RequestCoalescer.submit": _sig(serve.RequestCoalescer.submit),
        "RequestCoalescer.answer": _sig(serve.RequestCoalescer.answer),
        "RequestCoalescer.tick": _sig(serve.RequestCoalescer.tick),
        "RequestCoalescer.stats": _sig(serve.RequestCoalescer.stats),
        "TickDriver.__init__": _sig(serve.TickDriver.__init__),
    }


def expected_surface() -> dict:
    """The reference snapshot, renamed to the port and with each allowed
    difference applied (each must apply exactly once)."""
    want = {k.replace("repro.", "repro_torch."): v
            for k, v in json.loads(SNAPSHOT.read_text()).items()}
    for key, ref_text, port_text, _reason in ALLOWED:
        assert want[key].count(ref_text) == 1, key
        want[key] = want[key].replace(ref_text, port_text)
    for key, name, _reason in ALLOWED_NAMES:
        assert name not in want[key], key
        want[key] = sorted(want[key] + [name])
    return want


def test_api_surface_matches_reference_snapshot():
    surface = current_surface()
    want = expected_surface()
    assert set(surface) == set(want)
    drift = {k: (surface[k], want[k]) for k in want if surface[k] != want[k]}
    assert not drift, drift


def test_allowed_differences_are_justified_and_needed():
    """Each listed difference has a reason and is a real difference: the
    port's entry differs from the reference's and equals it with the edit
    applied."""
    ref = {k.replace("repro.", "repro_torch."): v
           for k, v in json.loads(SNAPSHOT.read_text()).items()}
    surface = current_surface()
    for key, *_edit, reason in ALLOWED + ALLOWED_NAMES:
        assert reason and len(reason) > 20, key
        assert surface[key] != ref[key], key


def test_stats_keys_match_the_reference_engine():
    """``stats()`` carries the reference's keys, ``aot_compiles``
    included: the port has no ahead-of-time compile step, so it stays 0."""
    from repro.api import PassEngine as JEngine
    from repro.core.synopsis import build_synopsis as jbuild
    from repro_torch.core.synopsis import build_synopsis
    rng = np.random.default_rng(0)
    c = np.sort(rng.uniform(0, 1, 2000))
    a = rng.uniform(0, 1, 2000)
    jsyn, _ = jbuild(c, a, k=4, sample_rate=0.05)
    tsyn, _ = build_synopsis(c, a, k=4, sample_rate=0.05, device="cpu")
    jstats = JEngine(jsyn).stats()
    tstats = api.PassEngine(tsyn, device="cpu").stats()
    assert set(tstats) == set(jstats)
    assert tstats["aot_compiles"] == 0
