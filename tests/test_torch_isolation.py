"""The port stands alone: importing every module of ``repro_torch`` (the
streaming modules, the threefry port, the bootstrap, the planner, the
weighted kernels' wrappers, the partition tier, the sharded layer and the
distributed helpers, the baselines, the legacy update path and the
deprecated shims included) pulls in neither JAX nor the JAX package,
neither ``chip_smoke.py`` nor the ``examples/torch_*.py`` scripts import
either, and the entry points default to the CUDA card rather than the
CPU."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _top_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == [], report["bad"]
    for mod in ("repro_torch.api.engine", "repro_torch.kernels.ops",
                "repro_torch.core.synopsis", "repro_torch.data.synthetic",
                "repro_torch.uncertainty.intervals", "repro_torch.random",
                "repro_torch.kernels.segment_reduce",
                "repro_torch.kernels.route", "repro_torch.streaming",
                "repro_torch.streaming.ingest", "repro_torch.streaming.delta",
                "repro_torch.streaming.policy",
                "repro_torch.uncertainty.bootstrap",
                "repro_torch.engine.planner", "repro_torch.kernels.bootstrap",
                "repro_torch.kernels.stratified_estimate",
                "repro_torch.partitions", "repro_torch.partitions.catalog",
                "repro_torch.partitions.source", "repro_torch.sharded",
                "repro_torch.sharded.mesh", "repro_torch.sharded.ingest",
                "repro_torch.sharded.build", "repro_torch.sharded.merge",
                "repro_torch.sharded.reopt", "repro_torch.sharded.catalog",
                "repro_torch.core.distributed", "repro_torch.core.baselines",
                "repro_torch.core.updates", "repro_torch.core.estimators",
                "repro_torch.api.deprecation", "repro_torch.kernels.ref",
                "repro_torch.data.loader", "repro_torch.kernels.threefry",
                "repro_torch.kernels.join_epilogue"):
        assert mod in report["imported"]


def test_chip_smoke_imports_neither_jax_nor_reference_package():
    imports = _top_imports(REPO / "chip_smoke.py")
    assert "repro_torch" in imports
    assert not imports & {"jax", "jaxlib", "repro"}, imports
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        assert not _top_imports(path) & {"jax", "jaxlib", "repro"}, path


_EXAMPLE_PROBE = r"""
import importlib.util, json, pathlib, sys
names = []
for path in sorted(pathlib.Path("examples").glob("torch_*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path.stem)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_torch_examples_import_neither_jax_nor_reference_package():
    paths = sorted((REPO / "examples").glob("torch_*.py"))
    assert [p.stem for p in paths] == [
        "torch_aqp_service", "torch_quickstart", "torch_serve_service",
        "torch_workload_shift"]
    for path in paths:
        imports = _top_imports(path)
        assert "repro_torch" in imports, path
        assert not imports & {"jax", "jaxlib", "repro"}, path
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _EXAMPLE_PROBE], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(report["imported"]) == 4 and report["bad"] == [], report


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.api import PassEngine
    from repro_torch.core.query import random_queries
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.device import resolve_device
    from repro_torch.partitions import build_catalog, partition_stats
    from repro_torch.random import PRNGKey
    from repro_torch.sharded import (ShardedIngestor, build_synopsis_sharded,
                                     catalog_delta_sharded, data_mesh)
    from repro_torch.streaming import StreamingIngestor
    from repro_torch.core.baselines import aqppp_synopsis, uniform_synopsis
    from repro_torch.core.query import answer
    from repro_torch.core.types import QueryBatch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = np.linspace(0, 1, 200)
    a = np.ones(200)
    syn, _ = build_synopsis(c, a, k=4, device="cpu")
    for call in (lambda: resolve_device(None),
                 lambda: build_synopsis(c, a, k=4),
                 lambda: random_queries(c, 3),
                 lambda: PassEngine(None),
                 lambda: StreamingIngestor(syn),
                 lambda: PRNGKey(0),
                 lambda: PassEngine.from_catalog([(c, a)]),
                 lambda: build_catalog([(c, a)]),
                 lambda: partition_stats(c, a, np.zeros(200, np.int32), 1,
                                         bins=4, bin_lo=[0.0],
                                         bin_hi=[1.0]),
                 lambda: data_mesh(),
                 lambda: ShardedIngestor(syn),
                 lambda: build_synopsis_sharded(c, a, k=4),
                 lambda: PassEngine.from_sharded(c, a, k=4),
                 lambda: catalog_delta_sharded(c, a, np.zeros(200), 1,
                                               bins=4, bin_lo=[0.0],
                                               bin_hi=[1.0]),
                 lambda: aqppp_synopsis(c, a, 4, 20),
                 lambda: uniform_synopsis(c, a, 20),
                 lambda: answer(syn, QueryBatch(torch.zeros(1, 1),
                                                torch.ones(1, 1)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert syn.device.type == "cpu"
    ing = StreamingIngestor(syn, device="cpu").ingest(c[:5], a[:5])
    assert ing.state.seen.device.type == "cpu" and ing.epoch == 1
    sh = ShardedIngestor(syn, device="cpu").ingest(c[:5], a[:5])
    assert sh.state.seen.shape == (1, 4) and sh.mesh == data_mesh(
        1, device="cpu")
    assert resolve_device("cpu") == torch.device("cpu")
