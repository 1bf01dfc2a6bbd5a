"""The four ``examples/torch_*.py`` scripts run end to end on the CPU at a
tiny scale (``--device cpu``), through the ``main()`` a user runs, and
their summaries hold what each example shows. On the card they run at their
own scales in ``chip_smoke.py``."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart():
    out = _load("torch_quickstart").main(
        ["--device", "cpu", "--scale", "0.003", "--k", "16",
         "--queries", "64"])
    assert out["device"] == "cpu"
    assert set(out["median_rel_err"]) == {"sum", "count", "avg", "min",
                                          "max"}
    assert all(v == 1.0 for v in out["containment"].values())
    assert out["stats"]["hits"] == 1 and out["stats"]["aot_compiles"] == 0


@pytest.mark.parametrize("distributed", [False, True])
def test_aqp_service(distributed):
    argv = ["--device", "cpu", "--scale", "0.003", "--k", "16",
            "--batches", "2", "--batch-size", "32"]
    out = _load("torch_aqp_service").main(
        argv + (["--distributed", "--shards", "3"] if distributed else []))
    assert set(out["median_rel_err"]) == ({"sum"} if distributed
                                          else {"sum", "count", "avg"})
    assert out["median_rel_err"]["sum"] < 0.5
    assert 0.0 < out["mean_skip_rate"] < 1.0 and out["mean_ess"] > 0


def test_serve_service(tmp_path):
    out = _load("torch_serve_service").main(
        ["--device", "cpu", "--scale", "0.003", "--k", "16", "--tenants",
         "3", "--seconds", "0.4", "--ci", "0.95", "--out", str(tmp_path)])
    assert (tmp_path / "stats.json").exists()
    co = out["coalescer"]
    assert co["served"] > 0 and co["dispatches"] > 0
    assert sum(t["served_requests"] for t in out["tenant_clients"].values()) \
        == co["served"]


def test_workload_shift():
    out = _load("torch_workload_shift").main(
        ["--device", "cpu", "--scale", "0.002", "--k", "16",
         "--queries", "32"])
    assert set(out["templates"]) == {1, 2, 3, 4}
    stream = out["stream"]
    # drift-touching queries: the re-optimized stream beats the frozen base
    assert stream["re-optimized (dp_monotone_device)"][1] \
        < stream["frozen base (stale)"][1]
