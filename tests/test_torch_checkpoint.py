"""The port's checkpoint/restore (``repro_torch.serve.checkpoint``), on the
CPU: synopsis and streaming round trips serve bit for bit, a restored
ingestor goes on ingesting as the original does, the quarantine counter
survives, the version guard and the config override hold, and a file the
JAX package's ``save_engine`` wrote restores into the port (and one the
port wrote into the JAX package). A join stream (parked overflow rows and
all) round-trips the same way, in the port and across the packages, and
so does a catalog source (its draw counter and degraded partitions).

A restored reference file serves within ``tests/test_torch_engine.py``'s
tolerances of the JAX engine; on integer values the restored ingestor's
state after further batches is exact against the JAX ingestor's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import (PassEngine as JEngine, ServingConfig as JServing,
                       CIConfig as JCI)
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro.streaming import StreamingIngestor as JIngestor
from repro_torch.api import PassEngine, ServingConfig, CIConfig
from repro_torch.core.types import QueryBatch
from repro_torch.serve import CHECKPOINT_VERSION
from repro_torch.streaming import StreamingIngestor
from repro_torch.streaming.ingest import STATE_FIELDS
from test_torch_engine import assert_results_close, carry, carry_queries

KINDS = ("sum", "count", "avg", "min", "max")
FIELDS = ("estimate", "ci_half", "lower", "upper", "frac_rows_touched",
          "ci_lo", "ci_hi")


def _make(seed=0, n=8000, k=16):
    rng = np.random.default_rng(seed)
    c = np.sort(rng.uniform(0, 100, n))
    a = np.floor(rng.uniform(0, 500, n))
    jsyn, _ = jbuild(c, a, k=k, sample_rate=0.02, method="eq", seed=seed)
    jq = jquery.random_queries(c, 12, seed=seed + 1, min_frac=0.02,
                               max_frac=0.5)
    return jsyn, jq


def _batch(rng, n=300):
    return rng.uniform(0, 100, n), np.floor(rng.uniform(0, 500, n))


def assert_equal_answers(got, want):
    assert set(got) == set(want)
    for kind in want:
        for f in FIELDS:
            g, w = getattr(got[kind], f), getattr(want[kind], f)
            if g is None or w is None:
                assert g is None and w is None, (kind, f)
                continue
            assert torch.equal(g, w), (kind, f)


def assert_states_equal(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_synopsis_roundtrip_bit_identical(tmp_path):
    jsyn, jq = _make()
    q = carry_queries(jq)
    eng = PassEngine(carry(jsyn), ServingConfig(kinds=KINDS),
                     ci=CIConfig(level=0.9), device="cpu")
    want = eng.answer(q)
    meta = eng.checkpoint(tmp_path / "ck.npz")
    assert meta["source"] == "synopsis"
    assert meta["version"] == CHECKPOINT_VERSION == 1
    eng2 = PassEngine.restore(tmp_path / "ck.npz", device="cpu")
    assert eng2.serving == eng.serving and eng2.ci == eng.ci
    assert_equal_answers(eng2.answer(q), want)


def test_streaming_roundtrip_and_continued_ingest(tmp_path):
    """Restore mid-stream; both ingest the same further batches: states
    torch.equal, answers bit for bit (the threefry key round-trips)."""
    jsyn, jq = _make(seed=2)
    q = carry_queries(jq)
    rng = np.random.default_rng(3)
    ing = StreamingIngestor(carry(jsyn), seed=11,
                            quarantine_box=([0.0], [100.0]), device="cpu")
    for _ in range(3):
        ing.ingest(*_batch(rng))
    eng = PassEngine(ing, ServingConfig(kinds=("sum", "avg", "max")),
                     device="cpu")
    want = eng.answer(q)
    eng.checkpoint(tmp_path / "ck.npz")
    eng2 = PassEngine.restore(tmp_path / "ck.npz", device="cpu")
    src2 = eng2.source
    assert isinstance(src2, StreamingIngestor)
    assert (src2.epoch, src2.n_stream) == (ing.epoch, ing.n_stream)
    assert_states_equal(src2.state, ing.state)
    assert_equal_answers(eng2.answer(q), want)
    for _ in range(3):
        batch = _batch(rng)
        ing.ingest(*batch)
        src2.ingest(*batch)
    assert_states_equal(src2.state, ing.state)
    assert torch.equal(src2._key, ing._key)
    assert_equal_answers(eng2.answer(q), eng.answer(q))


def test_quarantine_counter_survives(tmp_path):
    jsyn, _ = _make(seed=5)
    ing = StreamingIngestor(carry(jsyn), quarantine_box=([0.0], [100.0]),
                            device="cpu")
    ing.ingest(np.asarray([5.0, np.nan, 400.0, 7.0]), np.ones(4))
    assert ing.n_quarantined == 2
    PassEngine(ing, device="cpu").checkpoint(tmp_path / "ck.npz")
    eng2 = PassEngine.restore(tmp_path / "ck.npz", device="cpu")
    assert eng2.source.n_quarantined == 2
    assert eng2.source.total_rows == ing.total_rows
    assert eng2.stats()["faults"]["quarantined_rows"] == 2
    assert torch.equal(eng2.source._qlo, ing._qlo)


def test_version_guard_and_unported_sources(tmp_path):
    jsyn, _ = _make()
    path = tmp_path / "ck.npz"
    PassEngine(carry(jsyn), device="cpu").checkpoint(path)
    with np.load(path) as npz:
        arrays = {k: npz[k] for k in npz.files}
    meta = json.loads(str(arrays["__meta__"][()]))
    for version, kind, error, match in (
            (2, "synopsis", ValueError, "version 2 is not supported"),
            (1, "catalog", KeyError, "num_partitions"),
            (1, "join_streaming", KeyError, "jsyn"),
            (1, "sharded", KeyError, "n_shards"),
            (1, "zebra", ValueError, "unknown checkpoint source")):
        arrays["__meta__"] = np.asarray(json.dumps(
            dict(meta, version=version, source=kind)))
        np.savez(tmp_path / "bad.npz", **arrays)
        with pytest.raises(error, match=match):
            PassEngine.restore(tmp_path / "bad.npz", device="cpu")


def test_config_override(tmp_path):
    jsyn, jq = _make(seed=4)
    q = carry_queries(jq)
    PassEngine(carry(jsyn), ServingConfig(kinds=("sum",)), ci=0.95,
               device="cpu").checkpoint(tmp_path / "ck.npz")
    sv = ServingConfig(kinds=("count", "min"))
    eng = PassEngine.restore(tmp_path / "ck.npz", serving=sv,
                             ci=CIConfig(level=0.8), device="cpu")
    assert eng.serving == sv and eng.ci == CIConfig(level=0.8)
    assert_equal_answers(eng.answer(q),
                         PassEngine(carry(jsyn), sv, ci=0.8,
                                    device="cpu").answer(q))


def test_reference_written_synopsis_restores_into_port(tmp_path):
    """JAX save_engine -> port restore: the answers are the JAX engine's
    within the engine tolerances, configs included; and the other way
    round, a port file restores into the JAX package."""
    jsyn, jq = _make(seed=6)
    jeng = JEngine(jsyn, JServing(kinds=KINDS), ci=JCI(level=0.95))
    jeng.checkpoint(tmp_path / "ref.npz")
    eng = PassEngine.restore(tmp_path / "ref.npz", device="cpu")
    assert eng.serving == ServingConfig(kinds=KINDS)
    assert eng.ci == CIConfig(level=0.95)
    assert_results_close(jeng.answer(jq), eng.answer(carry_queries(jq)),
                         KINDS)
    eng.checkpoint(tmp_path / "port.npz")
    jeng2 = JEngine.restore(tmp_path / "port.npz")
    assert_results_close(jeng2.answer(jq), eng.answer(carry_queries(jq)),
                         KINDS)


def test_reference_written_stream_restores_and_ingests(tmp_path):
    """A JAX streaming checkpoint (raw uint32 key, quarantine box) restores
    into the port; both ingest the same batches afterwards and the states
    are exact on integer values."""
    jsyn, jq = _make(seed=7)
    rng = np.random.default_rng(8)
    jing = JIngestor(jsyn, seed=13, quarantine_box=([0.0], [100.0]))
    jing.ingest(*_batch(rng))
    jing.ingest(np.asarray([1.0, np.nan, 300.0]), np.ones(3))
    JEngine(jing, JServing(kinds=("sum", "count"))).checkpoint(
        tmp_path / "ref.npz")
    eng = PassEngine.restore(tmp_path / "ref.npz", device="cpu")
    ing = eng.source
    assert (ing.epoch, ing.n_stream, ing.n_quarantined) == (2, 303, 2)
    for _ in range(2):
        batch = _batch(rng)
        jing.ingest(*batch)
        ing.ingest(*batch)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ing.state, f).numpy(),
                                      np.asarray(getattr(jing.state, f)),
                                      err_msg=f)
    assert_results_close(
        JEngine(jing, JServing(kinds=("sum", "count"))).answer(jq),
        eng.answer(carry_queries(jq)), ("sum", "count"))


def _join_stream(seed=0):
    """A port join ingestor built at a capacity that overflows, and its
    remaining stream batches (integer values)."""
    from repro_torch.joins import build_dim_table, build_join_synopsis
    from repro_torch.streaming.join_ingest import JoinStreamingIngestor
    rng = np.random.default_rng(seed)
    n, nd = 2400, 40
    c = rng.normal(size=n).astype(np.float32)
    a = np.floor(rng.uniform(0, 50, n)).astype(np.float32)
    keys = rng.integers(0, nd + 4, n).astype(np.int32)
    dim = build_dim_table(np.arange(nd), rng.normal(size=nd),
                          num_partitions=4, device="cpu")
    jsyn, _ = build_join_synopsis(c[:800], a[:800], keys[:800], dim, k=6,
                                  p_u=0.4, seed=1, device="cpu")
    ing = JoinStreamingIngestor(jsyn, seed=7, quarantine_box=([-3.0], [3.0]),
                                device="cpu")
    return ing, [(c[s:s + 400], a[s:s + 400], keys[s:s + 400])
                 for s in range(800, n, 400)]


def test_join_streaming_roundtrip_and_continued_ingest(tmp_path):
    """A join stream restored mid-stream (parked overflow rows, key,
    regrow count, quarantine box and all): its states torch.equal to the
    original's, its join answers bit for bit, and the same further batches
    keep them so."""
    from repro_torch.streaming.join_ingest import (JoinStreamingIngestor,
                                                   JSTATE_FIELDS)
    ing, batches = _join_stream()
    ing.ingest(*batches[0])
    assert ing._pending                 # the build's buffers are full
    eng = PassEngine(ing, ServingConfig(kinds=("sum", "avg")), ci=0.95,
                     device="cpu")
    q = QueryBatch(torch.tensor([[-1.0, -0.5], [0.0, -2.0]]),
                   torch.tensor([[0.5, 2.0], [2.0, 1.0]]))
    want = eng.answer_join(q)
    meta = eng.checkpoint(tmp_path / "jk.npz")
    assert meta["source"] == "join_streaming" and meta["has_pending"]
    eng2 = PassEngine.restore(tmp_path / "jk.npz", device="cpu")
    src2 = eng2.source
    assert isinstance(src2, JoinStreamingIngestor)
    assert (src2.epoch, src2.n_stream, src2.n_regrown) == (
        ing.epoch, ing.n_stream, ing.n_regrown)
    assert torch.equal(src2._join_base.key_root, ing._join_base.key_root)
    assert_equal_answers(eng2.answer_join(q), want)
    for b in batches[1:]:
        ing.ingest(*b)
        src2.ingest(*b)
    assert src2.n_regrown == ing.n_regrown > 0
    assert_states_equal(src2.state, ing.state)
    for f in JSTATE_FIELDS:
        assert torch.equal(getattr(src2.jstate, f), getattr(ing.jstate, f)), f
    assert torch.equal(src2._key, ing._key)
    assert_equal_answers(eng2.answer_join(q), eng.answer_join(q))


def test_join_stream_checkpoints_cross_packages(tmp_path):
    """A JAX join-stream checkpoint restores into the port with its exact
    states (raw uint32 key_root included), and a port file into the JAX
    package."""
    from repro.joins import build_dim_table as jdim
    from repro.joins import build_join_synopsis as jjbuild
    from repro.streaming import JoinStreamingIngestor as JJIngestor
    from repro_torch.streaming.join_ingest import JSTATE_FIELDS
    rng = np.random.default_rng(4)
    n, nd = 1600, 30
    c = rng.normal(size=n).astype(np.float32)
    a = np.floor(rng.uniform(0, 50, n)).astype(np.float32)
    keys = rng.integers(0, nd + 3, n).astype(np.int32)
    jsyn, _ = jjbuild(c[:800], a[:800], keys[:800],
                      jdim(np.arange(nd), rng.normal(size=nd),
                           num_partitions=4), k=6, p_u=0.4, seed=2)
    jing = JJIngestor(jsyn, seed=3)
    jing.ingest(c[800:1200], a[800:1200], keys=keys[800:1200])
    JEngine(jing).checkpoint(tmp_path / "ref.npz")
    ing = PassEngine.restore(tmp_path / "ref.npz", device="cpu").source
    for f in JSTATE_FIELDS:
        np.testing.assert_array_equal(getattr(ing.jstate, f).numpy(),
                                      np.asarray(getattr(jing.jstate, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(
        ing._join_base.key_root.numpy().astype(np.uint32),
        np.asarray(jing._join_base.key_root))
    ing.ingest(c[1200:], a[1200:], keys=keys[1200:])
    jing.ingest(c[1200:], a[1200:], keys=keys[1200:])
    for f in JSTATE_FIELDS:
        np.testing.assert_array_equal(getattr(ing.jstate, f).numpy(),
                                      np.asarray(getattr(jing.jstate, f)),
                                      err_msg=f)
    PassEngine(ing, device="cpu").checkpoint(tmp_path / "port.npz")
    back = JEngine.restore(tmp_path / "port.npz").source
    for f in JSTATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back.jstate, f)),
                                      np.asarray(getattr(jing.jstate, f)),
                                      err_msg=f)


# -- catalog sources ---------------------------------------------------------
def _catalog_source(data_seed, n, parts, **cfg):
    from repro_torch.api import CatalogConfig
    from repro_torch.partitions import CatalogSource, partition_rows
    rng = np.random.default_rng(data_seed)
    c = np.sort(rng.uniform(0, 100, n))
    a = np.floor(rng.uniform(0, 500, n))
    return c, a, CatalogSource(partition_rows(c, a, parts),
                               CatalogConfig(**cfg), device="cpu")


def test_catalog_roundtrip(tmp_path):
    """The restored source has the same draw counter, so its next
    selection and answers are the original's, bit for bit; the same file
    restores into the JAX package, whose answers agree within the engine
    tolerances."""
    c, a, src = _catalog_source(6, 6000, 8, k=4, s_per_leaf=16,
                                max_partitions=3, seed=9)
    _, jq = _make(seed=7)
    q = carry_queries(jq)
    sv = ServingConfig(kinds=("sum", "count"))
    eng = PassEngine(src, serving=sv, device="cpu")
    eng.answer(q)               # advances the selection draw counter
    eng.answer(q)
    meta = eng.checkpoint(tmp_path / "ck.npz")
    assert meta["source"] == "catalog" and meta["draws"] == 2
    eng2 = PassEngine.restore(tmp_path / "ck.npz", device="cpu")
    src2 = eng2.source
    assert src2.store.num_partitions == 8 and src2._draws == src._draws
    assert src2.config == src.config and eng2.serving == sv
    want = eng.answer(q)
    assert_equal_answers(eng2.answer(q), want)
    assert set(src2.stats()["materialized_ids"]) <= \
        set(src.stats()["materialized_ids"])
    jeng = JEngine.restore(tmp_path / "ck.npz")
    assert_results_close(jeng.answer(jq), want, ("sum", "count"))


def test_catalog_degraded_set_survives(tmp_path):
    _, _, src = _catalog_source(8, 4000, 6, k=4, s_per_leaf=8,
                                max_partitions=2)
    src._degraded = {3}
    PassEngine(src, device="cpu").checkpoint(tmp_path / "ck.npz")
    eng2 = PassEngine.restore(tmp_path / "ck.npz", device="cpu")
    assert eng2.source.degraded_partitions == {3}
    assert eng2.stats()["faults"]["degraded_partitions"] == [3]


def test_reference_written_catalog_restores_into_port(tmp_path):
    """A catalog checkpoint the JAX package wrote mid-draws restores into
    the port: the same next selection, answers within the engine
    tolerances."""
    from repro.api import CatalogConfig as JCatalog
    from repro.partitions import CatalogSource as JSource
    from repro.partitions import partition_rows as jrows
    rng = np.random.default_rng(12)
    c = np.sort(rng.uniform(0, 100, 5000))
    a = np.floor(rng.uniform(0, 500, 5000))
    jsrc = JSource(jrows(c, a, 10), JCatalog(k=4, s_per_leaf=16,
                                             max_partitions=4, seed=5))
    _, jq = _make(seed=13)
    jeng = JEngine(jsrc, serving=JServing(kinds=("sum", "count", "avg")),
                   ci=JCI(level=0.9))
    jeng.answer(jq)
    jeng.checkpoint(tmp_path / "ref.npz")
    eng = PassEngine.restore(tmp_path / "ref.npz", device="cpu")
    assert eng.source._draws == 1 and eng.ci == CIConfig(level=0.9)
    assert_results_close(jeng.answer(jq), eng.answer(carry_queries(jq)),
                         ("sum", "count", "avg"))
    assert set(eng.stats()["catalog"]["materialized_ids"]) <= \
        set(jeng.stats()["catalog"]["materialized_ids"])
