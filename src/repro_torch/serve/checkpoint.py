"""Epoch-consistent checkpoint/restore for ``PassEngine`` (DESIGN.md §15);
the port of ``repro/serve/checkpoint.py``.

One ``.npz`` file holds the complete serving state at an epoch boundary:
every tensor of the source (the synopsis, or a streaming ingestor's base,
reservoir, delta aggregates, quarantine box and counter, or a sharded
ingestor's per-shard state) plus a
``__meta__`` JSON record (format version, source type, epoch counters,
serving/ci configs). ``load_engine`` rebuilds the source and returns a
fresh engine whose serving path is bit-identical to the checkpointed one:
the arrays are restored verbatim, so the same kernels compute over the
same values, and a restored ingestor goes on ingesting as the original
would (its threefry key round-trips).

The layout, the array names and ``CHECKPOINT_VERSION`` are the JAX
package's, so a file that package wrote restores into the port. PRNG keys
are raw ``uint32[2]`` words: written under ``<name>``, and read from
``<name>`` or from ``<name>@key`` (the reference's typed-key layout,
``jax.random.key_data``). A file records ``backend``; the port picks each
kernel by the device of its tensors, so it writes None and ignores the
recorded one, in the ingestor and in the serving config.

A join streaming source (``JoinStreamingIngestor``) writes its join
synopsis (base, dimension table, universe buffers, cells), both stream
states, its key, its regrow count and any parked overflow rows; the
universe's ``key_root`` is written as raw ``uint32[2]`` words as the
reference writes its raw key.

A sharded source (``sharded.ShardedIngestor``) writes its shard count,
its base, its stacked ``(D, ...)`` state, its key, its streamed-row count,
its containment counters, its quarantine box (always: +-inf means the
non-finite checks only) and, during a build, its static route skeleton.
It restores onto a mesh of the same shard count only (the per-shard state
is not resharded), by default ``data_mesh(D)`` on the engine's device.

A catalog source (``partitions.CatalogSource``) writes its partitions'
rows, its config, its selection-draw counter, its degraded partitions and
its flat ``build_kw``; the restored source draws the same selections next
and rebuilds the same partition synopses from their seeds.

Checkpoints are taken at epoch boundaries only: ``save_engine`` flushes an
attached request coalescer first so no admitted query straddles the
snapshot, and every ``ingest()`` swaps its state once per batch.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..core.types import PartitionTree, Synopsis
from ..device import resolve_device, to_numpy

CHECKPOINT_VERSION = 1

# -- PRNG key round-trip ---------------------------------------------------
def _put_key(arrays: dict, name: str, key) -> None:
    arrays[name] = to_numpy(key).astype(np.uint32).reshape(2)


def _get_key(arrays, name: str) -> np.ndarray:
    raw = arrays[name + "@key"] if name + "@key" in arrays else arrays[name]
    return np.asarray(raw).astype(np.uint32).reshape(2)


# -- generic dataclass walker ----------------------------------------------
# Synopsis, PartitionTree and StreamState are flat records of tensors plus
# int meta fields and at most dataclass-valued children; a field-name walk
# saves and loads them without a per-type schema.
def _put_dc(arrays: dict, prefix: str, obj) -> dict:
    """Store ``obj``'s tensor fields under ``prefix/<field>``; return the
    JSON-safe meta dict (scalars, None markers, nested field metas)."""
    meta = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}/{f.name}"
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            meta[f.name] = _put_dc(arrays, key, v)
        elif v is None:
            meta[f.name] = None
        elif isinstance(v, (bool, int, float, str)):
            meta[f.name] = v
        else:
            arrays[key] = to_numpy(v)
    return meta


def _get_dc(cls, arrays, prefix: str, meta: dict, device,
            nested: dict | None = None):
    """Inverse of :func:`_put_dc`, tensors on ``device`` with the file's
    dtypes; ``nested`` maps field name -> class of dataclass children."""
    nested = nested or {}
    kw = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}/{f.name}"
        if f.name in nested and isinstance(meta.get(f.name), dict):
            kw[f.name] = _get_dc(nested[f.name], arrays, key, meta[f.name],
                                 device, nested)
        elif key in arrays:
            kw[f.name] = torch.tensor(np.asarray(arrays[key]), device=device)
        elif f.name in meta:
            kw[f.name] = meta[f.name]
        elif f.default is not dataclasses.MISSING:
            kw[f.name] = f.default
        else:
            raise KeyError(
                f"checkpoint missing field {key!r} for {cls.__name__}")
    return cls(**kw)


def _load_synopsis(arrays, prefix: str, meta: dict, device) -> Synopsis:
    return _get_dc(Synopsis, arrays, prefix, meta, device,
                   nested={"tree": PartitionTree})


# -- config round-trip -----------------------------------------------------
def _config_meta(cfg) -> dict | None:
    if cfg is None:
        return None
    d = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "key" and not (v is None or isinstance(v, int)):
            # A materialized key array is not JSON; the restored engine
            # re-derives intervals from the seedless default.
            v = None
        if isinstance(v, tuple):
            v = list(v)
        d[f.name] = v
    return d


def _config_from_meta(cls, d: dict | None):
    if d is None:
        return None
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}
    if "backend" in kw:
        kw["backend"] = None     # the port picks kernels by tensor device
    return cls(**kw)


def _put_qbox(arrays: dict, meta: dict, qlo, qhi) -> None:
    if qlo is not None:
        arrays["qbox/lo"] = to_numpy(qlo)
        arrays["qbox/hi"] = to_numpy(qhi)
        meta["has_qbox"] = True


def _get_qbox(arrays, meta: dict):
    if meta.get("has_qbox"):
        return (np.asarray(arrays["qbox/lo"]), np.asarray(arrays["qbox/hi"]))
    return None


# -- save ------------------------------------------------------------------
def save_engine(engine, path) -> dict:
    """Snapshot ``engine``'s serving state into one ``.npz`` at ``path``.

    Flushes the attached coalescer (if any) so the snapshot lands on an
    epoch boundary with no queued request, then dispatches on the source
    type. Returns the metadata dict embedded in the file.
    """
    from ..sharded.ingest import ShardedIngestor
    from ..streaming.ingest import StreamingIngestor
    from ..streaming.join_ingest import JoinStreamingIngestor

    if engine._coalescer is not None:
        engine._coalescer.flush()

    src = engine._source
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {
        "version": CHECKPOINT_VERSION,
        "epoch": int(getattr(src, "epoch", 0)),
        "serving": _config_meta(engine.serving),
        "ci": _config_meta(engine.ci),
    }
    if isinstance(src, JoinStreamingIngestor):
        meta["source"] = "join_streaming"
        meta["backend"] = None
        meta["jsyn"] = _put_dc(arrays, "jsyn", src._join_base)
        _put_key(arrays, "jsyn/key_root", src._join_base.key_root)
        meta["state"] = _put_dc(arrays, "state", src.state)
        meta["jstate"] = _put_dc(arrays, "jstate", src.jstate)
        _put_key(arrays, "ing/key", src._key)
        meta["n_stream"] = int(src.n_stream)
        meta["n_regrown"] = int(src.n_regrown)
        _put_qbox(arrays, meta, src._qlo, src._qhi)
        if src._pending:
            arrays["pending/c"] = np.concatenate(
                [p[0] for p in src._pending], axis=0)
            arrays["pending/a"] = np.concatenate(
                [p[1] for p in src._pending])
            arrays["pending/k"] = np.concatenate(
                [p[2] for p in src._pending])
            meta["has_pending"] = True
    elif isinstance(src, ShardedIngestor):
        meta["source"] = "sharded"
        meta["backend"] = None
        meta["n_shards"] = int(src.n_shards)
        meta["base"] = _put_dc(arrays, "base", src.base)
        meta["state"] = _put_dc(arrays, "state", src.state)
        _put_key(arrays, "ing/key", src._key)
        meta["n_stream"] = int(src.n_stream)
        meta["fault_stats"] = src.fault_stats()
        if src._route is not None:
            arrays["route/lo"] = to_numpy(src._route[0])
            arrays["route/hi"] = to_numpy(src._route[1])
            meta["has_route"] = True
        _put_qbox(arrays, meta, src._qlo, src._qhi)
    elif isinstance(src, StreamingIngestor):
        meta["source"] = "streaming"
        meta["backend"] = None
        meta["base"] = _put_dc(arrays, "base", src.base)
        meta["state"] = _put_dc(arrays, "state", src.state)
        _put_key(arrays, "ing/key", src._key)
        meta["n_stream"] = int(src.n_stream)
        _put_qbox(arrays, meta, src._qlo, src._qhi)
    elif getattr(src, "is_catalog_source", False):
        meta["source"] = "catalog"
        meta["config"] = _config_meta(src.config)
        meta["num_partitions"] = int(src.store.num_partitions)
        meta["draws"] = int(src._draws)
        meta["degraded"] = sorted(src.degraded_partitions)
        try:
            meta["build_kw"] = json.loads(json.dumps(src._build_kw))
        except (TypeError, ValueError):
            meta["build_kw"] = {}
        for p, (c, a) in enumerate(src.store.parts()):
            arrays[f"part/{p}/c"] = np.asarray(c)
            arrays[f"part/{p}/a"] = np.asarray(a)
    elif isinstance(src, Synopsis):
        meta["source"] = "synopsis"
        meta["syn"] = _put_dc(arrays, "syn", src)
    else:
        raise TypeError(
            f"cannot checkpoint source of type {type(src).__name__}")

    arrays["__meta__"] = np.asarray(json.dumps(meta))
    np.savez(path, **arrays)
    return meta


# -- load ------------------------------------------------------------------
def _load_stream_state(arrays, meta: dict, device):
    from ..streaming.ingest import StreamState
    state = _get_dc(StreamState, arrays, "state", meta["state"], device)
    if state.quarantined is None:           # files from before the box
        state.quarantined = torch.zeros_like(state.oob)
    return state


def _restore_source(arrays, meta: dict, device, mesh):
    from ..streaming.ingest import StreamingIngestor
    from ..streaming.join_ingest import (JoinStreamState,
                                         JoinStreamingIngestor)

    kind = meta["source"]
    if kind == "synopsis":
        return _load_synopsis(arrays, "syn", meta["syn"], device)
    if kind == "streaming":
        base = _load_synopsis(arrays, "base", meta["base"], device)
        ing = StreamingIngestor(base, key=_get_key(arrays, "ing/key"),
                                quarantine_box=_get_qbox(arrays, meta),
                                device=device)
        ing.state = _load_stream_state(arrays, meta, device)
        ing.n_stream = int(meta["n_stream"])
        ing._epoch = int(meta["epoch"])
        return ing
    if kind == "sharded":
        from ..sharded import ShardedIngestor, data_mesh, num_shards
        n_shards = int(meta["n_shards"])
        mesh = mesh if mesh is not None else data_mesh(n_shards,
                                                       device=device)
        if num_shards(mesh) != n_shards:
            raise ValueError(
                f"checkpoint was taken with {n_shards} shards but the "
                f"restore mesh has {num_shards(mesh)}; restore on a mesh "
                "of the same size (per-shard state is not resharded)")
        route = None
        if meta.get("has_route"):
            route = (np.asarray(arrays["route/lo"]),
                     np.asarray(arrays["route/hi"]))
        base = _load_synopsis(arrays, "base", meta["base"], mesh.device)
        ing = ShardedIngestor(base, mesh=mesh, key=_get_key(arrays,
                                                            "ing/key"),
                              route_boxes=route,
                              quarantine_box=_get_qbox(arrays, meta))
        ing.state = _load_stream_state(arrays, meta, mesh.device)
        ing.n_stream = int(meta["n_stream"])
        ing._epoch = int(meta["epoch"])
        ing._fault_stats.update(meta.get("fault_stats", {}))
        return ing
    if kind == "join_streaming":
        from ..joins.dim import DimTable
        from ..joins.synopsis import JoinSynopsis
        # The raw uint32 words of key_root as the port's int64 key.
        arrays = dict(arrays, **{"jsyn/key_root": _get_key(
            arrays, "jsyn/key_root").astype(np.int64)})
        jsyn = _get_dc(JoinSynopsis, arrays, "jsyn", meta["jsyn"], device,
                       nested={"base": Synopsis, "tree": PartitionTree,
                               "dim": DimTable})
        ing = JoinStreamingIngestor(jsyn, key=_get_key(arrays, "ing/key"),
                                    quarantine_box=_get_qbox(arrays, meta),
                                    device=device)
        ing.state = _load_stream_state(arrays, meta, device)
        ing.jstate = _get_dc(JoinStreamState, arrays, "jstate",
                             meta["jstate"], device)
        ing.n_stream = int(meta["n_stream"])
        ing.n_regrown = int(meta["n_regrown"])
        ing._epoch = int(meta["epoch"])
        if meta.get("has_pending"):
            ing._pending = [(np.asarray(arrays["pending/c"]),
                             np.asarray(arrays["pending/a"]),
                             np.asarray(arrays["pending/k"]))]
        return ing
    if kind == "catalog":
        from ..api.config import CatalogConfig
        from ..partitions import CatalogSource, PartitionStore
        parts = [(np.asarray(arrays[f"part/{p}/c"]),
                  np.asarray(arrays[f"part/{p}/a"]))
                 for p in range(int(meta["num_partitions"]))]
        src = CatalogSource(PartitionStore(parts),
                            _config_from_meta(CatalogConfig, meta["config"]),
                            build_kw=meta.get("build_kw") or None,
                            device=device)
        src._draws = int(meta["draws"])
        src._epoch = int(meta["epoch"])
        src._degraded = {int(p) for p in meta.get("degraded", ())}
        return src
    raise ValueError(f"unknown checkpoint source type {kind!r}")


def load_engine(cls, path, *, serving=None, ci=None, mesh=None,
                plan_cache_size: int = 32, device=None):
    """Rebuild a ``cls`` (PassEngine) from a :func:`save_engine` file, the
    port's or the JAX package's, serving on ``device`` (None = the CUDA
    card). ``serving=`` / ``ci=`` override the checkpointed configs;
    ``mesh`` (a :class:`~repro_torch.sharded.ShardMesh`) places a sharded
    source and must have the checkpoint's shard count; None means
    ``data_mesh(n_shards)`` on ``device``."""
    from ..api.config import CIConfig, ServingConfig
    from ..sharded.mesh import ShardMesh

    if mesh is not None and not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh must be a ShardMesh (sharded.data_mesh), "
                        f"got {type(mesh).__name__}")
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as npz:
        arrays = {k: npz[k] for k in npz.files}
    meta = json.loads(str(arrays.pop("__meta__")[()]))
    if int(meta.get("version", -1)) != CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint version {meta.get('version')!r} is not supported "
            f"(expected {CHECKPOINT_VERSION})")

    source = _restore_source(arrays, meta, dev, mesh)
    if serving is None:
        serving = _config_from_meta(ServingConfig, meta["serving"])
    if ci is None:
        ci = _config_from_meta(CIConfig, meta["ci"])
    return cls(source, serving=serving, ci=ci,
               plan_cache_size=plan_cache_size, device=dev)


__all__ = ["CHECKPOINT_VERSION", "save_engine", "load_engine"]
