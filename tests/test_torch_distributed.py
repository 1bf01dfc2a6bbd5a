"""The port's distributed build and serving helpers
(``repro_torch.core.distributed``) on the CPU, against host numpy, the
port's own ``PassEngine`` and the JAX package.

The reference runs these under ``shard_map`` on a (4, 2) ``"data"`` x
``"model"`` mesh of forced host devices (``tests/test_distributed.py``);
the port takes a ``ShardMesh`` of the same axes on one device, each block
in turn. The bars are that test's: the build against host aggregates at
rtol 2e-4 (sums) and 1e-5 (MIN/MAX); ``serve_queries_sharded`` against the
whole-batch answer at rtol 1e-5 (estimates) and rtol 1e-4 / atol 1e-3
(``ci_half``); ``serve_samples_sharded`` at rtol 1e-4 / atol 1e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.api import PassEngine as JEngine, ServingConfig as JServing
from repro.core import distributed as jdist
from repro.core import query as jquery
from repro.core.synopsis import build_synopsis as jbuild
from repro_torch.api import PassEngine, ServingConfig
from repro_torch.core import distributed as dist
from repro_torch.sharded import make_mesh
from test_torch_engine import carry, carry_queries

MESH_SHAPE = ((4, 2), ("data", "model"))


@pytest.fixture(scope="module")
def lake():
    """(c, a, JAX synopsis, port synopsis): 8192 rows, k = 16, 2 % sample
    (10 slots a stratum, not a multiple of 4)."""
    rng = np.random.default_rng(0)
    n, k = 8192, 16
    c = np.sort(rng.uniform(0, 100, n))
    a = rng.lognormal(0, 1, n)
    jsyn, _ = jbuild(c, a, k=k, sample_rate=0.02, method="eq")
    return c, a, jsyn, carry(jsyn)


def _mesh(sizes=MESH_SHAPE[0], names=MESH_SHAPE[1]):
    return make_mesh(sizes, names, device="cpu")


def _host_aggregates(a, assign, k):
    host = np.zeros((k, 5))
    for i in range(k):
        rows = a[assign == i]
        host[i] = ([rows.sum(), (rows ** 2).sum(), rows.size, rows.min(),
                    rows.max()] if rows.size else [0, 0, 0, 3e38, -3e38])
    return host


@pytest.mark.parametrize("axes,n", [(("data", "model"), 8192),
                                    (("data",), 8192),
                                    (("data", "model"), 8190)])
def test_build_leaf_aggregates_matches_host(lake, axes, n):
    """Rows dealt over 8 or 4 blocks (the last case ragged: padded with
    dropped ids), each block one segment_reduce, the blocks folded;
    segment 3 empty."""
    c, a, _, syn = lake
    c, a = c[:n], a[:n]
    k = syn.num_leaves
    lo = syn.leaf_lo[:, 0].numpy()
    assign = np.clip(np.searchsorted(lo, c, side="right") - 1, 0, k - 1)
    assign[assign == 3] = 4
    got = dist.build_leaf_aggregates(_mesh(), a, assign, k, data_axes=axes)
    assert got.shape == (k, 5) and got.dtype == torch.float32
    host = _host_aggregates(a, assign, k)
    np.testing.assert_allclose(got[:, :3].numpy(), host[:, :3], rtol=2e-4)
    np.testing.assert_allclose(got[:, 3:].numpy(), host[:, 3:], rtol=1e-5)
    one = dist.local_leaf_aggregates(torch.tensor(a, dtype=torch.float32),
                                     torch.tensor(assign), k)
    np.testing.assert_array_equal(got[:, 2:].numpy(), one[:, 2:].numpy())


@pytest.mark.parametrize("q,seed", [(64, 1), (13, 2)])
def test_serve_queries_sharded_matches_answer(lake, q, seed):
    """Q = 64 over 8 blocks, and a ragged Q = 13 (padded to 16, the pad
    rows sliced off): against the port's whole-batch answer and the JAX
    engine's."""
    c, _, jsyn, syn = lake
    jq = jquery.random_queries(c, q, seed=seed)
    est, ci, lo, hi = dist.serve_queries_sharded(_mesh(), syn,
                                                 carry_queries(jq),
                                                 kind="sum")
    assert est.shape == ci.shape == lo.shape == hi.shape == (q,)
    ref = PassEngine(syn, ServingConfig(kinds=("sum",)),
                     device="cpu").answer(carry_queries(jq))["sum"]
    np.testing.assert_allclose(est.numpy(), ref.estimate.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(ci.numpy(), ref.ci_half.numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(lo.numpy(), ref.lower.numpy(), rtol=1e-5)
    np.testing.assert_allclose(hi.numpy(), ref.upper.numpy(), rtol=1e-5)
    jref = JEngine(jsyn, JServing(kinds=("sum",))).answer(jq)["sum"]
    np.testing.assert_allclose(est.numpy(), np.asarray(jref.estimate),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["sum", "count"])
def test_serve_samples_sharded_matches_answer(lake, kind):
    """The slot axis cut on "model" (10 slots into 2 blocks, and into 4
    blocks with 2 invalid pad slots): estimates against the whole-synopsis
    answer of the port and of the JAX engine."""
    c, _, jsyn, syn = lake
    jq = jquery.random_queries(c, 64, seed=1)
    ref = PassEngine(syn, ServingConfig(kinds=(kind,)),
                     device="cpu").answer(carry_queries(jq))[kind]
    jref = JEngine(jsyn, JServing(kinds=(kind,))).answer(jq)[kind]
    for mesh in (_mesh(), _mesh((2, 4))):
        est, ci = dist.serve_samples_sharded(mesh, syn, carry_queries(jq),
                                             kind=kind)
        assert est.shape == ci.shape == (64,)
        np.testing.assert_allclose(est.numpy(), ref.estimate.numpy(),
                                   rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(est.numpy(), np.asarray(jref.estimate),
                                   rtol=1e-4, atol=1e-2)
        assert torch.isfinite(ci).all() and (ci >= 0).all()
    with pytest.raises(ValueError, match="sum/count"):
        dist.serve_samples_sharded(_mesh(), syn, carry_queries(jq),
                                   kind="avg")


def test_pad_to_matches_reference():
    rng = np.random.default_rng(3)
    for shape, mult, axis, fill in (((13,), 8, 0, 0), ((16,), 8, 0, 0),
                                    ((5, 3), 4, 0, -1), ((5, 3), 2, 1, 7),
                                    ((2, 10, 3), 4, 1, 0)):
        x = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jdist.pad_to(jnp.asarray(x), mult, axis=axis,
                                       fill=fill))
        got = dist.pad_to(torch.from_numpy(x), mult, axis=axis, fill=fill)
        np.testing.assert_array_equal(got.numpy(), want)
    x = torch.ones(8)
    assert dist.pad_to(x, 4) is x
