"""Sharded, deterministic, resumable data pipeline (host numpy).

A copy of the JAX package's loader (it has no device code): the same seed
gives the same batches. Each host materializes only its shard of the
global batch (indexed by ``host_id``); the iterator state is a single
integer step counter, so checkpoint/restore gives exact batch replay, and
elastic restarts with a different host count re-derive shards from the
same counter. Token streams here are synthetic (offline) but the
interface matches a tokenized-shard reader.

The loader also keeps a PASS telemetry table over the stream (step x
domain -> loss score): the paper's technique as the approximate-analytics
layer of the pipeline. Mixture statistics queries hit a synopsis built
on ``telemetry_table()`` instead of scanning history.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LoaderState:
    step: int = 0


class TokenLoader:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 num_hosts: int = 1, host_id: int = 0, seed: int = 1234,
                 num_domains: int = 8):
        assert global_batch % num_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.num_domains = num_domains
        self.state = LoaderState()
        # telemetry history for PASS (step, domain, loss placeholder)
        self._telemetry: list[tuple[float, float]] = []

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def next_batch(self) -> dict:
        step = self.state.step
        rng = self._rng_for(step)
        # Markov-ish synthetic tokens: runs + jumps (compressible, non-trivial).
        B, S = self.local_batch, self.seq
        base = rng.integers(0, self.vocab, size=(B, 1))
        steps = rng.integers(-3, 4, size=(B, S)).cumsum(axis=1)
        toks = (base + np.abs(steps)) % self.vocab
        domains = rng.integers(0, self.num_domains, size=(B,))
        batch = {
            "tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, axis=1).astype(np.int32),
            "domains": domains.astype(np.int32),
        }
        self.state.step += 1
        return batch

    # -------------------------------------------------- checkpoint support
    def snapshot(self) -> dict:
        return {"step": self.state.step}

    def restore(self, snap: dict):
        self.state.step = int(snap["step"])

    # -------------------------------------------------- telemetry -> PASS
    def record_telemetry(self, step: int, domain_losses: np.ndarray):
        for d, l in enumerate(np.asarray(domain_losses).reshape(-1)):
            self._telemetry.append((step * self.num_domains + d, float(l)))

    def telemetry_table(self) -> tuple[np.ndarray, np.ndarray]:
        """(predicate column = step*D + domain, value column = loss)."""
        if not self._telemetry:
            return np.zeros(0), np.zeros(0)
        arr = np.asarray(self._telemetry)
        return arr[:, 0], arr[:, 1]


__all__ = ["TokenLoader", "LoaderState"]
