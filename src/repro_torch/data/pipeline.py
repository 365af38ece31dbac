"""Deterministic, shardable synthetic token pipeline.

Port of `repro/data/pipeline.py` (numpy only, so a copy: the tokens are
bit for bit the reference's for every (seed, step, shard)).

Properties a production data path needs and this one has:
  * determinism: batch contents are a pure function of (seed, step, shard) --
    restart-safe with no iterator state to checkpoint beyond the step count;
  * host sharding: each host materializes only its shard of the global batch;
  * packing: documents of random length packed into fixed [B, S] windows with
    EOS separators (structure matters for loss masks even with synthetic
    tokens);
  * skip-to-step resume: `at_step(k)` is O(1).

The synthetic stream is a per-shard counter-based PRNG (numpy's
generator seeded from (seed, step, shard)), so two hosts never need to
coordinate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard: int = 0
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 0


class SyntheticTokenDataset:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_shards == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards

    def batch_at(self, step: int) -> dict:
        """The shard-local batch for `step`. Pure function of (seed, step, shard)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard, 0xDA7A]))
        B, S = self.local_batch, cfg.seq_len
        tokens = np.empty((B, S), dtype=np.int32)
        for b in range(B):
            # pack documents with EOS separators
            row = []
            while len(row) < S:
                n = max(2, int(rng.exponential(cfg.mean_doc_len)))
                row.extend(rng.integers(1, cfg.vocab, size=min(n, S - len(row))).tolist())
                if len(row) < S:
                    row.append(cfg.eos_id)
            tokens[b] = row[:S]
        return {"tokens": tokens}

    def at_step(self, step: int) -> Iterator[dict]:
        s = step
        while True:
            yield self.batch_at(s)
            s += 1


def make_host_iterator(vocab: int, seq_len: int, global_batch: int, *,
                       n_shards: int = 1, shard: int = 0, seed: int = 0,
                       start_step: int = 0,
                       mean_doc_len: int = 512) -> Iterator[dict]:
    """The batches from ``start_step`` on. ``mean_doc_len`` (a parameter
    the reference's iterator does not take; its default is the
    reference's) sets the documents' mean length."""
    ds = SyntheticTokenDataset(DataConfig(vocab=vocab, seq_len=seq_len,
                                          global_batch=global_batch,
                                          n_shards=n_shards, shard=shard,
                                          seed=seed,
                                          mean_doc_len=mean_doc_len))
    return ds.at_step(start_step)


__all__ = ["DataConfig", "SyntheticTokenDataset", "make_host_iterator"]
