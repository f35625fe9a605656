"""Deterministic synthetic data pipeline (the port of
``repro/data/pipeline.py``: ``SyntheticLM`` is the reference's, copied as
it is; numpy only, so its batches equal the reference's bitwise).

Produces reproducible token streams without any external corpus:

* tokens are a position/seed hash (stationary, full-vocab coverage) with a
  learnable n-gram structure mixed in so losses actually decrease;
* document boundaries are simulated (documents of geometric length packed
  back-to-back, BOS-separated) — the packing path real pipelines need;
* shard-aware: ``batch_at(step, shard, n_shards)`` yields only this host's
  slice, so multi-host training reads disjoint data without coordination;
* stateless access by step index — restart/elastic-rescale resume exactly
  (fault-tolerance substrate depends on this).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: float = 512.0
    bos: int = 0

    def _doc_tokens(self, doc_id: np.ndarray, offset: np.ndarray
                    ) -> np.ndarray:
        """Deterministic per-document token stream with bigram structure."""
        h = (doc_id.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + offset.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
             + np.uint64(self.seed))
        h ^= h >> np.uint64(31)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(29)
        base = (h % np.uint64(self.vocab)).astype(np.int64)
        # bigram structure: even offsets determine the next token
        nxt = (base * 31 + 17) % self.vocab
        return np.where(offset % 2 == 0, base, nxt).astype(np.int32)

    def sequence(self, seq_id: int) -> np.ndarray:
        """One packed sequence of seq_len + 1 tokens (inputs + shifted)."""
        rng = np.random.default_rng((self.seed << 20) ^ seq_id)
        toks = np.empty(self.seq_len + 1, np.int32)
        pos = 0
        doc = seq_id << 16
        while pos < self.seq_len + 1:
            dlen = 1 + int(rng.geometric(1.0 / self.mean_doc_len))
            dlen = min(dlen, self.seq_len + 1 - pos)
            off = np.arange(dlen)
            toks[pos:pos + dlen] = self._doc_tokens(
                np.full(dlen, doc, np.int64), off)
            toks[pos] = self.bos                     # document boundary
            pos += dlen
            doc += 1
        return toks

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> dict:
        """{tokens, targets} for this shard at this step (stateless)."""
        assert self.global_batch % n_shards == 0
        per = self.global_batch // n_shards
        seqs = np.stack([
            self.sequence(step * self.global_batch + shard * per + i)
            for i in range(per)])
        return {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}


def make_batch_specs(cfg, shape, mesh, batch_axes: tuple) -> dict:
    """An ``InputSpec`` for each batch field, the batch dim over the data
    axes (``mesh`` is the reference's argument; the spec names its axes
    only)."""
    from repro_torch.models.config import input_specs
    entry = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    return input_specs(cfg, shape, batch_spec=(entry,))
