"""Deterministic synthetic corpora for tests, benchmarks and examples.

Zipfian token streams (text-like marginal statistics) with a learnable
bigram structure so small models show decreasing loss; generation is
pure (seed -> bytes), so any two hosts materialize identical shards —
required for the elastic-restart equivalence tests.

Port of ``repro/data/synthetic.py``: the same numpy code, copied so that
the port does not import the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from repro_torch.data.shards import ShardIndex, write_shards


def zipf_bigram_tokens(num_seqs: int, seq_len: int, vocab: int,
                       seed: int = 0) -> np.ndarray:
    """(num_seqs, seq_len + 1) int32: zipf unigrams + deterministic
    bigram transitions (token -> (a * token + c) % vocab with noise)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = np.empty((num_seqs, seq_len + 1), np.int32)
    toks[:, 0] = rng.choice(vocab, size=num_seqs, p=probs)
    a, c = 31, 17
    for t in range(1, seq_len + 1):
        follow = (a * toks[:, t - 1] + c) % vocab
        noise = rng.choice(vocab, size=num_seqs, p=probs)
        use_bigram = rng.random(num_seqs) < 0.7
        toks[:, t] = np.where(use_bigram, follow, noise)
    return toks


def make_lm_records(num_seqs: int, seq_len: int, vocab: int,
                    seed: int = 0, varlen: bool = False
                    ) -> Dict[str, np.ndarray]:
    """inputs/labels (shifted), optional ragged lengths + pad weights."""
    toks = zipf_bigram_tokens(num_seqs, seq_len, vocab, seed)
    rec = {"inputs": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if varlen:
        rng = np.random.default_rng(seed + 1)
        lens = rng.integers(seq_len // 4, seq_len + 1, size=num_seqs)
        w = (np.arange(seq_len)[None, :] < lens[:, None]).astype(np.float32)
        rec["weights"] = w
        rec["lengths"] = lens.astype(np.int64)
    return rec


def build_synthetic_corpus(out_dir: str, num_seqs: int = 512,
                           seq_len: int = 128, vocab: int = 256,
                           rows_per_shard: int = 64, seed: int = 0,
                           varlen: bool = False) -> ShardIndex:
    if os.path.exists(os.path.join(out_dir, "manifest.json")):
        return ShardIndex(out_dir)
    rec = make_lm_records(num_seqs, seq_len, vocab, seed, varlen)
    return write_shards(out_dir, rec, rows_per_shard)
