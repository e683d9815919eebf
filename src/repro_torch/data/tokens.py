"""Deterministic synthetic token pipeline for the LM-family architectures
(port of ``repro/data/tokens.py``).

Reproducible pseudo-text: Zipf-distributed unigrams over the first
``min(vocab, 4096)`` ids with short repeated n-gram motifs written over
them, so models have learnable structure (the loss falls). Sharded
iteration: each data-parallel rank draws only its own slice
(``shard_id`` / ``num_shards``) from a generator keyed by (seed,
step * 65536 + shard_id), as the reference folds its key: restart-safe
for checkpoint/resume. The draws differ from the reference's (JAX's PRNG
bits cannot be reproduced); the structure is the same."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.data import fold_in


@dataclasses.dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return (p / p.sum()).astype(np.float32)


def synth_token_batch(cfg: TokenDataConfig, step: int,
                      shard_id: int = 0, num_shards: int = 1,
                      device="cuda") -> dict:
    """One batch shard: {"tokens": (b_local, S+1) int32} (inputs+labels
    view), on ``device`` (the card unless the caller passes "cpu")."""
    assert cfg.global_batch % num_shards == 0
    dev = resolve_device(device)
    b_local = cfg.global_batch // num_shards
    gen = fold_in(cfg.seed, step * 65536 + shard_id)
    n_vocab = min(cfg.vocab_size, 4096)
    probs = torch.from_numpy(_zipf_probs(n_vocab, cfg.zipf_a))
    n_tok = cfg.seq_len + 1
    base = torch.multinomial(probs, b_local * n_tok, replacement=True,
                             generator=gen).reshape(b_local, n_tok)
    # overlay repeated motifs (learnable bigram/ngram structure)
    motif_bank = torch.randint(
        0, n_vocab, (cfg.n_motifs, cfg.motif_len),
        generator=torch.Generator().manual_seed(cfg.seed + 1))
    n_insert = max(1, n_tok // (4 * cfg.motif_len))
    pos = torch.randint(0, max(1, n_tok - cfg.motif_len), (b_local, n_insert),
                        generator=gen)
    mid = torch.randint(0, cfg.n_motifs, (b_local, n_insert), generator=gen)
    tokens = base
    cols = torch.arange(cfg.motif_len)
    rows = torch.arange(b_local)[:, None]
    for i in range(n_insert):
        idx = pos[:, i:i + 1] + cols[None]                          # (b_local, m)
        tokens[rows, idx] = motif_bank[mid[:, i]]
    return {"tokens": tokens.to(torch.int32).to(dev)}


def token_stream(cfg: TokenDataConfig, start_step: int = 0,
                 shard_id: int = 0, num_shards: int = 1,
                 device="cuda") -> Iterator[dict]:
    step = start_step
    while True:
        yield synth_token_batch(cfg, step, shard_id, num_shards, device)
        step += 1
