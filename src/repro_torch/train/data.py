"""Synthetic multimodal LM data pipeline, a copy of ``repro.train.data``
(batches equal bit for bit at the same seed).

Deterministic, seeded batch stream with (a) Zipfian token draws so the loss
has learnable structure, (b) optional media/frames embeddings for VLM/audio
configs, (c) document packing with -1 label padding at boundaries.  Batches
are numpy arrays; :func:`to_device` makes them tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    doc_len_mean: int = 96       # documents packed into seq_len rows


def _zipf_tokens(rng, n, vocab):
    # zipf over a capped vocab so small smoke vocabs work
    z = rng.zipf(1.3, size=n).astype(np.int64)
    return (z % vocab).astype(np.int32)


def batches(cfg: ModelConfig, data: DataConfig) -> Iterator[dict]:
    rng = np.random.default_rng(data.seed)
    n_media = cfg.media_tokens if cfg.frontend != "none" else 0
    while True:
        B, S = data.batch_size, data.seq_len
        toks = np.empty((B, S), np.int32)
        labels = np.empty((B, S), np.int32)
        for b in range(B):
            row = []
            while len(row) < S:
                L = max(8, int(rng.exponential(data.doc_len_mean)))
                doc = _zipf_tokens(rng, L, cfg.vocab_size)
                # inject learnable bigram structure: even positions echo
                doc[1::2] = (doc[0::2][: len(doc[1::2])] + 1) % cfg.vocab_size
                row.extend(doc.tolist() + [-1])  # -1 marks the boundary
            row = np.array(row[:S], np.int32)
            labels[b] = row
            toks[b] = np.maximum(row, 0)
        batch = {"tokens": toks, "labels": labels}
        if n_media:
            med = rng.standard_normal((B, n_media, cfg.d_model)).astype(np.float32)
            key = "frames" if cfg.frontend == "audio" else "media"
            batch[key] = med * 0.02
        yield batch


def to_device(batch: dict, device, dtype=torch.float32) -> dict:
    """The batch as tensors on ``device``: token ids as int64, media /
    frames embeddings in ``dtype`` (the weights' type)."""
    return {k: torch.from_numpy(v).to(device, dtype if v.dtype.kind == "f"
                                      else torch.int64)
            for k, v in batch.items()}
