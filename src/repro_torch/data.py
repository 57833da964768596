"""Deterministic synthetic token stream (counterpart of
``repro/data.py::SyntheticLM``), numpy only: the same seed and step give
bit-identical batches, the reference's draws in the reference's order.
A prefix arch (``prefix_slots > 0``, a decoder such as internvl2-2b) gets
``prefix`` [B, P, prefix_dim] standard normal f32 (a modality frontend's
embeddings), its tokens cut to S - P and its first P labels ignored; an
encoder-decoder (seamless-m4t-large-v2) gets ``enc_input`` [B, S,
prefix_dim] standard normal f32 (the encoder's frames).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    # zipfian tokens with markov structure: clustered token embeddings,
    # which condensation exploits
    zipf_a: float = 1.2
    markov_order: int = 1
    min_len_frac: float = 0.5      # sequences have len in [frac*S, S]
    length_buckets: int = 4


class SyntheticLM:
    """Deterministic synthetic language-model stream."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig()):
        self.cfg, self.shape, self.dc = cfg, shape, data_cfg
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.unigram = ranks ** (-data_cfg.zipf_a)
        self.unigram /= self.unigram.sum()

    def _sample_tokens(self, rng, n):
        return rng.choice(self.cfg.vocab_size, size=n, p=self.unigram
                          ).astype(np.int32)

    def batch(self, step: int, *, global_batch: Optional[int] = None,
              seq_len: Optional[int] = None) -> Dict[str, np.ndarray]:
        """tokens [B, S] (0 past each length), labels [B, S] (-1 past
        it), seq_len [B], sorted by length; a prefix arch also ``prefix``
        [B, P, pd] with tokens [B, S - P] and labels [:, :P] = -1, an
        encoder-decoder ``enc_input`` [B, S, pd] (pd: ``prefix_dim`` or
        ``d_model``)."""
        B = global_batch or self.shape.global_batch
        S = seq_len or self.shape.seq_len
        rng = np.random.default_rng((self.dc.seed, step))
        toks = self._sample_tokens(rng, B * (S + 1)).reshape(B, S + 1)
        # markov smoothing: repeat the previous token sometimes
        rep = rng.random((B, S + 1)) < 0.3
        for t in range(1, S + 1):
            toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
        lens = rng.integers(max(2, int(self.dc.min_len_frac * S)), S + 1,
                            size=B).astype(np.int32)
        # length bucketing: co-batched sequences have similar lengths
        order = np.argsort(lens, kind="stable")
        toks, lens = toks[order], lens[order]
        tokens = toks[:, :S].copy()
        labels = toks[:, 1:S + 1].astype(np.int32).copy()
        pos = np.arange(S)[None, :]
        labels[pos >= lens[:, None]] = -1
        tokens[pos >= lens[:, None]] = 0
        batch = {"tokens": tokens, "labels": labels, "seq_len": lens}
        width = self.cfg.prefix_dim or self.cfg.d_model
        if self.cfg.prefix_slots > 0 and self.cfg.kind != "encdec":
            P = self.cfg.prefix_slots
            batch["prefix"] = rng.standard_normal((B, P, width)).astype(
                np.float32)
            # the prefix takes the first P positions: the tokens shrink
            # and the first P labels are ignored
            batch["tokens"] = tokens[:, :S - P]
            lbl = labels.copy()
            lbl[:, :P] = -1
            batch["labels"] = lbl
        if self.cfg.kind == "encdec":
            batch["enc_input"] = rng.standard_normal((B, S, width)).astype(
                np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
