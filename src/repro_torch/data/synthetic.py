"""Synthetic LM corpus and loaders (offline stand-in for WikiText-2 / C4),
the port of ``repro.data.synthetic``.

A Zipf-weighted Markov chain gives the model real structure to learn
(bigram statistics plus a slow "topic" state). The chain and the batches
are numpy in both packages, so the port's batches hold the JAX package's
arrays from the same seed; they come back as CPU int64 tensors, and the
consumer moves them to its device. Batches are a pure function of
``(seed, step)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import torch_dtype


@dataclasses.dataclass
class SyntheticCorpus:
    """Zipf-Markov chain over a vocab with `n_topics` latent regimes."""
    vocab_size: int
    n_topics: int = 2
    branch: int = 8             # out-degree of each state
    zipf_a: float = 1.5
    seed: int = 1234

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, B = self.vocab_size, min(self.branch, self.vocab_size)
        # per-topic sparse transition tables: V x B successor ids + probs
        self.succ = rng.integers(0, V, size=(self.n_topics, V, B),
                                 dtype=np.int32)
        w = (1.0 / np.arange(1, B + 1) ** self.zipf_a)
        self.probs = (w / w.sum()).astype(np.float32)
        self.topic_stay = 0.995

    def sample(self, rng: np.random.Generator, batch: int,
               seq: int) -> np.ndarray:
        """(batch, seq+1) token stream (callers split into input/label)."""
        out = np.empty((batch, seq + 1), np.int32)
        tok = rng.integers(0, self.vocab_size, size=batch).astype(np.int32)
        topic = rng.integers(0, self.n_topics, size=batch)
        for t in range(seq + 1):
            out[:, t] = tok
            switch = rng.random(batch) > self.topic_stay
            topic = np.where(
                switch, rng.integers(0, self.n_topics, size=batch), topic)
            choice = rng.choice(self.probs.shape[0], size=batch, p=self.probs)
            tok = self.succ[topic, tok, choice]
        return out


def make_batch(cfg: ModelConfig, corpus: SyntheticCorpus, seed: int,
               step: int, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """Pure function of (seed, step) -> {'tokens', 'labels'}: (B, S) for
    the token families; the audio family's (B, S, K) frames, K streams
    drawn one after another from the step's generator. The VLM's batch
    adds 'image_embeds' (B, n_image_tokens, d_model), the stubbed patch
    embeddings drawn standard normal from the same generator after the
    tokens and cast to the model dtype (the JAX package's arrays, bit for
    bit)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.family == "audio":
        full = np.stack([corpus.sample(rng, batch, seq)
                         for _ in range(cfg.n_codebooks)], axis=-1)
    else:
        full = corpus.sample(rng, batch, seq)
    full = torch.from_numpy(full).long()
    b = {"tokens": full[:, :-1], "labels": full[:, 1:]}
    if cfg.family == "vlm":
        img = rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        b["image_embeds"] = torch.from_numpy(img).to(torch_dtype(cfg))
    return b


def train_iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                   start_step: int = 0,
                   corpus: Optional[SyntheticCorpus] = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite deterministic stream of :func:`make_batch` from step
    `start_step` on: a resumed run passes the step it restored and reads
    the batches it would have read (deterministic data skip)."""
    corpus = corpus or SyntheticCorpus(cfg.vocab_size)
    step = start_step
    while True:
        yield make_batch(cfg, corpus, seed, step, batch, seq)
        step += 1


def calib_batches(cfg: ModelConfig, n_samples: int = 16, seq: int = 128,
                  batch: int = 4, seed: int = 7,
                  corpus: Optional[SyntheticCorpus] = None
                  ) -> List[Dict[str, torch.Tensor]]:
    """Calibration set of the PTQ pipeline (paper: 128 x 2048 samples)."""
    corpus = corpus or SyntheticCorpus(cfg.vocab_size)
    return [make_batch(cfg, corpus, seed, i, batch, seq)
            for i in range(max(1, n_samples // batch))]


def eval_perplexity(loss_fn, params, cfg, batches) -> float:
    """exp(mean token NLL) over a batch list."""
    tot, n = 0.0, 0
    with torch.no_grad():
        for b in batches:
            tot += float(loss_fn(params, cfg, b, training=False))
            n += 1
    return float(np.exp(tot / max(n, 1)))
