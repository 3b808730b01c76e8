"""Synthetic datasets (no datasets ship offline; both are class-structured so
models genuinely learn and per-exit accuracy differences are measurable).

* ``cifar_like``  — 32x32x3 images: each class has a Gaussian template plus
  noise; linear separability is controlled by ``noise``, so deeper exits
  (more capacity) measurably outperform shallow exits after training.
* ``token_stream`` — integer LM batches from a mixture of k-gram generators,
  giving a learnable next-token structure.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def cifar_like(rng: np.random.Generator, num: int, num_classes: int = 10,
               noise: float = 0.7, image: int = 32, channels: int = 3
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x [N,H,W,C] f32, y [N] int32)."""
    tpl_rng = np.random.default_rng(1234)  # fixed templates across calls
    templates = tpl_rng.normal(0, 1, (num_classes, image, image, channels))
    # low-frequency templates: blur by average pooling then upsampling
    t = templates.reshape(num_classes, image // 4, 4, image // 4, 4, channels).mean((2, 4))
    templates = np.repeat(np.repeat(t, 4, axis=1), 4, axis=2)
    y = rng.integers(0, num_classes, num)
    x = templates[y] + noise * rng.normal(0, 1, (num, image, image, channels))
    return x.astype(np.float32), y.astype(np.int32)


def cifar_batches(seed: int, batch: int, num_classes: int = 10,
                  noise: float = 0.7) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        yield cifar_like(rng, batch, num_classes, noise)


def token_stream(rng: np.random.Generator, batch: int, seq: int,
                 vocab: int, order: int = 2) -> np.ndarray:
    """Markov-ish token batch [B, S] with learnable bigram structure."""
    tab_rng = np.random.default_rng(99)
    nxt = tab_rng.integers(0, vocab, (vocab,))
    toks = np.empty((batch, seq), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    noise = rng.random((batch, seq)) < 0.15
    rnd = rng.integers(0, vocab, (batch, seq))
    for t in range(1, seq):
        toks[:, t] = np.where(noise[:, t], rnd[:, t], nxt[toks[:, t - 1]])
    return toks.astype(np.int32)


def token_batches(seed: int, batch: int, seq: int, vocab: int
                  ) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    while True:
        yield token_stream(rng, batch, seq, vocab)
