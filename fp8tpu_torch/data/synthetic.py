"""Deterministic synthetic corpora with learnable structure.

The reference's de-facto accuracy suite is its examples producing
ImageNet top-1 / SQuAD F1 on real datasets (imagenet_test.py:121-211,
run_squad.py) — real data cannot ship with this repo, so the accuracy
gates train on generated structure instead (VERDICT r1 §3):

* ``markov_tokens`` — an order-2 Markov language with a fixed sparse
  transition table.  Its entropy floor is computable exactly, so "model
  trained to convergence" is checkable (PPL → floor), and quantization
  regressions move PPL against a meaningful baseline.
* ``induction_tokens`` — second half repeats the first half; solvable
  only through attention (induction heads), exercising the KV path.
* ``pattern_images`` — class-conditional frequency patterns + noise for
  conv/QAT gates.
"""

from __future__ import annotations

import numpy as np


def _transition_table(vocab: int, branching: int, seed: int) -> np.ndarray:
    """(vocab, vocab, vocab) order-2 transition probabilities with
    ``branching`` plausible successors per context."""
    rng = np.random.default_rng(seed)
    table = np.zeros((vocab, vocab, vocab), np.float64)
    for a in range(vocab):
        for b in range(vocab):
            succ = rng.choice(vocab, size=branching, replace=False)
            w = rng.dirichlet(np.full(branching, 2.0))
            table[a, b, succ] = w
    return table


def markov_entropy_floor(vocab: int = 64, branching: int = 4,
                         seed: int = 0) -> float:
    """exp(conditional entropy) — the best achievable PPL on the
    order-2 Markov corpus (up to the stationary-distribution weighting,
    approximated uniform over contexts)."""
    t = _transition_table(vocab, branching, seed)
    p = t.reshape(-1, vocab)
    h = -np.sum(np.where(p > 0, p * np.log(p), 0.0), axis=1)
    return float(np.exp(h.mean()))


def markov_tokens(n_seqs: int, seq_len: int, vocab: int = 64,
                  branching: int = 4, seed: int = 0,
                  table_seed: int = 0) -> np.ndarray:
    """(n_seqs, seq_len) int32 samples from the order-2 chain."""
    t = _transition_table(vocab, branching, table_seed)
    rng = np.random.default_rng(seed)
    out = np.zeros((n_seqs, seq_len), np.int32)
    out[:, 0] = rng.integers(0, vocab, n_seqs)
    out[:, 1] = rng.integers(0, vocab, n_seqs)
    # vectorized over sequences: sample successor per (a, b) context
    for i in range(2, seq_len):
        probs = t[out[:, i - 2], out[:, i - 1]]          # (n, vocab)
        cum = probs.cumsum(axis=1)
        u = rng.random((n_seqs, 1))
        out[:, i] = (u < cum).argmax(axis=1)
    return out


def induction_tokens(n_seqs: int, seq_len: int, vocab: int = 64,
                     seed: int = 0) -> np.ndarray:
    """(n_seqs, seq_len): random first half, exact repeat second half.
    Predicting the second half requires attending ~seq_len/2 back."""
    rng = np.random.default_rng(seed)
    half = seq_len // 2
    first = rng.integers(0, vocab, (n_seqs, half), dtype=np.int32)
    rep = np.concatenate([first, first], axis=1)
    return rep[:, :seq_len].astype(np.int32)


def mixed_lm_corpus(n_seqs: int, seq_len: int, vocab: int = 64,
                    seed: int = 0) -> np.ndarray:
    """Half Markov, half induction — the LM-gate training corpus."""
    a = markov_tokens(n_seqs // 2, seq_len, vocab, seed=seed)
    b = induction_tokens(n_seqs - n_seqs // 2, seq_len, vocab,
                         seed=seed + 1)
    out = np.concatenate([a, b], axis=0)
    rng = np.random.default_rng(seed + 2)
    return out[rng.permutation(len(out))]


def pattern_images(n: int, size: int = 16, n_classes: int = 8,
                   channels: int = 3, noise: float = 0.3,
                   seed: int = 0) -> tuple:
    """Class-conditional 2-D frequency patterns + Gaussian noise.

    Returns (images (n, size, size, channels) f32, labels (n,) int32).
    Linearly separable in frequency space but not pixel space — a conv
    net learns it to ~100%; heavy quantization damage shows as accuracy
    loss (the conv/QAT gate's signal).
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    protos = np.stack([
        np.sin(2 * np.pi * ((c % 4 + 1) * xx + (c // 4 + 1) * yy))
        for c in range(n_classes)
    ])                                                   # (C, H, W)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    imgs = protos[labels][..., None] * np.ones((channels,), np.float32)
    imgs = imgs + rng.normal(0, noise, imgs.shape)
    return imgs.astype(np.float32), labels
