"""Byte-level LM corpora from real local text (no downloads).

The reference's acceptance evidence runs on real datasets that cannot
ship in this image; the synthetic generators (data/synthetic.py) keep
the gates *meaningful* (known entropy floor), and this module makes them
*real*: any local text — by default the Python source already installed
under site-packages — becomes a byte-level corpus (vocab 256, matching
the `large` gate preset), so trained ΔPPL gates can be reproduced on
genuine data anywhere, with genuine long-range structure (indentation,
identifiers, bracket matching) that synthetic Markov corpora lack.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

import numpy as np


def byte_corpus(paths: Sequence[str], n_seqs: int, seq_len: int,
                seed: int = 0, max_bytes_per_file: int = 1 << 20
                ) -> np.ndarray:
    """Concatenate files as raw bytes and cut into (n_seqs, seq_len)
    int32 token sequences (vocab 256).  Sequences start at random
    offsets (deterministic in ``seed``), so epochs see different
    alignments of the same underlying text."""
    chunks: List[np.ndarray] = []
    total = 0
    need = n_seqs * seq_len * 2  # oversample so offsets stay diverse
    for p in paths:
        try:
            with open(p, "rb") as f:
                b = f.read(max_bytes_per_file)
        except OSError:
            continue
        if b:
            chunks.append(np.frombuffer(b, np.uint8))
            total += len(b)
        if total >= need:
            break
    if not chunks:
        raise FileNotFoundError("byte_corpus: no readable bytes in paths")
    data = np.concatenate(chunks)
    if len(data) < seq_len + 1:
        reps = -(-(seq_len + 1) // len(data))
        data = np.tile(data, reps)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(data) - seq_len, n_seqs)
    out = np.stack([data[s:s + seq_len] for s in starts])
    return out.astype(np.int32)


def local_code_corpus(n_seqs: int, seq_len: int, seed: int = 0,
                      root: Optional[str] = None,
                      pattern: str = "**/*.py",
                      max_files: int = 4000) -> np.ndarray:
    """Real-text corpus from Python source already on this machine
    (default: the active environment's site-packages).  Deterministic
    file order (sorted) → reproducible across runs on the same image."""
    if root is None:
        import numpy as _np
        root = os.path.dirname(os.path.dirname(_np.__file__))
    files = sorted(glob.glob(os.path.join(root, pattern),
                             recursive=True))[:max_files]
    if not files:
        raise FileNotFoundError(f"no {pattern} under {root}")
    return byte_corpus(files, n_seqs, seq_len, seed=seed)


def text_file_corpus(path: str, n_seqs: int, seq_len: int,
                     seed: int = 0) -> np.ndarray:
    """One file (txt/md/source) → byte-level (n_seqs, seq_len) corpus."""
    return byte_corpus([path], n_seqs, seq_len, seed=seed,
                       max_bytes_per_file=1 << 30)
