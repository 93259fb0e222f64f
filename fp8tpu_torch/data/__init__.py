"""Bundled data utilities (synthetic structured corpora for the
accuracy gates — the reference's examples consume ImageNet/SQuAD which
cannot ship with the repo; these generators give deterministic,
learnable structure so trained-model ΔPPL gates are meaningful).

NumPy only: copies of the JAX package's ``fp8tpu/data/synthetic.py`` and
``text.py``, which give the same arrays from the same seeds."""

from .synthetic import (  # noqa: F401
    induction_tokens,
    markov_entropy_floor,
    markov_tokens,
    mixed_lm_corpus,
    pattern_images,
)

# Real-dataset pipelines (ImageNet folder trees, SQuAD JSON) live in
# .imagenet / .squad, imported by name; .imagenet imports PIL only inside
# the functions that decode images.
