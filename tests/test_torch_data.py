"""fp8tpu_torch.data against fp8tpu.data: the numpy-only corpora give the
same arrays from the same seeds."""

import os

import numpy as np
import pytest

import fp8tpu.data as jdata
from fp8tpu.data import text as jtext
import fp8tpu_torch.data as tdata
from fp8tpu_torch.data import text as ttext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,args,kw", [
    ("markov_tokens", (6, 40), dict(vocab=16, branching=3, seed=2,
                                    table_seed=1)),
    ("induction_tokens", (5, 33), dict(vocab=32768, seed=41)),
    ("mixed_lm_corpus", (7, 24), dict(vocab=16, seed=3)),
    ("pattern_images", (9,), dict(size=8, n_classes=4, seed=5)),
    ("markov_entropy_floor", (), dict(vocab=12, branching=3, seed=4)),
])
def test_synthetic_corpora_equal(name, args, kw):
    want = getattr(jdata, name)(*args, **kw)
    got = getattr(tdata, name)(*args, **kw)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_text_corpora_equal():
    """byte_corpus, local_code_corpus and text_file_corpus over files of this
    repository."""
    files = sorted(os.path.join(REPO, "fp8tpu_torch", "data", f)
                   for f in ("synthetic.py", "text.py", "__init__.py"))
    np.testing.assert_array_equal(ttext.byte_corpus(files, 4, 64, seed=1),
                                  jtext.byte_corpus(files, 4, 64, seed=1))
    root = os.path.join(REPO, "fp8tpu_torch", "data")
    np.testing.assert_array_equal(
        ttext.local_code_corpus(3, 32, seed=2, root=root),
        jtext.local_code_corpus(3, 32, seed=2, root=root))
    np.testing.assert_array_equal(
        ttext.text_file_corpus(files[0], 2, 50, seed=3),
        jtext.text_file_corpus(files[0], 2, 50, seed=3))
    with pytest.raises(FileNotFoundError):
        ttext.byte_corpus([os.path.join(REPO, "no such file")], 1, 4)
