"""The port's data pipelines and converters against the JAX package's, on
fixtures the tests write (a PIL PNG class-per-folder tree and a hand-made
SQuAD JSON + vocab.txt, as tests/test_data_loaders.py writes them):

- ``fp8tpu_torch.data.imagenet``: listings, val and train transforms
  (the same ``np.random.Generator`` draws), batches and npz files equal
  byte for byte to ``fp8tpu.data.imagenet``'s;
- ``fp8tpu_torch.data.squad``: tokens, features, npz files, decoded
  answers and string EM / F1 equal to ``fp8tpu.data.squad``'s;
- ``utils.metrics.beam_search_spans`` / ``squad_em_f1`` equal to the JAX
  module's, on arrays and on tensors;
- ``tools.convert_torch.convert_vit`` / ``convert_bert_qa``: the tool's
  arrays byte for byte, a wrong architecture refused, the converted ViT's
  logits the torchvision-named module's own.
"""

import json

import numpy as np
import pytest

import torch

import fp8tpu.data.imagenet as jimg
import fp8tpu.data.squad as jsq
import fp8tpu_torch.data.imagenet as timg
import fp8tpu_torch.data.squad as tsq
import test_convert_torch as jconv
from test_data_loaders import _VOCAB, image_tree  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def squad_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("squad")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(_VOCAB) + "\n")
    context = "The capital of France is Paris. Paris is a bigger city."
    data = {"data": [{"title": "t", "paragraphs": [{
        "context": context,
        "qas": [
            {"id": "q1", "question": "What is the capital of France?",
             "answers": [{"text": "Paris",
                          "answer_start": context.index("Paris")}]},
            {"id": "q2", "question": "What is a bigger city?",
             "answers": [{"text": "Paris",
                          "answer_start": context.rindex("Paris")}]},
            {"id": "q3", "question": "What is France?",
             "is_impossible": True, "answers": []},
        ]}]}]}
    j = d / "train.json"
    j.write_text(json.dumps(data))
    return str(j), str(vocab)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# -- ImageNet --------------------------------------------------------------

def test_imagenet_listing_and_transforms(image_tree):
    listing = timg.list_image_folder(image_tree)
    assert listing == jimg.list_image_folder(image_tree)
    paths = listing[0]
    _same(timg.load_image_val(paths[0]), jimg.load_image_val(paths[0]))
    _same(timg.load_image_val(paths[4], size=64, resize=80),
          jimg.load_image_val(paths[4], size=64, resize=80))
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for p in paths:
        _same(timg.load_image_train(p, r1), jimg.load_image_train(p, r2))
    assert r1.integers(1 << 30) == r2.integers(1 << 30)
    _same(timg.IMAGENET_MEAN, jimg.IMAGENET_MEAN)
    _same(timg.IMAGENET_STD, jimg.IMAGENET_STD)


def test_imagenet_batches_and_npz(image_tree, tmp_path):
    got = list(timg.imagenet_val_batches(image_tree, batch_size=4))
    want = list(jimg.imagenet_val_batches(image_tree, batch_size=4))
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        _same(gx, wx)
        _same(gy, wy)
    n = timg.imagenet_to_npz(image_tree, str(tmp_path / "t.npz"), limit=5)
    assert n == jimg.imagenet_to_npz(image_tree, str(tmp_path / "j.npz"),
                                     limit=5) == 5
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert t.files == j.files
    for k in t.files:
        _same(t[k], j[k])


def test_imagenet_reads_images_only_in_its_functions():
    """The port imports PIL nowhere but inside the image readers."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(timg))
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any("PIL" in ast.dump(n) for n in top)


# -- SQuAD -----------------------------------------------------------------

def _features(mod, j, vocab, **kw):
    tok = mod.WordPieceTokenizer(vocab)
    examples = mod.parse_squad_json(j)
    return tok, examples, mod.convert_examples_to_features(
        examples, tok, **kw)


@pytest.mark.parametrize("kw", [dict(max_seq_length=40, doc_stride=8),
                                dict(max_seq_length=16, doc_stride=2,
                                     max_query_length=6)])
def test_squad_features_equal(squad_files, kw):
    j, vocab = squad_files
    ttok, tex, tf = _features(tsq, j, vocab, **kw)
    jtok, jex, jf = _features(jsq, j, vocab, **kw)
    for text in ("Bigger city?", "zzz", "The capital, of France."):
        assert ttok.tokenize(text) == jtok.tokenize(text)
    assert [vars(e) for e in tex] == [vars(e) for e in jex]
    for name in ("input_ids", "attention_mask", "token_type_ids", "start",
                 "end", "example_index"):
        _same(getattr(tf, name), getattr(jf, name))


def test_squad_decode_and_metrics_equal(squad_files):
    j, vocab = squad_files
    _, tex, tf = _features(tsq, j, vocab, max_seq_length=40, doc_stride=8)
    _, jex, jf = _features(jsq, j, vocab, max_seq_length=40, doc_stride=8)
    n, length = tf.input_ids.shape
    rng = np.random.default_rng(0)
    oracle_s = np.full((n, length), -10.0, np.float32)
    oracle_e = oracle_s.copy()
    for i in range(n):
        if tf.start[i] > 0:
            oracle_s[i, tf.start[i]] = oracle_e[i, tf.end[i]] = 10.0
    for sl, el, kw in ((oracle_s, oracle_e, {}),
                       (rng.normal(size=(n, length)),
                        rng.normal(size=(n, length)), {}),
                       (oracle_s, oracle_e, {"null_threshold": 0.0})):
        got = tsq.decode_answers(tf, tex, sl, el, **kw)
        want = jsq.decode_answers(jf, jex, sl, el, **kw)
        assert got == want
        assert tsq.squad_string_em_f1(got, tex) == \
            jsq.squad_string_em_f1(want, jex)
    assert tsq.squad_string_em_f1(
        tsq.decode_answers(tf, tex, oracle_s, oracle_e), tex)[
        "exact_match"] > 0


def test_squad_to_npz_equal(squad_files, tmp_path):
    j, vocab = squad_files
    nt = tsq.squad_to_npz(j, vocab, str(tmp_path / "t.npz"),
                          max_seq_length=32, doc_stride=8)
    nj = jsq.squad_to_npz(j, vocab, str(tmp_path / "j.npz"),
                          max_seq_length=32, doc_stride=8)
    assert nt == nj
    t, jj = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert t.files == jj.files
    for k in t.files:
        _same(t[k], jj[k])


def test_span_metrics_equal():
    from fp8tpu.utils import metrics as jm
    from fp8tpu_torch.utils import metrics as tm
    rng = np.random.default_rng(0)
    sl = rng.normal(size=(16, 48)).astype(np.float32)
    el = rng.normal(size=(16, 48)).astype(np.float32)
    for kw in ({}, {"n_best": 5, "max_answer_len": 4},
               {"n_best": 1, "max_answer_len": 1}):
        got = tm.beam_search_spans(torch.from_numpy(sl),
                                   torch.from_numpy(el), **kw)
        want = jm.beam_search_spans(sl, el, **kw)
        for g, w in zip(got, want):
            _same(g, w)
    ps, pe = rng.integers(0, 48, 64), rng.integers(0, 48, 64)
    gs, ge = rng.integers(0, 48, 64), rng.integers(0, 48, 64)
    assert tm.squad_em_f1(torch.from_numpy(ps), pe, gs, ge) == \
        jm.squad_em_f1(ps, pe, gs, ge)


# -- the converters ----------------------------------------------------------

def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            _same(got[k], want[k])


def test_convert_vit_matches_the_tool():
    from convert_torch import convert_vit as jax_convert_vit
    from fp8tpu.models.vision import ViTConfig as JConfig
    from fp8tpu_torch.models import tiny_vit, variables_from_flax
    from fp8tpu_torch.models.vision import ViTConfig
    from fp8tpu_torch.tools.convert_torch import convert_vit
    torch.manual_seed(3)
    tm = jconv.TViT().eval()
    with torch.no_grad():
        tm.class_token.normal_(std=0.02)
    kw = dict(image_size=32, patch_size=8, d_model=64, n_layers=2,
              n_heads=4, d_ff=128, num_classes=10)
    got = convert_vit(tm.state_dict(), ViTConfig(**kw))
    _assert_trees_equal(got, jax_convert_vit(tm.state_dict(), JConfig(**kw)))
    model = tiny_vit(10, device="cpu")
    model.load_state_dict(variables_from_flax(got))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), tm(x).numpy(),
                                   atol=2e-4, rtol=1e-3)
    with pytest.raises((KeyError, ValueError)):
        convert_vit(tm.state_dict(), ViTConfig(**{**kw, "n_layers": 1}))


def _hf_bert_state_dict(layers=2, d=32, ff=64, vocab=128, pos=32):
    """An HF BertForQuestionAnswering's keys and shapes, random values."""
    g = torch.Generator().manual_seed(0)
    sd = {"bert.embeddings.position_ids": torch.arange(pos)[None]}

    def add(name, *shape):
        sd[name] = torch.randn(*shape, generator=g)

    emb = "bert.embeddings"
    add(f"{emb}.word_embeddings.weight", vocab, d)
    add(f"{emb}.position_embeddings.weight", pos, d)
    add(f"{emb}.token_type_embeddings.weight", 2, d)
    for ln in (f"{emb}.LayerNorm",):
        add(f"{ln}.weight", d)
        add(f"{ln}.bias", d)
    for i in range(layers):
        lp = f"bert.encoder.layer.{i}"
        for src, o, n in (("attention.self.query", d, d),
                          ("attention.self.key", d, d),
                          ("attention.self.value", d, d),
                          ("attention.output.dense", d, d),
                          ("intermediate.dense", ff, d),
                          ("output.dense", d, ff)):
            add(f"{lp}.{src}.weight", o, n)
            add(f"{lp}.{src}.bias", o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            add(f"{lp}.{ln}.weight", d)
            add(f"{lp}.{ln}.bias", d)
    add("bert.pooler.dense.weight", d, d)
    add("bert.pooler.dense.bias", d)
    add("qa_outputs.weight", 2, d)
    add("qa_outputs.bias", 2)
    return sd


def test_convert_bert_qa_matches_the_tool():
    from convert_torch import convert_bert_qa as jax_convert_bert_qa
    from fp8tpu.models.bert import BertConfig as JConfig
    from fp8tpu_torch.models import bert_for_qa, variables_from_flax
    from fp8tpu_torch.models.bert import BertConfig
    from fp8tpu_torch.tools.convert_torch import convert_bert_qa
    sd = _hf_bert_state_dict()
    kw = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
              max_position=32, type_vocab=2)
    got = convert_bert_qa(sd, BertConfig(**kw))
    _assert_trees_equal(got, jax_convert_bert_qa(sd, JConfig(**kw)))
    bert_for_qa(BertConfig(**kw), "cpu").load_state_dict(
        variables_from_flax(got))
    with pytest.raises((KeyError, ValueError)):
        convert_bert_qa(sd, BertConfig(**{**kw, "n_layers": 1}))
    with pytest.raises((KeyError, ValueError)):
        convert_bert_qa(_hf_bert_state_dict(layers=1), BertConfig(**kw))


def test_convert_main_refuses_an_unknown_kind(tmp_path):
    from fp8tpu_torch.tools.convert_torch import main
    torch.save({"state_dict": {}}, tmp_path / "x.pt")
    with pytest.raises(SystemExit, match="unknown kind"):
        main(["alexnet", str(tmp_path / "x.pt"), str(tmp_path / "out")])
