"""The port's BERT (``fp8tpu_torch.models.bert``) against the JAX
package's, with the JAX ``init``'s weights carried across and inputs from
a numpy seed (padding in the mask, both token types):

- fp32 start / end logits within FP32_TOL of their max, and the bf16
  config within BF16_TOL (bf16 roundings of the projections and
  products, in the JAX package's places);
- the module table's kinds at the paths tests/test_bert.py names;
- the reference's PTQ recipe (hybrid, ``BERT_QA_EXEMPT``,
  ``BERT_OUTPUT_FUSED``): logits plain and hw-patched within PTQ_TOL of
  max|logit| (PERF.md §2), the quantized weights bit-equal, qa_outputs
  untouched, query quantized, every score matmul's output uncast; under
  hw patching one engine GEMM per (batch, head) slice of both
  BatchMatmuls;
- bert-large's structure on the meta device, and an HF
  BertForQuestionAnswering through ``tools.convert_torch.convert_bert_qa``
  against its own logits.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fp8tpu
import fp8tpu_torch as ft
from fp8tpu.models import bert as jbert
from fp8tpu_torch.models import bert as tbert
from fp8tpu_torch.models import variables_from_flax
from fp8tpu_torch.quant.policy import LayerKind

FP32_TOL = 1e-5     # of max|logit| (f32 summation order)
BF16_TOL = 2e-2     # of max|logit|: bf16 steps of reordered sums
PTQ_TOL = 2e-3      # of max|logit| (PERF.md §2)
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1024, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    types = np.zeros((B, S), np.int32)
    types[:, 12:] = 1
    return ids, mask, types


def _torch_inputs():
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in _inputs())


@functools.lru_cache(maxsize=None)
def _jax_bert(dtype="float32"):
    """The JAX BertForQA's variables and (start, end) logits; with f32 also
    the hybrid PTQ recipe's logits plain and hw-patched and its quantized
    variables."""
    cfg = jbert.tiny_bert(dtype=dtype)
    model = jbert.BertForQA(cfg)
    args = tuple(jnp.asarray(a) for a in _inputs())
    v = jax.jit(model.init)(jax.random.key(0), *args)
    base = tuple(map(np.asarray, jax.jit(model.apply)(v, *args)))
    if dtype != "float32":
        return jax.tree.map(np.asarray, v), base
    qm = fp8tpu.quantize_model(
        model, v, args[:2], dtype="hybrid",
        list_exempt_layers=jbert.BERT_QA_EXEMPT,
        list_layers_output_fused=jbert.BERT_OUTPUT_FUSED)
    q = {}
    for hw in (False, True):
        qq = dataclasses.replace(qm, policy=qm.policy.with_hw_patching()) \
            if hw else qm
        q[hw] = tuple(map(np.asarray, jax.jit(lambda vv, *a: qq.apply(
            *a, variables=vv))(qm.variables, *args)))
    return (jax.tree.map(np.asarray, v), base, q,
            jax.tree.map(np.asarray, qm.variables))


def _port(variables, dtype="float32"):
    model = tbert.bert_for_qa(tbert.tiny_bert(dtype=dtype), "cpu")
    model.load_state_dict(variables_from_flax(variables))
    return model.eval()


def _rel(got, want):
    return max(float(np.abs(g.numpy() - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_bert_forward_matches_jax(dtype, tol):
    v, base = _jax_bert(dtype)[:2]
    with torch.no_grad():
        got = _port(v, dtype)(*_torch_inputs())
    assert got[0].shape == (B, S) and got[0].dtype == torch.float32
    err = _rel(got, base)
    print(f"{dtype}: logits {err:.3e} of max|logit|")
    assert err <= tol, f"{dtype}: logits {err:.3e} of max|logit|"


def test_bert_module_kinds():
    from fp8tpu_torch.quant.interceptor import build_module_table
    table = build_module_table(tbert.bert_for_qa(tbert.tiny_bert(), "cpu"))
    assert table["bert/layer_0/attention/attn_scores_matmul"] == \
        LayerKind.BATCH_MATMUL
    assert table["bert/layer_0/attention/attn_probs_matmul"] == \
        LayerKind.BATCH_MATMUL
    assert table["bert/layer_0/attn_residual_add"] == LayerKind.ELTWISE
    assert table["bert/layer_1/ffn_residual_add"] == LayerKind.ELTWISE
    assert table["bert/word_embed"] == LayerKind.EMBED
    assert table["bert/layer_0/attn_norm"] == LayerKind.LAYERNORM
    assert table["qa_outputs"] == LayerKind.DENSE


@pytest.mark.parametrize("hw", [False, True], ids=["plain", "hw"])
def test_bert_ptq_recipe_matches_jax(hw, monkeypatch):
    """The reference SQuAD recipe on both packages: hybrid PTQ, qa_outputs
    exempt, attention-score outputs uncast."""
    from fp8tpu_torch.quant import hw_patch
    v, base, q, qv = _jax_bert()
    slices = []
    real = hw_patch.patched_matmul
    monkeypatch.setattr(hw_patch, "patched_matmul",
                        lambda a, b, *r: slices.append(a.shape)
                        or real(a, b, *r))
    policy = ft.get_policy("hybrid", training=False)
    if hw:
        policy = policy.with_hw_patching()
    ids, mask, types = _torch_inputs()
    qm = ft.quantize_model(_port(v), (ids, mask), policy=policy,
                           list_exempt_layers=tbert.BERT_QA_EXEMPT,
                           list_layers_output_fused=tbert.BERT_OUTPUT_FUSED,
                           device="cpu")
    with torch.no_grad():
        got = qm(ids, mask, types)
    err = _rel(got, q[hw])
    print(f"hybrid ({'hw' if hw else 'plain'}): logits {err:.3e} of "
          "max|logit|")
    assert err <= PTQ_TOL, f"hybrid logits {err:.3e} of max|logit|"
    corr = np.corrcoef(got[0].numpy().ravel(), base[0].ravel())[0, 1]
    assert corr > 0.95, corr
    # one engine GEMM per (batch, head) slice of both products, per layer
    cfg = tbert.tiny_bert()
    assert len(slices) == (2 * cfg.n_layers * B * cfg.n_heads if hw else 0)

    want = variables_from_flax(qv)
    bad = {k: int((t.numpy().view(np.uint32)
                   != want[k].numpy().view(np.uint32)).sum())
           for k, t in qm.variables.items()}
    assert not any(bad.values()), {k: n for k, n in bad.items() if n}
    sd = variables_from_flax(v)
    assert torch.equal(qm.variables["qa_outputs.weight"],
                       sd["qa_outputs.weight"])
    key = "bert.layer_0.attention.query.weight"
    assert not torch.equal(qm.variables[key], sd[key])
    for i in range(cfg.n_layers):
        path = f"bert/layer_{i}/attention/attn_scores_matmul"
        c = qm.policy.resolve(path, LayerKind.BATCH_MATMUL)
        assert c is not None and c.oact is None, (path, c)
    assert qm.policy.resolve("qa_outputs", LayerKind.DENSE) is None


def test_bert_output_fused_leaves_scores_uncast():
    """In the training recipe of bert_qa_finetune (hybrid, the fused
    list), the score products' outputs and their gradients are uncast and
    their inputs cast, as the JAX package resolves them."""
    from fp8tpu.quant.policy import LayerKind as JKind
    from fp8tpu.quant.policy import get_policy as jax_policy
    pol = ft.get_policy("hybrid", training=True).with_output_fused(
        *tbert.BERT_OUTPUT_FUSED)
    jpol = jax_policy("hybrid", training=True).with_output_fused(
        *jbert.BERT_OUTPUT_FUSED)
    for name in ("attn_scores_matmul", "attn_probs_matmul"):
        path = f"bert/layer_0/attention/{name}"
        c = pol.resolve(path, LayerKind.BATCH_MATMUL)
        assert c.oact is None and c.ograd is None and c.iact is not None
        assert str(c) == str(jpol.resolve(path, JKind.BATCH_MATMUL))


def test_bert_large_structure():
    """bert-large (24 layers x d 1024 / 16 heads) on the meta device: the
    JAX package's parameter count and all 24 score-matmul paths, the
    recipe resolving the QA head's exemption and the fused pattern."""
    from fp8tpu_torch.quant.interceptor import build_module_table
    cfg = tbert.bert_large_config(dtype="bfloat16")
    model = tbert.bert_for_qa(cfg, "meta")
    ids = jnp.ones((1, 384), jnp.int32)
    shapes = jax.eval_shape(lambda: jbert.BertForQA(
        jbert.bert_large_config(dtype="bfloat16")).init(
        jax.random.key(0), ids))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax > 300e6
    table = build_module_table(model)
    pol = (ft.get_policy("hybrid", training=False)
           .with_exempt(*tbert.BERT_QA_EXEMPT)
           .with_output_fused(*tbert.BERT_OUTPUT_FUSED))
    scores = [p for p in table if p.endswith("attn_scores_matmul")]
    assert len(scores) == 24
    for p in scores:
        c = pol.resolve(p, table[p])
        assert c is not None and c.oact is None
    assert pol.resolve("qa_outputs", table["qa_outputs"]) is None


def test_convert_bert_qa_against_hf():
    """An HF BertForQuestionAnswering through the port's convert_bert_qa
    and variables_from_flax: the port's logits are HF's (the JAX
    package's tests/test_convert_torch.py tolerance)."""
    transformers = pytest.importorskip("transformers")
    from fp8tpu_torch.tools.convert_torch import convert_bert_qa
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, type_vocab_size=2, hidden_act="gelu",
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    tm = transformers.BertForQuestionAnswering(hf_cfg).eval()
    ids = torch.randint(0, 128, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    types = torch.randint(0, 2, (2, 16),
                          generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = tm(input_ids=ids, token_type_ids=types)
    cfg = tbert.BertConfig(vocab_size=128, d_model=32, n_layers=2,
                           n_heads=2, d_ff=64, max_position=32, type_vocab=2)
    model = tbert.bert_for_qa(cfg, "cpu")
    model.load_state_dict(variables_from_flax(
        convert_bert_qa(tm.state_dict(), cfg)))
    with torch.no_grad():
        start, end = model(ids, token_type_ids=types)
    np.testing.assert_allclose(start.numpy(), ref.start_logits.numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(end.numpy(), ref.end_logits.numpy(),
                               atol=2e-4, rtol=1e-3)


# -- examples/bert_qa_finetune.py --------------------------------------------

FINETUNE = ["--batch-size", "4", "--seq-len", "32", "--steps", "3"]
# The whole-whitelist training limits of PERF.md §2 (the hybrid recipe
# casts every Dense and BatchMatmul input per tensor to e4m3 and the
# gradients to e5m2 with SR: one-ulp order differences become e4m3
# steps, ROADMAP trap 66): losses, parameters, the updates' relative L2
# and the share of their signs equal.
FINETUNE_TOL = dict(loss=2e-2, param=1e-2, update=0.25, sign=0.97)


@functools.lru_cache(maxsize=None)
def _jax_finetune():
    """examples/bert_qa_finetune.py's setup and 3 steps with FINETUNE's
    flags: the initial and final variables and the losses."""
    import optax
    from fp8tpu.training import MPTEmulator, init_train_state, make_train_step
    from test_torch_examples import _jax_script, _np
    script = _jax_script("bert_qa_finetune")
    bsz, seq = 4, 32
    cfg = jbert.tiny_bert(max_position=seq)
    model = jbert.BertForQA(cfg)
    key = jax.random.key(0)
    ids = jax.random.randint(jax.random.key(1), (bsz, seq), 0,
                             cfg.vocab_size)
    variables = jax.jit(model.init)(key, ids)
    emu = fp8tpu.initialize(model, variables, (ids,), training_algo="hybrid",
                            exempt_layers=jbert.BERT_QA_EXEMPT)
    emu = MPTEmulator(model=emu.model,
                      policy=emu.policy.with_output_fused(
                          *jbert.BERT_OUTPUT_FUSED),
                      module_table=emu.module_table,
                      master_fmt=emu.master_fmt)
    opt = optax.adamw(5e-4)

    def loss_fn(apply_fn, params, batch):
        ids, mask, types, starts, ends = batch
        s, e = apply_fn(params, ids, mask, types)
        return (optax.softmax_cross_entropy_with_integer_labels(
            s, starts).mean()
            + optax.softmax_cross_entropy_with_integer_labels(
                e, ends).mean()) / 2

    step = jax.jit(make_train_step(emu, opt, loss_fn))   # as the script
    state = init_train_state(opt, variables)
    v, losses = variables, []
    for i in range(3):
        k = jax.random.fold_in(key, i)
        ids, starts, ends = script.make_batch(jax.random.fold_in(k, 1), bsz,
                                              seq, cfg.vocab_size)
        batch = (ids, jnp.ones_like(ids, jnp.bool_), jnp.zeros_like(ids),
                 starts, ends)
        v, state, loss = step(v, state, batch, k)
        losses.append(float(loss))
    return _np(variables), _np(v), losses


def _finetune_errors():
    """The port's script against the JAX script's 3 steps: (worst relative
    loss gap, worst parameter gap, the updates' relative L2, the share of
    update signs equal, the script's result)."""
    from fp8tpu_torch.examples import bert_qa_finetune
    v0, v3, jlosses = _jax_finetune()
    out = bert_qa_finetune.main(FINETUNE + ["--device", "cpu"],
                                variables=v0)
    loss = float(np.max(np.abs(np.array(out["losses"]) - jlosses)
                        / np.abs(jlosses)))
    before, want = variables_from_flax(v0), variables_from_flax(v3)
    num = den = 0.0
    same = total = 0
    param = 0.0
    for k, p in out["params"].items():
        p = p.detach()
        param = max(param, float((p - want[k]).abs().max()))
        dj, dt = (want[k] - before[k]).double(), (p - before[k]).double()
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
        same += int((torch.sign(dt) == torch.sign(dj)).sum())
        total += dj.numel()
    errs = (loss, param, (num / den) ** 0.5, same / total)
    print("bert_qa_finetune: losses {:.2e}, parameters {:.2e}, updates "
          "{:.2e} relative L2, {:.4f} of signs equal".format(*errs))
    return errs + (out,)


def test_bert_qa_finetune_matches_the_jax_script():
    loss, param, update, sign, out = _finetune_errors()
    tol = FINETUNE_TOL
    assert loss <= tol["loss"], loss
    assert param <= tol["param"], param
    assert update <= tol["update"], update
    assert sign >= tol["sign"], sign
    assert [ln.split(":")[0] for ln in out["lines"]] == [
        "step 0", "final", "eval argmax", "eval beam"]
    for m in out["eval"].values():
        assert 0.0 <= m["exact_match"] <= m["f1"] <= 100.0


def test_bert_qa_finetune_without_an_update_fails(monkeypatch):
    """A planted fault, a script whose optimizer never steps: its updates
    fall outside their limits."""
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    _, _, update, sign, _ = _finetune_errors()
    assert update > FINETUNE_TOL["update"] or sign < FINETUNE_TOL["sign"]
