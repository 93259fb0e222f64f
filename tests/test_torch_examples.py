"""The port's entry-point scripts (``fp8tpu_torch.examples``) at tiny sizes
on ``--device cpu``, each handed the JAX script's own initial weights
through ``main(..., variables=)`` and held to the JAX script's numbers:

- train_fp8: 3 steps of hybrid-gemm + ``--opt8`` in the script's default
  bf16 compute, batches bit-equal to the JAX script's
  ``randint(fold_in(key, step))``; losses, parameters and updates within
  PERF.md §2's bf16 decoder-training limits (1e-2 / 1.5e-2 / 0.35 / 96%,
  tests/test_torch_decoder_training.py); a checkpoint restores the run's
  state bit for bit.
- serve_llm: the ring and paged engines' tokens against the JAX
  ServingEngine's by the margin rule (ROADMAP trap 14); speculation gives
  every request its tokens.
- serve_http: tests/test_http_example.py's checks on the port's server.
- eval_ppl ``--train 0``: the unquantized and e4m3 ppl within PPL_RTOL of
  the JAX script's; with f32 compute the e4m3 model's logits within
  PERF.md §2's PTQ limit (2e-3 of max|logit|).
- bert_squad_ptq: the synthetic tokens bit-equal to the JAX script's, fp32
  start / end logits within 1e-5 and hybrid ones within PTQ_TOL of their
  max, the EM figures and the drift (mean |Δ start-logit|) the JAX
  script's within that gap.
- resnet_ptq, resnet_qat and launch_sweep:
  tests/test_torch_examples_resnet.py; bert_qa_finetune:
  tests/test_torch_bert.py.

Without a CUDA device and without ``--device cpu`` each script raises.
"""

import argparse
import functools
import importlib.util
import json
import os
import re
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fp8tpu_torch.examples import (bert_qa_finetune, bert_squad_ptq,
                                   eval_ppl, launch_sweep, resnet_ptq,
                                   resnet_qat, serve_http, serve_llm,
                                   train_fp8)
from fp8tpu_torch.models import variables_from_flax
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.serve import full_logits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
PTQ_TOL = 2e-3          # of max|logit| (PERF.md §2)
JIT_TOL = 4e-2          # of max|logit|, the margin rule's band


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's port runs.  Tier-1 runs six
    pytest-xdist workers on the machine's cores, and torch's thread pool
    in each then oversubscribes them: a port script's many small ops ran
    up to 12 times slower than alone, and slowed the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# The module kinds whose calls a quantized forward is fed (the JAX run's
# recorded calls, by class name in both packages).
FED = ("Dense", "BatchMatmul", "EltwiseAdd", "LayerNorm", "Embed")


def _fed_jax_calls(monkeypatch, queue, call_err):
    """From here on, each call of a FED module in a quantized forward of
    ``fp8tpu_torch.api`` takes the arguments of the next (path, args,
    output) record of the JAX run in ``queue`` and passes on that record's
    output; ``call_err``, a one-element list, takes the worst gap of the
    two outputs relative to the JAX output's max.  So a free-running gap
    that per-tensor scales amplify (one ulp of a tensor's largest element
    moves every element of its cast) is told from a fault of a call."""
    import fp8tpu_torch.api as api
    make = api.make_quant_interceptor

    def forcing(policy, **kw):
        quant = make(policy, **kw)

        def interceptor(next_fun, args, kwargs, context):
            if type(context.module).__name__ not in FED:
                return quant(next_fun, args, kwargs, context)
            path, jargs, jout = queue.pop(0)
            assert path == context.path, (path, context.path)
            args = tuple(torch.from_numpy(np.asarray(j)).to(
                a.dtype if torch.is_tensor(a) else None)
                for a, j in zip(args, jargs))
            out = quant(next_fun, args, kwargs, context)
            want = torch.from_numpy(np.asarray(jout)).to(out.dtype)
            call_err[0] = max(call_err[0], float(
                (out.float() - want.float()).abs().max()
                / want.float().abs().max()))
            return want
        return interceptor

    monkeypatch.setattr(api, "make_quant_interceptor", forcing)


# -- train_fp8 ------------------------------------------------------------

TRAIN = ["--d-model", "32", "--n-layers", "1", "--batch-size", "2",
         "--seq-len", "16", "--steps", "3", "--opt8"]


@functools.lru_cache(maxsize=None)
def _jax_train():
    """examples/train_fp8.py's setup and loop with TRAIN's flags."""
    from fp8tpu.models import Decoder, DecoderConfig
    from fp8tpu.training import (adamw_8bit, init_train_state, initialize,
                                 make_train_step)
    B, S = 2, 16
    cfg = DecoderConfig(vocab_size=2048, d_model=32, n_layers=1, n_heads=4,
                        n_kv_heads=4, d_ff=96, max_seq_len=S)
    model = Decoder(cfg)
    key = jax.random.key(0)
    tokens = jax.random.randint(jax.random.key(1), (B, S), 0, 2048)
    variables = jax.jit(model.init)(key, tokens)
    emu = initialize(model, variables, (tokens,),
                     training_algo="hybrid-gemm", master_fmt="fp16")
    opt = adamw_8bit(3e-4)

    def loss_fn(apply_fn, params, batch):
        logits = apply_fn(params, batch[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[:, 1:]).mean()

    step = jax.jit(make_train_step(emu, opt, loss_fn))
    state = init_train_state(opt, variables)
    v, losses, batches = variables, [], []
    for i in range(3):
        batch = jax.random.randint(jax.random.fold_in(key, i), (B, S), 0,
                                   2048)
        batches.append(np.asarray(batch))
        v, state, loss = step(v, state, batch, jax.random.fold_in(key, i))
        losses.append(float(loss))
    return _np(variables), _np(v), losses, batches


def test_train_fp8_matches_the_jax_script():
    v0, v3, jlosses, jbatches = _jax_train()
    args = train_fp8.parse(TRAIN + CPU)
    for i, want in enumerate(jbatches):
        got = train_fp8.batch_of(prng.key(0), i, args, 2048, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    out = train_fp8.main(TRAIN + CPU, variables=v0)
    assert [ln.split(":")[0] for ln in out["lines"]] == ["step 0", "final"]
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-2)
    before, want = variables_from_flax(v0), variables_from_flax(v3)
    num = den = 0.0
    same = total = 0
    for k, p in out["params"].items():
        p = p.detach()
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0,
                                   atol=1.5e-2, err_msg=k)
        dj, dt = (want[k] - before[k]).double(), (p - before[k]).double()
        num += float(((dt - dj) ** 2).sum())
        den += float((dj ** 2).sum())
        same += int((torch.sign(dt) == torch.sign(dj)).sum())
        total += dj.numel()
    assert (num / den) ** 0.5 <= 0.35
    assert same / total >= 0.96


@pytest.mark.parametrize("opt8", [True, False], ids=["opt8", "adamw"])
def test_train_fp8_checkpoint_restores_the_state(opt8, tmp_path,
                                                 monkeypatch):
    """The checkpoint of step 2 (the script saves every CHECKPOINT_EVERY
    steps, 25, set to 2 here), restored by --resume-step 2 (no step left
    to run), holds the parameters, moments and loss scale the run ended
    with, bit for bit."""
    monkeypatch.setattr(train_fp8, "CHECKPOINT_EVERY", 2)
    flags = ["--d-model", "32", "--n-layers", "1", "--batch-size", "2",
             "--seq-len", "8", "--emb-fmt", "e4m3", "--checkpoint-dir",
             str(tmp_path)] + CPU + (["--opt8"] if opt8 else [])
    full = train_fp8.main(flags + ["--steps", "3"])
    back = train_fp8.main(flags + ["--steps", "2", "--resume-step", "2"])
    assert back["lines"] == ["resumed from step 2", back["lines"][1]]
    assert back["loss_scale"] == full["loss_scale"]
    for n, p in full["params"].items():
        assert torch.equal(back["params"][n], p), n
    a, b = full["optimizer"], back["optimizer"]
    for n, p in full["params"].items():
        q = back["params"][n]
        for k, t in a.state[p].items():
            u = b.state[q][k]
            if isinstance(t, torch.Tensor):
                assert torch.equal(torch.as_tensor(u).float(),
                                   t.float()), (n, k)
            else:
                assert (u.payload.view(torch.uint8).equal(
                    t.payload.view(torch.uint8))
                    and u.scale.equal(t.scale)), (n, k)


def test_train_fp8_flags_without_a_port_raise():
    """The MoE decoder under a mesh is not ported (ROADMAP §1 item 7d);
    data and model parallelism are, and need a world of their size (one
    process here: tests/test_torch_parallel_dp.py and
    tests/test_torch_parallel_tp.py run them)."""
    with pytest.raises(NotImplementedError, match="item 7d"):
        train_fp8.main(TRAIN + CPU + ["--model-parallel", "2",
                                      "--n-experts", "4"])
    with pytest.raises(ValueError, match="nproc-per-node 2"):
        train_fp8.main(TRAIN + CPU + ["--model-parallel", "2"])
    with pytest.raises(ValueError, match="nproc-per-node 2"):
        train_fp8.main(TRAIN + CPU + ["--data-parallel", "2"])


# -- serve_llm / serve_http -----------------------------------------------

SERVE = ["--d-model", "64", "--n-layers", "2", "--max-seq", "64",
         "--requests", "3", "--max-new-tokens", "5", "--weight-fmt", "e4m3",
         "--slots", "2"]


@functools.lru_cache(maxsize=None)
def _jax_serve():
    """examples/serve_llm.py's model and engine run with SERVE's flags."""
    from fp8tpu.models import Decoder, DecoderConfig
    from fp8tpu.serve import (Request, ServeConfig, ServingEngine,
                              convert_decoder_params)
    cfg = DecoderConfig(vocab_size=4096, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=4, d_ff=192, max_seq_len=64)
    variables = jax.jit(Decoder(cfg).init)(jax.random.key(0),
                                           jnp.ones((1, 8), jnp.int32))
    params = convert_decoder_params(variables, cfg, fmt="e4m3")
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8")
    out = ServingEngine(params, scfg, n_slots=2, max_seq=64).run(
        [Request(uid=i, prompt=list(range(1 + i, 12 + i)),
                 max_new_tokens=5) for i in range(3)])
    return _np(variables), out


def _margin_agree(out, ref, tp, tsc):
    """Equal token lists, or lists that part at a near tie of the port's
    teacher-forced logits; returns how many are equal."""
    assert set(out) == set(ref)
    exact = 0
    for uid, want in ref.items():
        got = out[uid]
        assert len(got) == len(want)
        if got == want:
            exact += 1
            continue
        j = next(i for i in range(len(got)) if got[i] != want[i])
        prompt = list(range(1 + uid, 12 + uid))
        logits = full_logits(tp, torch.tensor(prompt + want[:j],
                                              dtype=torch.int32), tsc)[-1]
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) <= 2 * JIT_TOL * float(
            logits.abs().max())
    return exact


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_serve_llm_tokens_match_the_jax_engine(paged):
    v, jout = _jax_serve()
    flags = SERVE + CPU + (["--paged", "--prefix-cache"] if paged else [])
    out = serve_llm.main(flags, variables=v)
    assert out["lines"][0].startswith("3 requests, 15 tokens in ")
    # --paged walks the pages (K4 on the card); the JAX script's engine
    # reads them through its default gathered ring view
    assert out["cfg"].paged_decode_impl == ("kernel" if paged
                                            else "ringview")
    assert _margin_agree(out["tokens"], jout, out["params"],
                         out["cfg"]) >= 1


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_serve_llm_speculative(paged):
    flags = SERVE + CPU + ["--speculative", "2"] + (
        ["--paged", "--prefix-compute-reuse"] if paged else [])
    out = serve_llm.main(flags)
    want = 3 if paged else 1
    assert len(out["tokens"]) == want
    assert all(len(t) == 5 for t in out["tokens"].values())
    assert "speculative K=2" in out["lines"][0]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _post(port, path, obj, timeout=180):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout).read()


@pytest.fixture(scope="module")
def http_server():
    from http.server import ThreadingHTTPServer
    from itertools import count
    port = _free_port()
    args = argparse.Namespace(port=port, d_model=64, n_layers=2,
                              vocab=128, max_seq=96, slots=2,
                              weight_fmt="e4m3", kv_fmt="e4m3",
                              paged=False, device="cpu")
    srv, engine = serve_http.build_server(args)
    httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                serve_http.make_handler(srv, engine,
                                                        count()))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield port
    httpd.shutdown()
    srv.stop()


def test_http_health_generate_stream_stats(http_server):
    port = http_server
    ok = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/health", timeout=10).read())
    assert ok == {"ok": True}
    out = json.loads(_post(port, "/generate",
                           {"prompt": [1, 2, 3], "max_new_tokens": 6}))
    assert len(out["tokens"]) == 6
    assert len(out["logprobs"]) == 5       # first token is admission's
    assert out["meta"]["n_tokens"] == 6
    raw = _post(port, "/generate", {"prompt": [4, 5],
                                    "max_new_tokens": 5, "stream": True})
    lines = [json.loads(ln) for ln in raw.splitlines()]
    toks = [ln["token"] for ln in lines[:-1]]
    assert toks == lines[-1]["tokens"]
    assert len(toks) == 5
    stats = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=10).read())
    assert stats["n_slots"] == 2


def test_http_oversize_budget_is_400(http_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http_server, "/generate", {"prompt": [1],
                                         "max_new_tokens": 100000},
              timeout=60)
    assert e.value.code == 400


def test_serve_http_main_until():
    """main() serves until the ``until`` callable returns, then stops;
    ``--paged`` serves from the page pool through the page-walk route."""
    def two_requests(port):
        return [json.loads(_post(port, "/generate",
                                 {"prompt": [1 + i, 2], "max_new_tokens": 3}
                                 ))["tokens"] for i in range(2)]
    out = serve_http.main(["--port", str(_free_port()), "--d-model", "64",
                           "--n-layers", "1", "--vocab", "128", "--max-seq",
                           "64", "--slots", "2", "--weight-fmt", "e4m3",
                           "--paged"] + CPU, until=two_requests)
    assert [len(t) for t in out["until"]] == [3, 3]
    assert out["engine"].use_paged
    assert out["engine"].cfg.paged_decode_impl == "kernel"
    assert out["lines"][0].startswith("fp8tpu serving on http://127.0.0.1:")


# -- eval_ppl ----------------------------------------------------------------

PPL = ["--train", "0", "--layers", "1", "--d_model", "64", "--num_seqs",
       "16", "--seq_len", "32", "--dtypes", "e4m3"]


# ppl limits, relative (unquantized, e4m3).  The script's default bf16
# compute rounds to bf16 after other summation orders in each framework,
# and per-tensor e4m3 activation casts turn those steps into e4m3 steps
# (ROADMAP trap 66): measured 8.5e-5 / 7.4e-6, e4m3 logits 5.5e-2 of
# max|logit| apart.  In f32 only summation orders differ: measured 2.5e-7
# / 1.5e-5, e4m3 logits 2.5e-7 of max|logit|, held to PTQ_TOL.  The test
# prints its gaps (run with -s).
PPL_RTOL = {"bfloat16": (1e-3, 1e-3), "float32": (1e-5, 1e-4)}


@functools.lru_cache(maxsize=None)
def _jax_ppl(dtype):
    """examples/eval_ppl.py with PPL's flags: the fp32 ppl and the e4m3
    model's logits."""
    import fp8tpu
    from fp8tpu.data import mixed_lm_corpus
    from fp8tpu.models import Decoder, tiny_config
    script = _jax_script("eval_ppl")
    cfg = tiny_config(n_layers=1, d_model=64, n_heads=8, n_kv_heads=4,
                      d_ff=192, vocab_size=64, max_seq_len=32, dtype=dtype)
    model = Decoder(cfg)
    tokens = jnp.asarray(mixed_lm_corpus(16, 32, 64, seed=777), jnp.int32)
    variables = jax.jit(model.init)(jax.random.key(1), tokens[:1])
    base = script.ppl_of(jax.jit(lambda t: model.apply(variables, t)),
                         tokens)
    qm = fp8tpu.quantize_model(model, variables, (tokens[:1],),
                               dtype="e4m3",
                               calibration_batches=[tokens[:8, :-1]],
                               list_exempt_layers=("embed",))
    qapply = jax.jit(qm.apply)
    return (_np(variables), base, script.ppl_of(qapply, tokens),
            np.asarray(qapply(tokens[:, :-1])), np.asarray(tokens))


@pytest.mark.parametrize("dtype", list(PPL_RTOL))
def test_eval_ppl_matches_the_jax_script(dtype, monkeypatch):
    """The script's decoder (bf16 compute), and the same in f32 (its
    config patched in both packages); the e4m3 model is rebuilt from the
    port's run to compare its logits with the JAX script's."""
    from fp8tpu_torch.models import tiny_config
    v, base, qbase, qlogits, tokens = _jax_ppl(dtype)
    monkeypatch.setattr(eval_ppl, "tiny_config",
                        functools.partial(tiny_config, dtype=dtype))
    out = eval_ppl.main(PPL + CPU, variables=v)
    fp32_tol, e4m3_tol = PPL_RTOL[dtype]
    gaps = (abs(out["ppl"]["fp32"] - base) / base,
            abs(out["ppl"]["e4m3"] - qbase) / qbase)
    assert out["lines"][0].startswith("WARNING: evaluating RANDOM weights")
    from fp8tpu_torch import quantize_model
    toks = torch.from_numpy(tokens).long()
    qm = quantize_model(out["model"], (toks[:1],), dtype="e4m3",
                        calibration_batches=[toks[:8, :-1]],
                        list_exempt_layers=("embed",), device="cpu")
    with torch.no_grad():
        got = qm(toks[:, :-1]).numpy()
    logit_gap = np.abs(got - qlogits).max() / np.abs(qlogits).max()
    print(f"eval_ppl {dtype}: ppl {gaps[0]:.3g}, e4m3 ppl {gaps[1]:.3g}, "
          f"e4m3 logits {logit_gap:.3g} of max|logit|")
    assert gaps[0] <= fp32_tol and gaps[1] <= e4m3_tol
    if dtype == "float32":
        assert logit_gap <= PTQ_TOL


def test_eval_ppl_trains_and_reads_a_checkpoint(tmp_path):
    from fp8tpu_torch.models import variables_to_flax
    from fp8tpu_torch.quant.interceptor import build_module_table
    from fp8tpu_torch.utils import save_checkpoint
    flags = ["--layers", "1", "--d_model", "32", "--num_seqs", "8",
             "--seq_len", "16", "--dtypes", "e4m3"] + CPU
    out = eval_ppl.main(flags + ["--train", "4"])
    assert [ln.split()[0] for ln in out["lines"][:4]] == ["train"] * 4
    model = out["model"]
    save_checkpoint(str(tmp_path), 4, variables_to_flax(
        dict(model.named_parameters()), build_module_table(model)))
    back = eval_ppl.main(flags + ["--train", "0", "--ckpt", str(tmp_path),
                                  "4"])
    assert back["lines"][0] == f"loaded checkpoint {tmp_path} step 4"
    assert back["ppl"] == out["ppl"]


# -- bert_squad_ptq --------------------------------------------------------

SQUAD = ["--num_samples", "16", "--seq_len", "64"]


@functools.lru_cache(maxsize=None)
def _jax_squad():
    """examples/bert_squad_ptq.py with SQUAD's flags: the initial
    variables, the tokens, both logits, EM figures and the drift."""
    import fp8tpu
    from fp8tpu.models.bert import (BERT_OUTPUT_FUSED, BERT_QA_EXEMPT,
                                    BertForQA, tiny_bert)
    script = _jax_script("bert_squad_ptq")
    cfg = tiny_bert(n_layers=2)
    model = BertForQA(cfg)
    ids = jax.random.randint(jax.random.key(0), (16, 64), 0, cfg.vocab_size,
                             jnp.int32)
    mask = jnp.ones_like(ids)
    start = jax.random.randint(jax.random.key(1), (16,), 0, 64)
    end = start + 1
    v = jax.jit(model.init)(jax.random.key(2), ids[:1], mask[:1])
    s0, e0 = jax.jit(model.apply)(v, ids, mask)
    qm = fp8tpu.quantize_model(
        model, v, (ids[:1], mask[:1]), dtype="hybrid",
        calibration_batches=[(ids[:16], mask[:16])],
        list_exempt_layers=BERT_QA_EXEMPT,
        list_layers_output_fused=BERT_OUTPUT_FUSED)
    calls = []

    def spy(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and \
                type(context.module).__name__ in FED:
            calls.append(("/".join(context.module.path),
                          [np.asarray(a) for a in args], np.asarray(out)))
        return out

    import flax.linen as nn
    with nn.intercept_methods(spy):         # un-jitted, to record the calls
        s1, e1 = qm.apply(ids, mask)
    js1, _ = jax.jit(qm.apply)(ids, mask)
    print("bert_squad_ptq: the JAX script's hybrid start logits jitted vs "
          f"un-jitted {float(jnp.abs(js1 - s1).max() / jnp.abs(s1).max()):.3e}"
          " of max|logit|")
    em = {"fp32": script.exact_match(s0, e0, start, end),
          "hybrid": script.exact_match(s1, e1, start, end)}
    return (_np(v), np.asarray(ids), _np({"fp32": (s0, e0),
                                           "hybrid": (s1, e1)}), em,
            float(jnp.mean(jnp.abs(s1 - s0))), calls)


def test_bert_squad_ptq_matches_the_jax_script(monkeypatch):
    """The fp32 logits (which no call feeding touches) within 1e-5 of their
    max.  Free running, the hybrid forward parts by per-tensor scales
    (_fed_jax_calls; the JAX script jitted parts from itself un-jitted
    alike, and the test prints by how much), so it is held call by call
    against the un-jitted JAX forward, each call of every Dense,
    BatchMatmul, residual add, LayerNorm and Embed fed the JAX call's
    arguments, within PTQ_TOL; fed, the logits, EM figures and drift are
    that forward's."""
    v, ids, logits, em, drift, calls = _jax_squad()
    args = bert_squad_ptq.parse(SQUAD + CPU)
    got_ids = bert_squad_ptq.load_inputs(args, 1024, "cpu")[0]
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    queue, err = list(calls), [0.0]
    _fed_jax_calls(monkeypatch, queue, err)
    out = bert_squad_ptq.main(SQUAD + CPU, variables=v)
    for got, want in zip(out["logits"]["fp32"], logits["fp32"]):
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert not queue
    print(f"bert_squad_ptq: fed calls within {err[0]:.3e} of their max")
    assert err[0] <= PTQ_TOL, err[0]
    for got, want in zip(out["logits"]["hybrid"], logits["hybrid"]):
        np.testing.assert_array_equal(got.numpy(), want)
    assert out["em"] == em
    assert abs(out["drift"] - drift) <= 1e-5 * np.abs(logits["fp32"][0]).max()
    assert out["lines"][0].startswith("fp32 EM ")


# -- the device flag ------------------------------------------------------

@pytest.mark.parametrize("script", [train_fp8, serve_llm, serve_http,
                                    eval_ppl, resnet_ptq, resnet_qat,
                                    launch_sweep, bert_squad_ptq,
                                    bert_qa_finetune],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_scripts_need_a_card_or_device_cpu(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        script.main([])


def test_flags_mirror_the_jax_scripts():
    """Each port script takes every flag of its JAX script (and --device)."""
    for name, mod in (("train_fp8", train_fp8), ("serve_llm", serve_llm),
                      ("eval_ppl", eval_ppl), ("resnet_ptq", resnet_ptq),
                      ("resnet_qat", resnet_qat), ("serve_http", serve_http),
                      ("launch_sweep", launch_sweep),
                      ("bert_squad_ptq", bert_squad_ptq),
                      ("bert_qa_finetune", bert_qa_finetune)):
        with open(os.path.join(REPO, "examples", f"{name}.py")) as f:
            src = f.read()
        want = set(re.findall(r"add_argument\(\s*\"(--[\w-]+)\"", src))
        got = set(vars(mod.parse(CPU)))
        assert {f[2:].replace("-", "_") for f in want} <= got, name
        assert "device" in got
