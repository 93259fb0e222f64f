"""Tensor parallelism inside the port's decoder against the JAX package,
on the CPU: the TP-sharded PTQ forward (``quantized_apply(mesh=)`` on
``models.Decoder(cfg, mesh=)``) and the TP-sharded serving engine, ring
and self-draft speculative paged (``ServingEngine(mesh=)``).

Everything that issues collectives runs in one world of eight gloo ranks,
spawned once for this file as ``tests/test_torch_parallel.py`` spawns its
own: each rank is this file run as a script (torch and the port only,
never JAX), every collective has a 60 s process-group timeout, and each
rank writes its results to an npz.  The single-process references and
the JAX package's runs (on the conftest's eight virtual CPU devices)
happen in the pytest process meanwhile.
Parameters and tokens come from numpy seeds; the configurations are the
JAX tests' own (``tests/test_parallel.py``'s decoder, ``tests/
test_engine_sharded.py``'s engine).

Limits (PERF.md §2, the TP rows):

- 7a, data 2 x model 4, e4m3 PTQ: each rank's quantized weight shards
  bit-equal to its slices of the JAX package's quantized weights; the
  logits against JAX's sharded and unsharded forward by the JAX test's
  gates (correlation > 0.998, argmax agreement > 0.95) on the JAX test's
  tokens (all ones), and on drawn tokens (where JAX's own sharded forward
  reads 0.99772 / 0.906 against its unsharded one, trap 66) no farther
  from JAX than JAX's sharded forward is; against the
  port's single-process forward within 2e-3 of max|logit| (measured: bit
  for bit, 0.0; a row-parallel sum rounded another way could carry an
  e4m3 tie, trap 66, so the limit is the call-by-call one); call by call
  (every Dense / BatchMatmul / Embed call fed the rank's shard of the
  single-process call's arguments) the quantized inputs and weights bit
  for bit and the outputs within 2e-3 of max|out|; a rank-local amax on a
  row-parallel input and a rank-local per-row scale on a column-parallel
  kernel each fail that check.
- 7b: the ring engine over data 2 x model 4 and the self-draft paged
  engine over model 8 (k_spec 3; the ring view on the JAX test's random
  artifact, K4's page walk on the drawn model) give the
  port's single-process engines' tokens, greedy and sampled, on every
  rank alike, with the single-process engine's speculation counts
  (``spec_accepted == spec_drafted`` on the JAX test's own random
  artifact), and JAX's
  single-device engines' tokens by the margin rule (where they part, the
  top-2 margin of the port's teacher-forced logits is within twice 4e-2
  of max|logit|, as ``tests/test_torch_engine.py``); ``decode_step`` over
  data 2 x model 2 (the decoder config, two hosts of it) and data 2 x
  model 4 (the engine config) within 4e-3 of max|logit| of the unsharded
  step (trap 15's un-jitted limit; measured: bit for bit).
- The casts of a split tensor (every scaling kind; rows over data, columns
  over model, or both): the whole tensor's cast, bit for bit, on a 1/8 grid
  where every sum is exact; fine-grained, per-block and integer scaling of
  a model-split tensor raise.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

WORLD = 8
TIMEOUT = 120          # seconds for the whole world, start to finish
PG_TIMEOUT = 60        # seconds for any one collective
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# tests/test_parallel.py's decoder and tests/test_engine_sharded.py's engine
DEC = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab_size=256, max_seq_len=32)
ENG = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
           vocab_size=128, max_seq_len=96)
DATA, MODEL = 2, 4               # 7a's mesh and the ring engine's
LOGIT_TOL = 2e-3                 # of max|logit| / max|out|
STEP_TOL = 4e-3                  # decode_step, of max|logit|
MARGIN_TOL = 4e-2                # the margin rule's logit tolerance
N_REQ, NEW, TEMP = 3, 6, 0.8
TOKENS = ("ones", "draw")
PLANTS = ("row-input-local-amax", "column-kernel-local-row-scale")
# the casts of a split tensor: (8, 64) on a 1/8 grid (every sum exact),
# its rows over the data group, its columns over the model group, or both
CASTS = {"per-tensor": dict(scaling="per-tensor"),
         "per-tensor-mean": dict(scaling="per-tensor-mean"),
         "per-channel-rows": dict(scaling="per-channel"),
         "per-channel-cols": dict(scaling="per-channel", channel_axis=1),
         "per-channel-mean": dict(scaling="per-channel-mean"),
         "int8": dict(dtype="int8"),
         "fine-grained": dict(scaling="fine-grained", group_size=4),
         "per-block": dict(scaling="per-block", block_size=32)}
SPLITS = ("batch-shard", "data", "model", "data-and-model")
RAISES_MODEL_SPLIT = ("int8", "fine-grained", "per-block")
STEP_MESHES = {"data2-model2": (DEC, dict(hosts=2, data=2, model=2)),
               "data2-model4": (ENG, dict(data=2, model=4))}


# -- inputs, the same in the workers and the parent -------------------------

def flax_vars(kw, seed):
    """A Flax decoder's variables (``params`` only) drawn with numpy: Dense
    kernels (in, out) at 1/sqrt(in), the embedding at 1/sqrt(d_model), the
    norms' scales about 1."""
    rng = np.random.default_rng(seed)
    dm, ff, V = kw["d_model"], kw["d_ff"], kw["vocab_size"]
    D = dm // kw["n_heads"]
    hd, kvd = kw["n_heads"] * D, kw["n_kv_heads"] * D

    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    def scale():
        return (1 + 0.1 * rng.standard_normal(dm)).astype(np.float32)

    p = {"embed": {"embedding": (rng.standard_normal((V, dm))
                                 / np.sqrt(dm)).astype(np.float32)}}
    for i in range(kw["n_layers"]):
        p[f"layer_{i}"] = {
            "attn_norm": {"scale": scale()},
            "attn": {"q_proj": {"kernel": w(dm, hd)},
                     "k_proj": {"kernel": w(dm, kvd)},
                     "v_proj": {"kernel": w(dm, kvd)},
                     "o_proj": {"kernel": w(hd, dm)}},
            "mlp_norm": {"scale": scale()},
            "mlp": {"gate_proj": {"kernel": w(dm, ff)},
                    "up_proj": {"kernel": w(dm, ff)},
                    "down_proj": {"kernel": w(ff, dm)}}}
    p["final_norm"] = {"scale": scale()}
    return {"params": p}


def dec_tokens(which="draw"):
    """tests/test_parallel.py's tokens (all ones), or a draw."""
    if which == "ones":
        return np.ones((4, 16), np.int32)
    return np.random.default_rng(7).integers(
        0, DEC["vocab_size"], (4, 16)).astype(np.int32)


def requests(temperature=0.0):
    """tests/test_engine_sharded.py's requests (greedy, or sampled)."""
    from fp8tpu_torch.serve import Request
    return [Request(uid=i, prompt=[2 + i, 7, 11], max_new_tokens=NEW,
                    temperature=temperature) for i in range(N_REQ)]


def torch_cfg(kw):
    from fp8tpu_torch.models import tiny_config
    return tiny_config(**kw)


def serve_params(kw, seed):
    """The port's e4m3 serving artifact of ``flax_vars(kw, seed)``."""
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.serve import convert_decoder_params
    return convert_decoder_params(variables_from_flax(flax_vars(kw, seed)),
                                  torch_cfg(kw))


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _tokens(out):
    return np.array([out[i] for i in range(N_REQ)], np.int64)


# -- the worker: 7a ---------------------------------------------------------

def _records(model, params, toks, mesh, feed=None):
    """Every Dense / BatchMatmul / Embed call of a quantized forward of
    ``model`` (e4m3 PTQ, the weights in ``params`` already quantized): its
    path, arguments, quantized inputs (what the module body received), the
    module's weight as bound, and its output.  ``feed(path, args)`` may
    replace a call's arguments before the casts."""
    from torch.func import functional_call
    from fp8tpu_torch import linen
    from fp8tpu_torch.quant.interceptor import (classify_module,
                                                make_quant_interceptor)
    from fp8tpu_torch.quant.policy import LayerKind, e4m3_inference_policy
    quant = make_quant_interceptor(e4m3_inference_policy(), mesh=mesh)
    kinds = (LayerKind.DENSE, LayerKind.BATCH_MATMUL, LayerKind.EMBED)
    calls = []

    def outer(next_fun, args, kwargs, ctx):
        if classify_module(ctx.module) not in kinds:
            return quant(next_fun, args, kwargs, ctx)
        if feed is not None:
            args = feed(ctx, args)
        rec = {"path": ctx.path, "module": ctx.module, "args": args}

        def body(*a, **kw):
            rec["q"] = list(a)
            w = getattr(ctx.module, "weight", None)
            if w is not None:
                rec["q"].append(w.detach().clone())
            return next_fun(*a, **kw)

        rec["out"] = quant(body, args, kwargs, ctx)
        calls.append(rec)
        return rec["out"]

    with torch.no_grad(), linen.intercept_methods(outer, model):
        logits = functional_call(model, params, (toks,))
    return calls, logits


def _shard_of(t, module, which, d, b, m, T):
    """The rank's block of a single-process tensor of a call: its rows of
    the batch, and its block of the dimension ``module`` says is split over
    the model group (``which``: "in", "out" or "weight", the torch weight's
    split dimension)."""
    if which == "weight":
        dim = getattr(module, "tp_weight", None)
        if dim is None:
            return t
        dim = 1 - dim                 # the Flax dimension -> the torch one
    else:
        if t.dtype.is_floating_point or t.ndim:
            t = t[d * b:(d + 1) * b]
        dim = getattr(module, "tp_" + which, None)
        if dim is None:
            return t
    n = t.shape[dim] // T
    return t.narrow(dim, m * n, n)


def _bits_differ(a, b) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.dtype.is_floating_point:
        a, b = a.float(), b.float()
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return int((a != b).sum())


def _call_check(single, sp, fed, T, d, b, m):
    """(differing bits of the quantized inputs and weights, the worst
    output error over LOGIT_TOL * max|out|) of the fed TP calls against
    the rank's shards of the single-process calls."""
    assert [c["path"] for c in fed] == [c["path"] for c in single]
    bad, worst = 0, 0.0
    for c, s in zip(fed, single):
        mod = c["module"]
        for i, (got, want) in enumerate(zip(c["q"], s["q"])):
            which = "weight" if i == len(c["q"]) - 1 and \
                hasattr(mod, "weight") else "in"
            if want.dtype == torch.int64 or not want.is_floating_point():
                which = "in"
            bad += _bits_differ(got, _shard_of(want, mod, which, d, b, m, T))
        want = _shard_of(s["out"], mod, "out", d, b, m, T).float()
        err = float((c["out"].float() - want).abs().max())
        worst = max(worst, err / (LOGIT_TOL * float(want.abs().max())))
    return bad, worst


def _worker_7a(rank, res):
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.models.transformer import Decoder
    from fp8tpu_torch.parallel import (DECODER_PARAM_RULES, local_shards,
                                       make_mesh)
    from fp8tpu_torch.parallel.data import TensorShard
    from fp8tpu_torch.quant import interceptor as icp
    from fp8tpu_torch.quant.policy import e4m3_inference_policy
    cfg = torch_cfg(DEC)
    pol = e4m3_inference_policy()
    sd = variables_from_flax(flax_vars(DEC, 0))
    toks = torch.from_numpy(dec_tokens()).to(torch.int64)
    mesh = make_mesh(data=DATA, model=MODEL)
    d, m = mesh.index("data"), mesh.index("model")
    b = toks.shape[0] // DATA

    full = Decoder(cfg)
    table = icp.build_module_table(full)
    tpm = Decoder(cfg, mesh=mesh)
    local = local_shards(sd, mesh, DECODER_PARAM_RULES, table)
    shards = icp.weight_shards(tpm, mesh)
    wq = icp.quantize_params(local, pol, table, None, shards)
    for name, t in wq.items():
        res[f"7a/wq/{name}"] = _np(t)
    for which in TOKENS:
        t = torch.from_numpy(dec_tokens(which)).to(torch.int64)
        with torch.no_grad():
            res[f"7a/logits/{which}"] = _np(icp.quantized_apply(
                tpm, pol, t[d * b:(d + 1) * b], params=local, mesh=mesh))
            if rank == 0:
                res[f"7a/single/{which}"] = _np(icp.quantized_apply(
                    full, pol, t, params=sd))

    # call by call: each TP call fed the rank's shard of the single call's
    # arguments
    single, _ = _records(full, icp.quantize_params(sd, pol, table), toks,
                         None)
    by_path = {c["path"]: c for c in single}

    def feed(ctx, args):
        s = by_path[ctx.path]
        return tuple(_shard_of(a, ctx.module, "in", d, b, m, MODEL)
                     for a in s["args"])

    fed, _ = _records(tpm, wq, toks[d * b:(d + 1) * b], mesh, feed)
    res["7a/calls"] = np.array(_call_check(single, sd, fed, MODEL, d, b, m))
    res["7a/ncalls"] = np.array(len(fed))

    # the planted faults, each through the same check
    real = icp.fake_quant

    def row_local(t, cfg_, key=None, shard=None):
        if isinstance(shard, TensorShard) and shard.model_dim == -1:
            shard = TensorShard(shard.data, None)
        return real(t, cfg_, key, shard)

    icp.fake_quant = row_local
    try:
        fed, _ = _records(tpm, wq, toks[d * b:(d + 1) * b], mesh, feed)
    finally:
        icp.fake_quant = real
    res["7a/plant/row-input-local-amax"] = np.array(
        _call_check(single, sd, fed, MODEL, d, b, m))
    cols = {n: s for n, s in shards.items() if s.model_dim != 1}
    wq_bad = icp.quantize_params(local, pol, table, None, cols)
    fed, _ = _records(tpm, wq_bad, toks[d * b:(d + 1) * b], mesh, feed)
    res["7a/plant/column-kernel-local-row-scale"] = np.array(
        _call_check(single, sd, fed, MODEL, d, b, m))

    # GSPMD's cut of a bf16 Dense: bf16 partials, summed and rounded again
    from fp8tpu_torch.models import transformer
    from fp8tpu_torch._device import full_fp32

    def bf16_partials(self, x):
        with full_fp32():
            part = torch.nn.functional.linear(x.to(self.dtype),
                                              self.weight.to(self.dtype))
        return self.tp.sum(part, part.dtype)

    real_fwd = transformer.RowDense.forward
    transformer.RowDense.forward = bf16_partials
    try:
        t = torch.from_numpy(dec_tokens()).to(torch.int64)
        with torch.no_grad():
            res["7a/logits/bf16-partials"] = _np(icp.quantized_apply(
                tpm, pol, t[d * b:(d + 1) * b], params=local, mesh=mesh))
    finally:
        transformer.RowDense.forward = real_fwd


# -- the worker: 7b ---------------------------------------------------------

def _engine(params, scfg, mesh=None, **kw):
    from fp8tpu_torch.serve import ServingEngine
    return ServingEngine(params, scfg, n_slots=2, max_seq=96, device="cpu",
                         mesh=mesh, **kw)


def _spec_kw(params, scfg):
    return dict(use_paged=True, page_size=8, draft_params=params,
                draft_cfg=scfg, k_spec=3)


def engine_runs(res, ring_mesh=None, spec_mesh=None):
    """The 7b engines' tokens (and speculation counts) into ``res``: the
    ring engine greedy and sampled; the self-draft paged engine on the JAX
    test's random artifact and, with K4's page walk, on the drawn model,
    greedy and sampled.  Over the meshes in the world, in one process in
    the parent (the references)."""
    import dataclasses
    from fp8tpu_torch.serve import ServeConfig, random_serve_params
    params = serve_params(ENG, 1)
    scfg = ServeConfig(model=torch_cfg(ENG))
    for temp in (0.0, TEMP):
        res[f"7b/ring/{temp}"] = _tokens(_engine(
            params, scfg, ring_mesh, chunk_size=8).run(requests(temp)))
    # tests/test_engine_sharded.py's artifact: random payloads at 0.02
    # (every token the same, so a self-draft accepts every draft)
    rand = random_serve_params(scfg.model, "e4m3", device="cpu")
    eng = _engine(rand, scfg, spec_mesh, **_spec_kw(rand, scfg))
    res["7b/spec/random"] = _tokens(eng.run(requests()))
    res["7b/spec/random/counts"] = np.array([eng.spec_accepted,
                                             eng.spec_drafted])
    if spec_mesh is None:
        res["7b/paged/random"] = _tokens(_engine(
            rand, scfg, use_paged=True, page_size=8, chunk_size=8).run(
            requests()))
    c = dataclasses.replace(scfg, paged_decode_impl="kernel")
    for temp in (0.0, TEMP):
        eng = _engine(params, c, spec_mesh, **_spec_kw(params, c))
        res[f"7b/spec/{temp}"] = _tokens(eng.run(requests(temp)))
        res[f"7b/spec/{temp}/counts"] = np.array([eng.spec_accepted,
                                                 eng.spec_drafted])


def _worker_7b(rank, res):
    from fp8tpu_torch.parallel import make_mesh
    engine_runs(res, make_mesh(data=DATA, model=MODEL),
                make_mesh(model=WORLD))


def _worker_step(rank, res):
    """decode_step over a mesh against the unsharded step, from a ring that
    four slots' prompts were prefilled into."""
    from fp8tpu_torch.parallel import make_mesh
    from fp8tpu_torch.serve import (ServeConfig, decode_step, full_logits,
                                    prefill, shard_serve_params)
    from fp8tpu_torch.serve.kv_cache import RingKVCache
    from fp8tpu_torch.serve.model import local_heads
    for case, (kw, shape) in STEP_MESHES.items():
        cfg = torch_cfg(kw)
        scfg = ServeConfig(model=cfg)
        params = serve_params(kw, 2)
        mesh = make_mesh(**shape)
        sp = shard_serve_params(params, scfg, mesh)
        prompts = np.random.default_rng(3).integers(
            0, kw["vocab_size"], (4, 5)).astype(np.int32)
        logits = []
        for p in (params, sp):
            ring = RingKVCache.create(cfg.n_layers, 4, 32,
                                      local_heads(p, cfg)[1], cfg.head_dim,
                                      "e4m3", device="cpu")
            for s in range(4):
                _, ring = prefill(p, ring, torch.from_numpy(prompts[s]), s,
                                  5 - s % 2, scfg)
            toks = torch.from_numpy(prompts[:, -1].copy())
            pos = torch.tensor([5 - s % 2 for s in range(4)],
                               dtype=torch.int32)
            out, _ = decode_step(p, ring, toks, pos, scfg)
            logits.append(_np(out))
        res[f"step/{case}"] = np.stack(logits)
        seq = torch.from_numpy(prompts[0].copy())
        res[f"full/{case}"] = np.stack([_np(full_logits(p, seq, scfg))
                                        for p in (params, sp)])


def _worker_casts(rank, res):
    """Each CASTS config on the rank's block of a split tensor, against the
    block of the whole tensor's cast: differing elements, or -1 where the
    cast raises NotImplementedError."""
    from fp8tpu_torch.parallel import make_mesh
    from fp8tpu_torch.parallel.data import BatchShard, TensorShard
    from fp8tpu_torch.quant.config import TensorQuantConfig
    from fp8tpu_torch.quant.fakequant import fake_quant
    mesh = make_mesh(data=DATA, model=MODEL)
    d, m = mesh.index("data"), mesh.index("model")
    data = BatchShard.of(mesh.group("data"))
    model = BatchShard.of(mesh.group("model"))
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -64, 65, (8, 64)).astype(np.float32) / 8)
    rows, cols = slice(d * 4, d * 4 + 4), slice(m * 16, m * 16 + 16)
    for name, kw in CASTS.items():
        cfg = TensorQuantConfig(**{"dtype": "e4m3", **kw})
        want = fake_quant(x, cfg)
        for split in SPLITS:
            r = slice(None) if split == "model" else rows
            c = cols if "model" in split else slice(None)
            shard = data if split == "batch-shard" else TensorShard(
                None if split == "model" else data,
                model if "model" in split else None, 1)
            try:
                got = fake_quant(x[r, c].contiguous(), cfg, None, shard)
                res[f"cast/{name}/{split}"] = np.array(
                    _bits_differ(got, want[r, c].contiguous()))
            except NotImplementedError:
                res[f"cast/{name}/{split}"] = np.array(-1)


def _worker(rank, world, port, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from fp8tpu_torch.parallel import init_world
    init_world("cpu", rank, world, f"tcp://localhost:{port}",
               timeout=PG_TIMEOUT)
    res = {}
    for part in (_worker_casts, _worker_7a, _worker_7b, _worker_step):
        part(rank, res)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


# -- the world ------------------------------------------------------------------

class World:
    """``WORLD`` ranks of this file run as a script, started at once;
    ``results()`` waits for them (``TIMEOUT`` seconds from the start, then
    every rank is killed and the test fails) and loads their npz files."""

    def __init__(self, out):
        from fp8tpu_torch.parallel.mesh import free_port
        self.out, self.t0 = str(out), time.monotonic()
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
             str(port), self.out], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        self._res = None

    def results(self):
        if self._res is None:
            logs = []
            for p in self.procs:
                left = TIMEOUT - (time.monotonic() - self.t0)
                try:
                    logs.append(p.communicate(timeout=max(left, 1))[0])
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"the world of {WORLD} ranks ran past "
                                f"{TIMEOUT} s")
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            self._res = [dict(np.load(os.path.join(self.out,
                                                   f"rank{r}.npz")))
                         for r in range(WORLD)]
        return self._res

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Started before the file's first test; the single-process engines'
    references (``refs``) are made here while the ranks run, and the JAX
    references after."""
    w = World(tmp_path_factory.mktemp("world"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w.refs = {}
        engine_runs(w.refs)
    finally:
        torch.set_num_threads(threads)
    yield w
    w.kill()


# -- the JAX side ----------------------------------------------------------------

def _jax_tree(v):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, v)


_JAX = {}


def jax_7a():
    """The JAX package's quantized weights and its sharded (data 2 x model
    4, GSPMD) and unsharded forwards of tests/test_parallel.py."""
    if not _JAX:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from fp8tpu.models import Decoder, tiny_config
        from fp8tpu.parallel import (DECODER_PARAM_RULES, make_mesh,
                                     shard_params)
        from fp8tpu.quant.interceptor import (build_module_table,
                                              quantize_params,
                                              quantized_apply)
        from fp8tpu.quant.policy import e4m3_inference_policy
        m = Decoder(tiny_config(**DEC))
        v = _jax_tree(flax_vars(DEC, 0))
        pol = e4m3_inference_policy()
        table = build_module_table(m, v, jax.numpy.asarray(dec_tokens()))
        _JAX["wq"] = jax.tree.map(np.asarray,
                                  quantize_params(v, pol, table, None))

        @jax.jit
        def f(vv, t):
            return quantized_apply(m, pol, vv, t, module_table=table)

        mesh = make_mesh(data=DATA, model=MODEL)
        for which in TOKENS:
            toks = jax.numpy.asarray(dec_tokens(which))
            with mesh:
                _JAX[f"sharded/{which}"] = np.asarray(f(
                    shard_params(v, mesh, DECODER_PARAM_RULES),
                    jax.device_put(toks, NamedSharding(mesh,
                                                       P("data", None)))))
            _JAX[f"unsharded/{which}"] = np.asarray(f(v, toks))
    return _JAX


def _jax_engine_tokens(paged: bool):
    """tests/test_engine_sharded.py's single-device engine on the same
    artifact (the JAX package's own conversion of the same draw)."""
    key = f"engine/{paged}"
    if key not in _JAX:
        from fp8tpu.models import tiny_config
        from fp8tpu.serve import Request, ServeConfig, ServingEngine
        from fp8tpu.serve import convert_decoder_params
        cfg = tiny_config(**ENG)
        params = convert_decoder_params(_jax_tree(flax_vars(ENG, 1)), cfg)
        kw = dict(use_paged=True, page_size=8) if paged else {}
        out = ServingEngine(params, ServeConfig(model=cfg), n_slots=2,
                            max_seq=96, chunk_size=8, **kw).run(
            [Request(uid=i, prompt=[2 + i, 7, 11], max_new_tokens=NEW)
             for i in range(N_REQ)])
        _JAX[key] = _tokens(out)
    return _JAX[key]


# -- 7a: the TP-sharded PTQ forward --------------------------------------------

def _coords(r):
    return r // MODEL, r % MODEL


def test_7a_weight_shards_bit_equal_to_jax(world):
    """Each rank's quantized weights (column shards scaled per input row
    with the model group's MAX) are its slices of the JAX package's."""
    from fp8tpu_torch.models import variables_from_flax
    from fp8tpu_torch.models.transformer import Decoder
    from fp8tpu_torch.parallel import (DECODER_PARAM_RULES, make_mesh,
                                       shard_tree)
    from fp8tpu_torch.quant.interceptor import build_module_table
    res = world.results()
    want = variables_from_flax(jax_7a()["wq"])
    specs = shard_tree(want, make_mesh(data=DATA, model=MODEL),
                       DECODER_PARAM_RULES,
                       build_module_table(Decoder(torch_cfg(DEC))))
    split = 0
    for r in range(WORLD):
        _, m = _coords(r)
        for name, full in want.items():
            t = full.numpy()
            for dim, part in enumerate(specs[name].spec):
                if part == "model":
                    n = t.shape[dim] // MODEL
                    t = np.take(t, range(m * n, (m + 1) * n), axis=dim)
                    split += r == 0
            got = res[r][f"7a/wq/{name}"]
            assert got.shape == t.shape, name
            np.testing.assert_array_equal(got.view(np.int32),
                                          t.view(np.int32), err_msg=name)
    assert split == 1 + 2 * 7      # the embedding, 7 kernels a layer


def _tp_logits(res, which):
    """The ranks' rows of the batch, from model index 0 of each data group;
    every rank of a model group must hold the same logits."""
    key = f"7a/logits/{which}"
    for r in range(WORLD):
        d, _ = _coords(r)
        np.testing.assert_array_equal(res[r][key], res[d * MODEL][key])
    return np.concatenate([res[d * MODEL][key] for d in range(DATA)])


def _gates(o, r):
    return (float(np.corrcoef(o.ravel(), r.ravel())[0, 1]),
            float((o.argmax(-1) == r.argmax(-1)).mean()))


@pytest.mark.parametrize("which", ["sharded", "unsharded"])
def test_7a_logits_meet_the_jax_gates(world, which):
    """tests/test_parallel.py's tokens: the JAX test's own gates."""
    corr, agree = _gates(_tp_logits(world.results(), "ones"),
                         jax_7a()[f"{which}/ones"])
    print(f"7a against JAX's {which} forward: corr {corr:.6f}, argmax "
          f"agreement {agree:.4f}")
    assert corr > 0.998, corr
    assert agree > 0.95, agree


@pytest.mark.parametrize("which", ["sharded", "unsharded"])
def test_7a_logits_within_the_jax_package_s_own_spread(world, which):
    """Drawn tokens, where per-tensor e4m3 casts of bf16 activations
    amplify summation order (trap 66): JAX's own GSPMD forward reads
    correlation 0.99772 and argmax agreement 0.906 against its unsharded
    forward here, below the JAX test's gates.  The port may lie no farther
    from JAX's forward than that: correlation within 1e-3 of JAX's own
    sharded-against-unsharded reading, argmax agreement within 1/16."""
    j = jax_7a()
    corr, agree = _gates(_tp_logits(world.results(), "draw"),
                         j[f"{which}/draw"])
    own_corr, own_agree = _gates(j["sharded/draw"], j["unsharded/draw"])
    print(f"7a (drawn tokens) against JAX's {which} forward: corr "
          f"{corr:.6f}, argmax agreement {agree:.4f}; JAX's sharded "
          f"against its unsharded forward {own_corr:.6f} / {own_agree:.4f}")
    assert corr >= own_corr - 1e-3, (corr, own_corr)
    assert agree >= own_agree - 1 / 16, (agree, own_agree)


def test_7a_bf16_partials_part_from_the_single_process_forward(world):
    """Trap 88: the row-parallel products as bf16 partials (GSPMD's cut of a
    bf16 dot), summed and rounded again, leave the single-process forward
    by far more than the f32 partials the port sums (bit-equal above)."""
    res = world.results()
    o = _tp_logits(res, "bf16-partials")
    r = res[0]["7a/single/draw"]
    rel = float(np.abs(o - r).max() / np.abs(r).max())
    print(f"bf16 partials against the single-process forward: {rel:.3e} of "
          f"max|logit|, argmax agreement {_gates(o, r)[1]:.4f}")
    assert rel > 10 * LOGIT_TOL


@pytest.mark.parametrize("which", TOKENS)
def test_7a_logits_against_the_single_process_forward(world, which):
    res = world.results()
    o, r = _tp_logits(res, which), res[0][f"7a/single/{which}"]
    rel = float(np.abs(o - r).max() / np.abs(r).max())
    print(f"7a against the port's single-process forward: {rel:.3e} of "
          f"max|logit| (limit {LOGIT_TOL}), {int((o != r).sum())} of "
          f"{o.size} logits differ")
    assert rel <= LOGIT_TOL


def test_7a_call_by_call(world):
    """Every Dense / BatchMatmul / Embed call fed the rank's shard of the
    single-process call's arguments: quantized inputs and weights bit for
    bit, outputs within 2e-3 of max|out|."""
    for r, res in enumerate(world.results()):
        bad, worst = res["7a/calls"]
        print(f"rank {r}: {int(res['7a/ncalls'])} calls, {int(bad)} bits "
              f"of quantized inputs differ, worst output error "
              f"{worst:.3e} of the limit")
        assert int(res["7a/ncalls"]) == 1 + DEC["n_layers"] * 9
        assert bad == 0, (r, bad)
        assert worst <= 1.0, (r, worst)


@pytest.mark.parametrize("plant", PLANTS)
def test_7a_planted_fault_fails_the_call_check(world, plant):
    """A rank-local amax on a row-parallel input, or a rank-local per-row
    scale on a column-parallel kernel: the call-by-call check fails."""
    failed = [r for r, res in enumerate(world.results())
              if res[f"7a/plant/{plant}"][0] > 0
              or res[f"7a/plant/{plant}"][1] > 1.0]
    print(f"{plant}: the call check fails on ranks {failed}; bits "
          f"differing / worst output over its limit: "
          + ", ".join(f"{int(r[f'7a/plant/{plant}'][0])} / "
                      f"{r[f'7a/plant/{plant}'][1]:.2f}"
                      for r in world.results()))
    assert failed


# -- 7b: the TP-sharded serving engine ---------------------------------------

def _same_on_every_rank(res, key):
    for r in range(1, WORLD):
        np.testing.assert_array_equal(res[r][key], res[0][key], err_msg=key)
    return res[0][key]


@pytest.mark.parametrize("temp", [0.0, TEMP])
def test_7b_ring_engine_matches_the_single_process_engine(world, temp):
    got = _same_on_every_rank(world.results(), f"7b/ring/{temp}")
    np.testing.assert_array_equal(got, world.refs[f"7b/ring/{temp}"])


def test_7b_spec_engine_over_model_8_on_the_jax_test_s_artifact(world):
    """tests/test_engine_sharded.py's case: random payloads, self-draft over
    eight ranks against the plain paged engine, every draft accepted."""
    res = world.results()
    got = _same_on_every_rank(res, "7b/spec/random")
    np.testing.assert_array_equal(got, world.refs["7b/paged/random"])
    acc, drafted = _same_on_every_rank(res, "7b/spec/random/counts")
    assert drafted > 0 and acc == drafted


@pytest.mark.parametrize("temp", [0.0, TEMP])
def test_7b_spec_engine_over_model_8(world, temp):
    """Self-draft speculation with target and draft both sharded over eight
    ranks (KV heads 4: the caches hold every head, q / k / v gathered), K4's
    page walk, on the drawn model: the single-process spec engine's tokens
    and counts.  A verify pass and a decode chunk round near ties apart
    (trap 44), so on this model a greedy self-draft accepts 15 of 18
    drafts in both."""
    res = world.results()
    key = f"7b/spec/{temp}"
    got = _same_on_every_rank(res, key)
    np.testing.assert_array_equal(got, world.refs[key])
    acc, drafted = _same_on_every_rank(res, key + "/counts")
    print(f"spec at temperature {temp}: {acc} of {drafted} drafts accepted "
          f"over model 8, {list(world.refs[key + '/counts'])} in one "
          f"process")
    assert drafted > 0
    np.testing.assert_array_equal([acc, drafted], world.refs[key + "/counts"])


def _margin_rule(got, want, kw, seed):
    """Where the port's tokens part from JAX's, the step is a near tie of
    the port's teacher-forced logits."""
    from fp8tpu_torch.serve import ServeConfig, full_logits
    params = serve_params(kw, seed)
    scfg = ServeConfig(model=torch_cfg(kw))
    exact = 0
    for i in range(N_REQ):
        g, w = list(got[i]), list(want[i])
        if g == w:
            exact += 1
            continue
        j = next(k for k in range(NEW) if g[k] != w[k])
        seq = torch.tensor([2 + i, 7, 11] + w[:j], dtype=torch.int32)
        logits = full_logits(params, seq, scfg)[-1]
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) <= \
            2 * MARGIN_TOL * float(logits.abs().max()), (i, j)
    return exact


@pytest.mark.parametrize("which", ["ring", "spec"])
def test_7b_engines_match_jax_by_the_margin_rule(world, which):
    res = world.results()
    key = "7b/ring/0.0" if which == "ring" else "7b/spec/0.0"
    got = _same_on_every_rank(res, key)
    want = _jax_engine_tokens(paged=which == "spec")
    exact = _margin_rule(got, want, ENG, 1)
    print(f"7b {which}: {exact} of {N_REQ} requests equal to JAX's engine")
    assert exact >= 1


@pytest.mark.parametrize("fn", ["step", "full"])
@pytest.mark.parametrize("case", list(STEP_MESHES))
def test_7b_decode_step_over_a_mesh(world, case, fn):
    """decode_step from a prefilled ring, and full_logits (the dense causal
    forward over the quantized k / v), over the mesh against unsharded."""
    res = world.results()
    plain, sharded = _same_on_every_rank(res, f"{fn}/{case}")
    rel = float(np.abs(sharded - plain).max() / np.abs(plain).max())
    print(f"{fn} over {case}: {rel:.3e} of max|logit| (limit {STEP_TOL})")
    assert rel <= STEP_TOL


# -- the casts of a split tensor -------------------------------------------------

@pytest.mark.parametrize("name", list(CASTS))
def test_casts_of_a_split_tensor_are_the_whole_tensor_s(world, name):
    """A rank's block of a tensor split over the data group (a BatchShard,
    or a TensorShard), the model group or both, cast with its shard: the
    block of the whole tensor's cast, bit for bit.  Fine-grained, per-block
    and integer scaling of a model-split tensor raise."""
    for r, res in enumerate(world.results()):
        for split in SPLITS:
            got = int(res[f"cast/{name}/{split}"])
            if "model" in split and name in RAISES_MODEL_SPLIT:
                assert got == -1, (r, split)
            else:
                assert got == 0, (r, split, got)


# -- what stays raising ------------------------------------------------------------

@pytest.mark.parametrize("what", ["direct", "int4", "moe", "sr-model-split",
                                  "fine-grained-model-split"])
def test_unported_paths_under_a_mesh_raise(what):
    import dataclasses
    from fp8tpu_torch.parallel import make_mesh
    from fp8tpu_torch.parallel.data import BatchShard, TensorShard
    from fp8tpu_torch.quant.config import TensorQuantConfig
    from fp8tpu_torch.quant.fakequant import fake_quant
    from fp8tpu_torch.numerics.prng import key as prng_key
    from fp8tpu_torch.serve import (ServeConfig, random_serve_params,
                                    shard_serve_params)
    mesh = make_mesh(model=4)
    if what in ("direct", "int4", "moe"):
        kw = dict(ENG, n_experts=4) if what == "moe" else ENG
        cfg = torch_cfg(kw)
        fmt = "int4" if what == "int4" else "e4m3"
        scfg = ServeConfig(model=cfg, weight_fmt=fmt)
        if what == "direct":
            scfg = dataclasses.replace(scfg, matmul_impl="direct")
        params = random_serve_params(cfg, fmt, device="cpu")
        with pytest.raises(NotImplementedError, match="item 7f"):
            shard_serve_params(params, scfg, mesh)
        return
    x = torch.randn(8, 16)
    shard = TensorShard(None, BatchShard(None, 0, 4), 1)
    if what == "sr-model-split":
        cfg = TensorQuantConfig("e5m2", "stochastic", "per-tensor")
        with pytest.raises(NotImplementedError, match="item 7c"):
            fake_quant(x, cfg, prng_key(0), shard)
    else:
        cfg = TensorQuantConfig("e4m3", "rne", "fine-grained", group_size=4)
        with pytest.raises(NotImplementedError, match="model group"):
            fake_quant(x, cfg, None, shard)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
