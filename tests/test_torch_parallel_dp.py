"""Data-parallel FP8 training in the port against the single-process step
and the JAX package's data-parallel step, on the CPU.

Under GSPMD the JAX package's step over ``make_mesh(data=N)`` is the global
step.  The port's ``make_train_step(..., shard=BatchShard)`` must be too:
per-tensor scales from the global batch's amax, SR bits at each rank's
offset, the loss over the global batch, the raw gradients summed before
the wtgrad casts.  One world of four gloo ranks (this file run as a
script, which never imports JAX) runs two steps over groups of 2 and of 4
ranks of the tiny decoder of ``tests/test_torch_decoder_training.py`` for
hybrid-gemm (also with the 8-bit AdamW), hybrid-scaled, bfloat16 and
hybrid with hw patching (the attention BatchMatmuls on the fused engine),
and of the tiny ResNet without batch statistics for hybrid with hw
patching (its convs on the fused engine, whose operand scales then take
the global batch's amax, forward and backward); then each planted fault,
then ``examples/train_fp8.main`` with ``--data-parallel 4``;
``torch.distributed.run`` starts the script with ``--data-parallel 2``.
The decoder's batch rows hold tokens of two halves of the vocabulary whose
embedding rows differ 8-fold in magnitude, and the ResNet's images differ
8-fold, so the shards of one batch differ in magnitude.

Every run's parameters and loss scales are bit-equal to the port's
single-process step (the compute is f32), its losses within 2 n units of
2^-24 (the order of n ranks' partial sums).  The decoder runs without hw
patching and without the 8-bit AdamW are also held to the JAX package's
step within the limits of PERF.md §2's decoder-training row: hybrid-gemm
losses 1e-5 relative, parameters 2e-3, updates 5e-3 relative L2 and 99.9%
of their signs; the whole-whitelist recipes (hybrid-scaled, bfloat16)
2e-2, 1e-2, 0.25 and 97%; the loss-scale trajectory equal.  Each planted
fault must fail both the bit-equality and those limits against the
single-process step: a rank-local amax, a loss that is each rank's local
mean, the wtgrad casts run on each rank's partial gradients before the
sum, SR bits drawn at offset 0 on every rank, and the fused engine's
operand scales from the rank's rows.
"""

import dataclasses
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT = 120
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

STEPS = 2
LR = 1e-3
VOCAB = 64
TIGHT = dict(loss=1e-5, param=2e-3, update=5e-3, sign=0.999)
WHOLE = dict(loss=2e-2, param=1e-2, update=0.25, sign=0.97)
# Against the port's single-process step: parameters and loss scales equal
# bit for bit, the losses within the order of the ranks' partial sums
# (each partial loss and each of their sums rounds once: 2 n units of
# 2^-24, relative, for n ranks).
ORDER_ULPS = 2
RUNS = {        # name: (model, algo, opt8, hw patching, limits against JAX)
    "hybrid-gemm": ("decoder", "hybrid-gemm", False, False, TIGHT),
    "hybrid-gemm-opt8": ("decoder", "hybrid-gemm", True, False, TIGHT),
    "hybrid-scaled": ("decoder", "hybrid-scaled", False, False, WHOLE),
    "bfloat16": ("decoder", "bfloat16", False, False, WHOLE),
    "hybrid-hw": ("decoder", "hybrid", False, True, WHOLE),
    "resnet-hybrid-hw": ("resnet", "hybrid", False, True, TIGHT),
}
PLANTS = {                      # name: (run it plants into, the fault)
    "local-amax": "hybrid-gemm",
    "local-mean": "hybrid-gemm",
    "wtgrad-before-sum": "hybrid-gemm",
    "offset-0": "hybrid-gemm",
    "local-amax-engine": "resnet-hybrid-hw",
}
SCRIPT = ["--steps", "2", "--d-model", "32", "--n-layers", "1",
          "--batch-size", "4", "--seq-len", "9", "--device", "cpu"]


def _cfg():
    return dict(vocab_size=VOCAB, d_model=32, n_layers=1, n_heads=4,
                n_kv_heads=2, d_ff=64, max_seq_len=16, dtype="float32")


def _tokens():
    """(4, 9): rows 0-1 from the low half of the vocabulary, rows 2-3 from
    the high half, whose embedding rows are 8 times smaller."""
    rng = np.random.default_rng(0)
    lo = rng.integers(0, VOCAB // 2, (2, 9))
    hi = rng.integers(VOCAB // 2, VOCAB, (2, 9))
    return np.concatenate([lo, hi]).astype(np.int64)


def _images():
    """(4, 3, 8, 8) images, rows 2-3 8 times smaller, and their labels."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
    x[2:] /= 8
    return torch.from_numpy(x), torch.arange(4) % 10


def _model(kind="decoder"):
    if kind == "resnet":
        # the tiny ResNet without batch statistics (a rank's BatchNorm
        # would see its own rows only): hybrid with hw patching runs its
        # convs but the stem on the fused engine
        from fp8tpu_torch.models import tiny_resnet
        return tiny_resnet(device="cpu", norm_mode="scale_shift",
                           generator=torch.Generator().manual_seed(0))
    from fp8tpu_torch.models.transformer import DecoderConfig, decoder
    m = decoder(DecoderConfig(**_cfg()), "cpu",
                torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.embed.embedding[VOCAB // 2:] /= 8
    return m


def _batch(kind):
    if kind == "resnet":
        return _images()
    return torch.from_numpy(_tokens())


def _rows(batch, shard):
    """This rank's rows of the global batch (a tensor or a tuple)."""
    if isinstance(batch, tuple):
        return tuple(_rows(b, shard) for b in batch)
    rows = batch.shape[0] // shard.count
    return batch[shard.index * rows:(shard.index + 1) * rows]


def _xent(kind, logits, batch, global_count=None):
    """Cross-entropy: the mean over the batch's targets, or (a rank's
    share) their sum over ``global_count``."""
    if kind == "resnet":
        target = batch[1]
    else:
        logits, target = logits.reshape(-1, VOCAB), batch[:, 1:].reshape(-1)
    if global_count is None:
        return torch.nn.functional.cross_entropy(logits, target)
    return torch.nn.functional.cross_entropy(
        logits, target, reduction="sum") / torch.tensor(float(global_count))


def _loss_fn(kind, global_count=None):
    def loss_fn(apply_fn, params, batch):
        x = batch[0] if kind == "resnet" else batch[:, :-1]
        return _xent(kind, apply_fn(params, x), batch, global_count)
    return loss_fn


def _global_count(kind):
    return 4 if kind == "resnet" else _tokens()[:, 1:].size


def torch_run(name, shard=None, loss_fn=None):
    """STEPS train steps of the port for RUNS[name]: single-process on the
    whole batch (``shard`` None) or this rank's rows of it.  Returns
    (parameters after, losses, loss scales)."""
    from fp8tpu_torch.models.resnet import RESNET_EXEMPT
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.training import adamw_8bit, mpt
    kind, algo, opt8, hw, _ = RUNS[name]
    model = _model(kind)
    emu = mpt.initialize(model, training_algo=algo, device="cpu",
                         exempt_layers=RESNET_EXEMPT if kind == "resnet"
                         else ())
    if hw:
        emu = dataclasses.replace(emu,
                                  policy=emu.policy.with_hw_patching())
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in model.named_parameters()}
    opt = (adamw_8bit(params, LR, module_table=emu.module_table) if opt8
           else torch.optim.AdamW(params.values(), lr=LR, weight_decay=1e-4))
    batch = _batch(kind)
    if shard is not None:
        batch = _rows(batch, shard)
    if loss_fn is None:
        loss_fn = _loss_fn(kind, None if shard is None
                           else _global_count(kind))
    step = mpt.make_train_step(emu, loss_fn, shard=shard)
    state = mpt.init_train_state(opt)
    losses, scales = [], []
    for i in range(STEPS):
        params, state, loss = step(params, state, batch,
                                   prng.fold_in(prng.key(1), i))
        losses.append(float(loss))
        scales.append((state[1].scale, state[1].good_steps))
    return ({k: v.detach().clone() for k, v in params.items()}, losses,
            scales)


# -- the worker ---------------------------------------------------------------

def _plant(name, shard):
    """(shard, loss_fn, undo) for a planted fault."""
    from fp8tpu_torch.parallel import BatchShard
    from fp8tpu_torch.training import mpt
    kind = RUNS[PLANTS[name]][0]
    if name == "local-amax":
        class Local(BatchShard):
            def max(self, a):
                return a
        return Local(shard.group, shard.index, shard.count), None, lambda: None
    if name == "local-amax-engine":
        # the fused engine's operand scales (forward and the backward's
        # requant) from the rank's rows; every other cast keeps the shard
        from fp8tpu_torch.quant import hw_patch
        scale, requant = hw_patch._operand_scale, hw_patch._requant
        hw_patch._operand_scale = lambda x, cfg, shard=None: scale(x, cfg)
        hw_patch._requant = lambda x, cfg, shard=None: requant(x, cfg)

        def undo():
            hw_patch._operand_scale, hw_patch._requant = scale, requant
        return shard, None, undo
    if name == "offset-0":
        class Zero(BatchShard):
            def block(self, shape):
                b = super().block(shape)
                return dataclasses.replace(b, start=(0,) * len(b.start))
        return Zero(shard.group, shard.index, shard.count), None, lambda: None
    if name == "local-mean":
        return shard, _loss_fn(kind), lambda: None
    if name == "wtgrad-before-sum":
        class NoSum(BatchShard):
            def sum_grads(self, grads):
                return grads
        orig = mpt.MPTEmulator.quantize_grads
        mpt.MPTEmulator.quantize_grads = \
            lambda self, g, k: shard.sum_grads(orig(self, g, k))

        def undo():
            mpt.MPTEmulator.quantize_grads = orig
        return NoSum(shard.group, shard.index, shard.count), None, undo
    raise ValueError(name)


def _save_run(res, key, run):
    params, losses, scales = run
    for k, v in params.items():
        res[f"{key}/p/{k}"] = v.numpy()
    res[f"{key}/losses"] = np.array(losses)
    res[f"{key}/scales"] = np.array(scales, dtype=np.float64)


def _worker(rank, world, port, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from fp8tpu_torch.examples import train_fp8
    from fp8tpu_torch.parallel import BatchShard, init_world
    init_world("cpu", rank, world, f"tcp://localhost:{port}")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {2: pairs[rank // 2], 4: dist.group.WORLD}
    res = {}
    for name in RUNS:
        for n, g in groups.items():
            _save_run(res, f"{name}/{n}", torch_run(name, BatchShard.of(g)))
    for name, run in PLANTS.items():
        shard, loss_fn, undo = _plant(name, BatchShard.of(groups[2]))
        _save_run(res, f"plant/{name}", torch_run(run, shard, loss_fn))
        undo()
    main = train_fp8.main(SCRIPT + ["--data-parallel", str(world)])
    res["main/losses"] = np.array(main["losses"])
    res["main/lines"] = np.array(main["lines"])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


# -- the world ------------------------------------------------------------------

def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


class World:
    """``WORLD`` ranks of this file run as a script, and the script under
    ``torch.distributed.run`` with two ranks, started at once;
    ``results()`` waits for them (``TIMEOUT`` seconds from the start, then
    every process is killed and the test fails)."""

    def __init__(self, out):
        from fp8tpu_torch.parallel.mesh import free_port
        self.out, self.t0 = str(out), time.monotonic()
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
             str(port), self.out], cwd=ROOT, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        self.torchrun = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "2", "--master-port", str(free_port()),
             "-m", "fp8tpu_torch.examples.train_fp8", "--data-parallel",
             "2"] + SCRIPT, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self._res = self._torchrun = None

    def _wait(self, p):
        left = TIMEOUT - (time.monotonic() - self.t0)
        try:
            return p.communicate(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            self.kill()
            pytest.fail(f"the spawned ranks ran past {TIMEOUT} s")

    def results(self):
        if self._res is None:
            logs = [self._wait(p)[0] for p in self.procs]
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            self._res = [dict(np.load(os.path.join(self.out,
                                                   f"rank{r}.npz")))
                         for r in range(WORLD)]
        return self._res

    def torchrun_output(self):
        if self._torchrun is None:
            out, err = self._wait(self.torchrun)
            assert self.torchrun.returncode == 0, err[-4000:]
            self._torchrun = out
        return self._torchrun

    def kill(self):
        for p in self.procs + [self.torchrun]:
            if p.poll() is None:
                p.kill()
                p.wait()


# The JAX references are traced and compiled in threads (XLA's compile
# releases the GIL), started with the world: three tiny decoder steps take
# 12 s together that way, 35 s one after another.
# (The hw-patched runs are held to the single-process step only: that
# step is held to the JAX package's in tests/test_torch_decoder_training.py
# and tests/test_torch_training.py.)
_JAX_RUNS = [n for n, (kind, _, opt8, hw, _) in RUNS.items()
             if kind == "decoder" and not (opt8 or hw)]


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Started before the file's first test, with the JAX references, so
    that they and the single-process runs go on while the ranks do."""
    from concurrent.futures import ThreadPoolExecutor
    w = World(tmp_path_factory.mktemp("world"))
    with ThreadPoolExecutor(len(_JAX_RUNS)) as pool:
        _JAX.update((n, pool.submit(_jax_run, n)) for n in _JAX_RUNS)
        yield w
    w.kill()


# -- references and checks ---------------------------------------------------------

_SINGLE = {}
_JAX = {}


def _single(name):
    if name not in _SINGLE:
        _SINGLE[name] = torch_run(name)
    return _SINGLE[name]


def _jax_run(name):
    """STEPS jitted JAX train steps over ``make_mesh(data=2)`` (batch
    sharded over data, parameters replicated), from the port's initial
    weights: (parameters after in the port's names, losses, scales)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from fp8tpu.models.transformer import Decoder as JDecoder
    from fp8tpu.models.transformer import DecoderConfig as JConfig
    from fp8tpu.parallel import make_mesh
    from fp8tpu.training import mpt as jmpt
    from fp8tpu.training import opt8 as jopt8
    from fp8tpu_torch.models import variables_from_flax, variables_to_flax
    from fp8tpu_torch.quant.interceptor import build_module_table
    _, algo, opt8, _, _ = RUNS[name]
    model = _model()
    v = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                     variables_to_flax(dict(model.state_dict()),
                                       build_module_table(model)))
    toks = _tokens().astype(np.int32)
    jm = JDecoder(JConfig(**_cfg()))
    emu = jmpt.initialize(jm, v, (toks[:, :-1],), training_algo=algo)
    opt = jopt8.adamw_8bit(LR) if opt8 else optax.adamw(LR)

    def loss_fn(apply_fn, params, batch):
        logits = apply_fn(params, batch[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[:, 1:]).mean()

    mesh = make_mesh(data=2)
    step = jax.jit(jmpt.make_train_step(emu, opt, loss_fn))
    state = jmpt.init_train_state(opt, v)
    batch = jax.device_put(jnp.asarray(toks),
                           NamedSharding(mesh, P("data", None)))
    p, losses, scales = v, [], []
    with mesh:
        for i in range(STEPS):
            p, state, loss = step(p, state, batch,
                                  jax.random.fold_in(jax.random.key(1), i))
            losses.append(float(loss))
            scales.append((float(state[1].scale), int(state[1].good_steps)))
    return variables_from_flax(jax.tree.map(np.asarray, p)), losses, scales


def _unpack(res, key):
    params = {k[len(key) + 3:]: torch.from_numpy(v) for k, v in res.items()
              if k.startswith(key + "/p/")}
    scales = [tuple(s) for s in res[key + "/scales"].tolist()]
    return params, list(res[key + "/losses"]), scales


def _errors(got, want, before):
    """Largest loss error (relative), largest parameter error, the updates'
    relative L2 distance and their share of equal signs."""
    gp, gl, _ = got
    wp, wl, _ = want
    loss = max(abs(a - b) / abs(b) for a, b in zip(gl, wl))
    param = max(float((gp[k] - wp[k]).abs().max()) for k in wp)
    num = den = 0.0
    same = total = 0
    for k, p0 in before.items():
        dw = (wp[k] - p0).double()
        dg = (gp[k] - p0).double()
        num += float(((dg - dw) ** 2).sum())
        den += float((dw ** 2).sum())
        same += int((torch.sign(dg) == torch.sign(dw)).sum())
        total += dw.numel()
    return loss, param, (num / den) ** 0.5, same / total


def _within(got, want, tol, kind="decoder"):
    before = {k: p.detach() for k, p in _model(kind).named_parameters()}
    loss, param, update, sign = _errors(got, want, before)
    ok = (got[2] == want[2] and loss <= tol["loss"] and param <= tol["param"]
          and update <= tol["update"] and sign >= tol["sign"])
    return ok, dict(loss=loss, param=param, update=update, sign=sign)


def _is_single(got, single, n):
    """Whether a run over ``n`` ranks is the single-process step: the
    parameters and loss scales bit-equal, the losses within the order of
    the partial sums."""
    gp, gl, gs = got
    sp, sl, ss = single
    differ = [k for k in sp if not torch.equal(gp[k], sp[k])]
    loss = max(abs(a - b) / abs(b) for a, b in zip(gl, sl))
    ok = not differ and gs == ss and loss <= ORDER_ULPS * n * 2.0 ** -24
    return ok, dict(params_differ=len(differ), loss=loss, scales=(gs, ss))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_data_parallel_step_is_the_global_step(world, name, n):
    kind, tol = RUNS[name][0], RUNS[name][4]
    single = _single(name)
    res = world.results()
    runs = [_unpack(res[r], f"{name}/{n}") for r in range(WORLD)]
    for r in range(1, WORLD):          # every rank holds the same step
        for k, p in runs[0][0].items():
            assert torch.equal(runs[r][0][k], p), (r, k)
    ok, err = _is_single(runs[0], single, n)
    print(f"{name} over {n} ranks vs the port single-process: {err}")
    assert ok, err
    if name in _JAX:
        ok, err = _within(runs[0], _JAX[name].result(), tol, kind)
        print(f"{name} over {n} ranks vs JAX make_mesh(data=2): {err}")
        assert ok, err


@pytest.mark.parametrize("plant", list(PLANTS))
def test_planted_faults_fail_the_limit(world, plant):
    """Each planted fault (over 2 ranks) is told apart from the
    single-process step, and all but the SR offset's fail the limits
    against JAX as well."""
    run = PLANTS[plant]
    kind, tol = RUNS[run][0], RUNS[run][4]
    got = _unpack(world.results()[0], f"plant/{plant}")
    single = _single(run)
    exact, err = _is_single(got, single, 2)
    near, lim = _within(got, single, tol, kind)
    print(f"{plant}: {err}; {lim}")
    assert not exact, err
    assert not near, lim


def _logged(lines):
    """(loss, running mean) of every logged step line."""
    return [tuple(map(float, m.groups())) for m in
            (re.search(r"loss: ([0-9.e+-]+) \(([0-9.e+-]+)\)", ln)
             for ln in lines) if m]


def test_train_fp8_data_parallel_logs_the_single_process_losses(world):
    from fp8tpu_torch.examples import train_fp8
    single = train_fp8.main(SCRIPT)
    res = world.results()
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["main/losses"], single["losses"],
                                   rtol=TIGHT["loss"])
    # torch.distributed.run, two ranks: rank 0 prints the script's lines
    # (4 decimals), rank 1 nothing
    out = world.torchrun_output()
    got, want = _logged(out.splitlines()), _logged(single["lines"])
    assert len(got) == len(want) == 2, out
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TIGHT["loss"], atol=1e-4)


def test_data_parallel_flags_need_a_world_and_model_parallel_raises():
    from fp8tpu_torch.examples import train_fp8
    with pytest.raises(ValueError, match="nproc-per-node 2"):
        train_fp8.main(SCRIPT + ["--data-parallel", "2"])
    # model parallelism runs too (tests/test_torch_parallel_tp.py), in a
    # world of its size
    with pytest.raises(ValueError, match="nproc-per-node 2"):
        train_fp8.main(SCRIPT + ["--model-parallel", "2"])
    with pytest.raises(NotImplementedError, match="item 7d"):
        train_fp8.main(SCRIPT + ["--data-parallel", "2", "--n-experts", "4"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
