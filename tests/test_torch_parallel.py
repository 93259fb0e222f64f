"""The port's ``parallel/`` against the JAX package's, on the CPU.

The sharding rules run in-process (a mesh without a process group is shape
only).  Everything that issues collectives runs in one world of eight gloo
ranks, spawned once for this file: each rank is this file run as a script
(it imports torch and the port, never JAX), computes every case on its
shard of inputs drawn from numpy seeds, and writes its results to an npz.
The JAX side runs the same functions under ``shard_map`` on the conftest's
eight virtual CPU devices while the world runs.

Limits (PERF.md §2, the parallel rows):

- ``wire_all_reduce``: phase-1 codes and scales bit-equal to the JAX
  package's ``quant_blocks``; the output equal to the un-jitted JAX
  function's on >= 99.9% of the elements (measured: all of them; the sum
  in rank order is XLA's) and within one grid step of its block of both
  the un-jitted and the jitted one (jit moves a block scale by an ulp,
  trap 54: measured 25.7% of the e4m3 elements equal, 1.9e-7 relative
  apart); ``fmt=None`` within 8 * 2^-24 * sum|x| (another f32 order); the
  tree's shapes, dtypes and values.
- TP (the down weight as a rank holds it and laid out by chunk): within
  1e-5 * max|y| for f32 x; for bf16 x within one bf16 step of
  the larger of the two values (the f32 sums differ in order, then round
  once to bf16).
- Pipeline: forward within 1e-5 * max|y|, gradients within 1e-4 relative
  L2; remat bit-equal to no remat.
- MoE over model axes of 4 and of 2 ranks, each rank passing its E/T
  rows of the expert stacks: output and gradients bit-equal to
  ``mesh=None``.
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
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

FMTS = [None, "e4m3", "e5m2", "int8", "bf16"]
WIRE_N, WIRE_BLOCK = 2048, 128
TP_B, TP_K, TP_FF, TP_CHUNKS = 8, 64, 256, 4
PP_D = 16
PP_CASES = [(4, 2, 4), (8, 1, 2), (2, 4, 2)]
PP_GRAD = (4, 2, 4)
MOE_T, MOE_E, MOE_F = 64, 4, 32


# -- inputs, the same in the workers and the parent -------------------------

def wire_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((WORLD, WIRE_N)).astype(np.float32)
    x *= np.logspace(-3, 2, WIRE_N)[None, :].astype(np.float32)
    odd = rng.standard_normal((WORLD, 1001)).astype(np.float32)
    tree = {"w": rng.standard_normal((WORLD, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((WORLD, 7)).astype(np.float32),
            "emb": rng.standard_normal((WORLD, 11, 2)).astype(np.float32)}
    return x, odd, tree


WIRE_CASES = ([(str(f), x_, f, False, WIRE_BLOCK) for f in FMTS
               for x_ in ("x",)]
              + [("e4m3-mean", "x", "e4m3", True, WIRE_BLOCK),
                 ("None-mean", "x", None, True, WIRE_BLOCK),
                 ("int8-odd", "odd", "int8", False, 64)])


def tp_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((TP_B, TP_K)).astype(np.float32)
    up = (rng.standard_normal((TP_K, TP_FF)) * 0.1).astype(np.float32)
    down = (rng.standard_normal((TP_FF, TP_K)) * 0.1).astype(np.float32)
    return x, up, down


def pp_inputs(stages, seed=0):
    rng = np.random.default_rng(10 + seed)
    w1 = (rng.standard_normal((stages, PP_D, 2 * PP_D)) * 0.3).astype(
        np.float32)
    w2 = (rng.standard_normal((stages, 2 * PP_D, PP_D)) * 0.3).astype(
        np.float32)
    x = rng.standard_normal((16, PP_D)).astype(np.float32)
    return {"w1": w1, "w2": w2}, x


def moe_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((MOE_T, PP_D)).astype(np.float32)
    gate = (rng.standard_normal((PP_D, MOE_E)) * 0.5).astype(np.float32)
    up = (rng.standard_normal((MOE_E, PP_D, MOE_F)) * 0.3).astype(np.float32)
    down = (rng.standard_normal((MOE_E, MOE_F, PP_D)) * 0.3).astype(
        np.float32)
    return x, gate, up, down


# -- the worker ---------------------------------------------------------------

def _torch_stage(params, x):
    """The quantized stage of tests/test_pipeline_moe.py, in the port."""
    from fp8tpu_torch.quant.config import TensorQuantConfig
    from fp8tpu_torch.quant.fakequant import fake_quant
    cfg = TensorQuantConfig(dtype="e4m3", scheme="rne",
                            scaling="per-tensor-max")
    w1 = fake_quant(params["w1"], cfg)
    w2 = fake_quant(params["w2"], cfg)
    h = torch.nn.functional.gelu(fake_quant(x, cfg) @ w1, approximate="tanh")
    return x + h @ w2


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    if t.element_size() == 1 and t.is_floating_point():
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _worker_wire(rank, res):
    from fp8tpu_torch.numerics.blockquant import quant_blocks
    from fp8tpu_torch.parallel import wire_all_reduce, wire_all_reduce_tree
    x, odd, tree = wire_inputs()
    arrays = {"x": x, "odd": odd}
    for name, which, fmt, mean, block in WIRE_CASES:
        local = torch.from_numpy(arrays[which][rank])
        res[f"wire/{name}"] = _np(wire_all_reduce(local, None, fmt, mean,
                                                  block))
        if fmt is not None:
            n, size = WORLD, local.numel()
            nb = -(-(-(-size // n)) // block)
            flat = torch.nn.functional.pad(local, (0, n * nb * block - size))
            q, s = quant_blocks(flat.reshape(n, nb, block), fmt)
            res[f"wire/{name}/q"], res[f"wire/{name}/s"] = _np(q), _np(s)
    leaves = {"w": torch.from_numpy(tree["w"][rank]),
              "b": torch.from_numpy(tree["b"][rank]),
              "emb": torch.from_numpy(tree["emb"][rank]).to(torch.bfloat16)}
    out = wire_all_reduce_tree(leaves, None, "e4m3", block=64)
    for k, v in out.items():
        res[f"tree/{k}"] = _np(v)
        res[f"tree/{k}/dtype"] = np.array(str(v.dtype))


def _worker_tp(rank, res):
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.kernels.qmatmul import quantize_weights
    from fp8tpu_torch.parallel import (chunk_columns,
                                       column_parallel_qmatmul, make_mesh,
                                       row_parallel_qmatmul, tp_mlp_block)
    mesh = make_mesh(model=WORLD)
    x, up, down = (torch.from_numpy(a) for a in tp_inputs())
    up8, up_s = quantize_weights(up, "e4m3", axis=-1)
    down8, down_s = quantize_weights(down, "e4m3", axis=-1)
    up_s, down_s = up_s.reshape(-1), down_s.reshape(-1)
    with full_fp32():
        h = x @ (up8.float() * up_s[None])
    w = TP_FF // WORLD
    cols = slice(rank * w, (rank + 1) * w)
    if rank == 0:
        res["tp/up8"], res["tp/up_s"] = _np(up8), _np(up_s)
        res["tp/down8"], res["tp/down_s"] = _np(down8), _np(down_s)
        res["tp/h"] = _np(h)
    for dt in ("float32", "bfloat16"):
        xd, hd = x.to(getattr(torch, dt)), h.to(getattr(torch, dt))
        res[f"tp/col/{dt}"] = _np(column_parallel_qmatmul(
            xd, up8[:, cols], up_s[cols], mesh))
        # the down weight as each rank holds it, and laid out by chunk
        for lay, down_r in (("", down8[cols]),
                            ("chunked/", chunk_columns(down8[cols],
                                                       TP_CHUNKS))):
            for scatter in (False, True):
                res[f"tp/row/{lay}{dt}/{scatter}"] = _np(
                    row_parallel_qmatmul(hd[:, cols], down_r, down_s, mesh,
                                         overlap_chunks=TP_CHUNKS,
                                         scatter=scatter))
            res[f"tp/mlp/{lay}{dt}"] = _np(tp_mlp_block(
                xd, up8[:, cols], up_s[cols], down_r, down_s, mesh,
                overlap_chunks=TP_CHUNKS))


def _pp_run(mesh, stages, data, micro, seed, remat=False, grad=False):
    from fp8tpu_torch.parallel import pipeline_apply
    params, x = pp_inputs(stages, seed)
    d = mesh.index("data")
    rows = x.shape[0] // data
    params = {k: torch.from_numpy(v).requires_grad_(grad)
              for k, v in params.items()}
    xl = torch.from_numpy(x[d * rows:(d + 1) * rows]).requires_grad_(grad)
    y = pipeline_apply(_torch_stage, params, xl, mesh,
                       n_microbatches=micro, remat=remat)
    if not grad:
        return y, None
    loss = (y ** 2).sum() / torch.tensor(float(y.numel() * data))
    loss.backward()
    s = mesh.index("stage")
    return y, {"w1": params["w1"].grad[s], "w2": params["w2"].grad[s],
               "x": xl.grad}


def _worker_pipeline(rank, res):
    from fp8tpu_torch.parallel import make_pp_mesh
    for stages, data, micro in PP_CASES + [(1, WORLD, 2)]:
        mesh = make_pp_mesh(stages, data)
        y, _ = _pp_run(mesh, stages, data, micro, seed=stages)
        res[f"pp/{stages}x{data}x{micro}"] = _np(y)
    stages, data, micro = PP_GRAD
    mesh = make_pp_mesh(stages, data)
    for remat in (False, True):
        y, g = _pp_run(mesh, stages, data, micro, seed=99, remat=remat,
                       grad=True)
        res[f"ppg/{remat}/y"] = _np(y)
        for k, v in g.items():
            res[f"ppg/{remat}/{k}"] = _np(v)


def _moe_run(mesh=None):
    """moe_ffn without a mesh, or over ``mesh``'s model axis with each rank
    passing its E/T rows of the expert stacks."""
    from fp8tpu_torch.parallel import moe_ffn, quantize_expert_weights
    x, gate, up, down = (torch.from_numpy(a) for a in moe_inputs())
    up8, up_s = quantize_expert_weights(up, "e4m3")
    down8, down_s = quantize_expert_weights(down, "e4m3")
    if mesh is not None:
        rows = MOE_E // mesh.shape["model"]
        m = mesh.index("model")
        up8, up_s, down8, down_s = (t[m * rows:(m + 1) * rows]
                                    for t in (up8, up_s, down8, down_s))
    x, gate, up_s, down_s = (t.clone().requires_grad_(True)
                             for t in (x, gate, up_s, down_s))
    y, aux = moe_ffn(x, gate, up8, up_s, down8, down_s, mesh=mesh)
    ((y ** 2).sum() + 0.01 * aux).backward()
    return [y.detach(), x.grad, gate.grad, up_s.grad, down_s.grad]


# id: (data, model) of the mesh
MOE_MESHES = {"one-expert-a-rank": (2, 4), "two-experts-a-rank": (4, 2)}


def _worker_moe(rank, res):
    from fp8tpu_torch.parallel import make_mesh
    plain = _moe_run()
    for case, (data, model) in MOE_MESHES.items():
        mesh = make_mesh(data=data, model=model)
        got = _moe_run(mesh)
        rows = MOE_E // model
        m = mesh.index("model")
        mine = slice(m * rows, (m + 1) * rows)
        equal = [torch.equal(got[i], plain[i]) for i in range(3)]
        # the scales' gradients: this rank's experts' rows
        equal += [torch.equal(got[i], plain[i][mine]) for i in (3, 4)]
        res[f"moe/{case}/equal"] = np.array(equal)
        res[f"moe/{case}/maxdiff"] = np.array(
            [float((got[i] - plain[i]).abs().max()) for i in range(3)])


def _worker_shard_params(rank, res):
    from fp8tpu_torch.models import variables_to_flax
    from fp8tpu_torch.models.transformer import decoder, tiny_config
    from fp8tpu_torch.parallel import (DECODER_PARAM_RULES, make_mesh,
                                       shard_params)
    from fp8tpu_torch.quant.interceptor import build_module_table
    model = decoder(tiny_config(n_layers=1, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=128, vocab_size=256,
                                max_seq_len=32), "cpu",
                    torch.Generator().manual_seed(0))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    table = build_module_table(model)
    mesh = make_mesh(data=2, model=4)
    flax = shard_params(variables_to_flax(sd, table), mesh,
                        DECODER_PARAM_RULES)
    torch_names = shard_params(sd, mesh, DECODER_PARAM_RULES, table)

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, pre + k + "/")
            else:
                yield pre + k, v

    for path, v in walk(flax, ""):
        res[f"sp/flax/{path}"] = _np(v.to_local())
    for name, v in torch_names.items():
        res[f"sp/torch/{name}"] = _np(v.to_local())
    if rank == 0:
        for name, v in sd.items():
            res[f"sp/full/{name}"] = _np(v)


def _worker(rank, world, port, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from fp8tpu_torch.parallel import init_world
    init_world("cpu", rank, world, f"tcp://localhost:{port}")
    res = {}
    for part in (_worker_wire, _worker_tp, _worker_moe, _worker_pipeline,
                 _worker_shard_params):
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
    """Started before the file's first test, so the in-process tests and
    the JAX references run while the ranks do."""
    w = World(tmp_path_factory.mktemp("world"))
    yield w
    w.kill()


# -- sharding rules, in-process --------------------------------------------------

def _jax_cfg(n_experts=0):
    from fp8tpu.models import tiny_config
    return tiny_config(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256, max_seq_len=32,
                       n_experts=n_experts)


def _jax_decoder_vars(n_experts=0):
    """The JAX decoder's variables as shapes (the rules read no values)."""
    import jax
    import jax.numpy as jnp
    from fp8tpu.models import Decoder
    return jax.eval_shape(Decoder(_jax_cfg(n_experts)).init,
                          jax.random.key(0), jnp.ones((2, 8), jnp.int32))


def _spec_leaves(tree):
    import jax
    return {jax.tree_util.keystr(kp): tuple(s.spec)
            for kp, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]}


@pytest.mark.parametrize("which", ["decoder", "moe", "serve"])
@pytest.mark.parametrize("model", [4, 3])
def test_rules_match_jax(which, model):
    import jax
    import fp8tpu.parallel as jp
    import fp8tpu_torch.parallel as tp
    if which == "serve":
        from fp8tpu.serve import convert_decoder_params
        tree = jax.eval_shape(lambda v: convert_decoder_params(
            v, _jax_cfg(4)), _jax_decoder_vars(4))
    else:
        tree = _jax_decoder_vars(4 if which == "moe" else 0)
    rules = {"decoder": "DECODER_PARAM_RULES", "moe": "MOE_PARAM_RULES",
             "serve": "SERVE_PARAM_RULES"}[which]
    jmesh = jp.make_mesh(data=1, model=model)
    want = _spec_leaves(jp.shard_tree(tree, jmesh, getattr(jp, rules)))
    ttree = jax.tree.map(lambda a: np.zeros(np.shape(a), np.int8), tree)
    tmesh = tp.make_mesh(data=1, model=model)
    got = _spec_leaves(jax.tree.map(
        lambda s: s, tp.shard_tree(ttree, tmesh, getattr(tp, rules)),
        is_leaf=lambda x: hasattr(x, "spec")))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == tuple(want[k]), (k, got[k], want[k])
    assert any(a is not None for s in got.values() for a in s) == (model == 4)


def test_rule_tables_and_cache_specs_are_jax_s():
    import fp8tpu.parallel as jp
    import fp8tpu_torch.parallel as tp
    for name in ("DECODER_PARAM_RULES", "MOE_PARAM_RULES",
                 "SERVE_PARAM_RULES"):
        assert [(p, tuple(s)) for p, s in getattr(tp, name)] == \
            [(p, tuple(s)) for p, s in getattr(jp, name)], name
    for name in ("KV_CACHE_SPEC", "KV_SCALE_SPEC"):
        assert tuple(getattr(tp, name)) == tuple(getattr(jp, name))
    mesh = tp.make_mesh(data=2, model=2)
    assert tuple(tp.batch_sharding(mesh).spec) == (("host", "data"), None)
    assert tuple(tp.batch_sharding(mesh, True).spec) == (("host", "data"),
                                                          "seq")
    assert tuple(tp.replicated(mesh).spec) == ()
    assert mesh.shape == {"host": 1, "data": 2, "seq": 1, "model": 2}
    assert tp.make_pp_mesh(4, 2).shape == {"stage": 4, "data": 2}


def test_torch_state_dict_specs_map_to_the_flax_layout():
    """A torch state_dict matched under its Flax names: a Dense weight
    (out, in) takes the kernel (in, out)'s spec reversed."""
    from fp8tpu_torch.models.transformer import Decoder, tiny_config
    import fp8tpu_torch.parallel as tp
    from fp8tpu_torch.quant.interceptor import build_module_table
    model = Decoder(tiny_config(n_layers=1, d_model=64, n_heads=4,
                                n_kv_heads=2, d_ff=128, vocab_size=256,
                                max_seq_len=32))
    mesh = tp.make_mesh(model=4)
    sh = tp.shard_tree(dict(model.state_dict()), mesh,
                       tp.DECODER_PARAM_RULES, build_module_table(model))
    assert tuple(sh["layer_0.attn.q_proj.weight"].spec) == ("model", None)
    assert tuple(sh["layer_0.attn.o_proj.weight"].spec) == (None, "model")
    assert tuple(sh["embed.embedding"].spec) == ("model", None)
    assert tuple(sh["layer_0.attn_norm.scale"].spec) == (None,)


# -- the world's results against JAX ---------------------------------------------

def _jax_all_reduce(per_dev, fn, jit=False):
    """Rank 0's result of ``fn`` over an axis "data" of 8: jitted, under
    ``shard_map`` on the 8-device mesh (XLA turns the block scale's divide
    by the grid maximum into a multiply by its reciprocal, an ulp off in
    some blocks: trap 54), or un-jitted, op by op as the port computes,
    under ``vmap`` with the axis name (the same collectives; an eager
    ``shard_map`` takes 4 s a call)."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from fp8tpu.parallel import make_mesh
    if not jit:
        with jax.disable_jit():
            out = jax.vmap(fn, axis_name="data")(per_dev)
        return jax.tree.map(lambda a: np.asarray(a, np.float32)[0], out)
    mesh = make_mesh(data=WORLD)

    def body(x):
        x = jax.tree.map(lambda a: a.reshape(a.shape[1:]), x)
        return jax.tree.map(lambda a: a[None], fn(x))

    spec = jax.tree.map(lambda _: P("data"), per_dev)
    out = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                            out_specs=spec, check_vma=False))(per_dev)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)[0], out)


GRID_STEP = {"e4m3": 2.0 ** -3, "e5m2": 2.0 ** -2, "int8": 1 / 127,
             "bf16": 2.0 ** -7}


@pytest.mark.parametrize("case", WIRE_CASES, ids=[c[0] for c in WIRE_CASES])
def test_wire_all_reduce_matches_jax(world, case):
    import jax.numpy as jnp
    from fp8tpu.numerics.blockquant import quant_blocks as jquant
    from fp8tpu.parallel import wire_all_reduce as jwire
    name, which, fmt, mean, block = case
    x, odd, _ = wire_inputs()
    arr = {"x": x, "odd": odd}[which]
    want, jitted = (_jax_all_reduce(jnp.asarray(arr), lambda a: jwire(
        a, "data", fmt=fmt, mean=mean, block=block), jit) for jit in
        (False, True))
    res = world.results()
    for r in range(WORLD):
        np.testing.assert_array_equal(res[r][f"wire/{name}"],
                                      res[0][f"wire/{name}"])
    got = res[0][f"wire/{name}"]
    if fmt is None:
        bound = WORLD * 2.0 ** -24 * np.abs(arr).sum(0)
        for ref in (want, jitted):
            assert np.all(np.abs(got - ref) <= bound), name
        return
    # phase 1: each rank's codes and scales are the JAX package's
    n, size = WORLD, arr.shape[1]
    nb = -(-(-(-size // n)) // block)
    for r in range(WORLD):
        flat = np.pad(arr[r], (0, n * nb * block - size))
        q, s = jquant(jnp.asarray(flat.reshape(n, nb, block)), fmt)
        q = np.asarray(q)
        q = q.view(np.uint8) if q.dtype.itemsize == 1 and fmt != "int8" \
            else q.astype(np.float32)
        np.testing.assert_array_equal(res[r][f"wire/{name}/q"], q)
        np.testing.assert_array_equal(res[r][f"wire/{name}/s"],
                                      np.asarray(s))
    equal = np.mean(got == want)
    pad = (-size) % block
    blockmax = np.abs(np.pad(want, (0, pad))).reshape(-1, block).max(1)
    step = np.repeat(blockmax, block)[:size] * GRID_STEP[fmt]
    if fmt == "bf16":
        step = np.abs(want) * GRID_STEP[fmt]
    print(f"{name}: {equal:.6f} of the elements equal to un-jitted JAX's, "
          f"{np.mean(got == jitted):.6f} to jitted JAX's")
    assert equal >= 0.999, equal
    for ref in (want, jitted):
        assert np.all(np.abs(got - ref) <= step), name


def test_wire_tree_roundtrip_and_bytes(world):
    import jax.numpy as jnp
    from fp8tpu.parallel import (wire_all_reduce_tree as jtree,
                                 wire_bytes_per_element as jbytes)
    from fp8tpu_torch.parallel import wire_bytes_per_element
    _, _, tree = wire_inputs()
    jt = {"w": jnp.asarray(tree["w"]), "b": jnp.asarray(tree["b"]),
          "emb": jnp.asarray(tree["emb"], jnp.bfloat16)}
    want = _jax_all_reduce(jt, lambda t: jtree(t, "data", fmt="e4m3",
                                               block=64))      # un-jitted
    res = world.results()[0]
    for k, shape in (("w", (3, 5)), ("b", (7,)), ("emb", (11, 2))):
        assert res[f"tree/{k}"].shape == shape
        assert str(res[f"tree/{k}/dtype"]) == ("torch.bfloat16" if k == "emb"
                                               else "torch.float32")
        np.testing.assert_array_equal(res[f"tree/{k}"], want[k])
        np.testing.assert_allclose(res[f"tree/{k}"], want[k], rtol=0,
                                   atol=np.abs(want[k]).max() * 2 ** -3)
    for fmt in FMTS:
        for n in (2, 8):
            assert wire_bytes_per_element(fmt, n) == jbytes(fmt, n)


def _bf16_step(v):
    v = np.abs(v).astype(np.float32)
    e = np.floor(np.log2(np.maximum(v, np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _tp_close(got, want, dt):
    scale = np.abs(want).max()
    if dt == "float32":
        assert np.abs(got - want).max() <= 1e-5 * scale, \
            np.abs(got - want).max() / scale
    else:
        step = _bf16_step(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= step), \
            np.max(np.abs(got - want) / step)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_tp_matmuls_match_jax(world, dt):
    import jax
    import jax.numpy as jnp
    from fp8tpu.parallel import make_mesh
    from fp8tpu.parallel.tp_matmul import (column_parallel_qmatmul,
                                           row_parallel_qmatmul,
                                           tp_mlp_block)
    res = world.results()
    r0 = res[0]
    up8 = jnp.asarray(r0["tp/up8"]).view(jnp.float8_e4m3fn)
    down8 = jnp.asarray(r0["tp/down8"]).view(jnp.float8_e4m3fn)
    up_s, down_s = jnp.asarray(r0["tp/up_s"]), jnp.asarray(r0["tp/down_s"])
    from fp8tpu.kernels.qmatmul import quantize_weights
    x, up, down = tp_inputs()
    ju8, jus = quantize_weights(jnp.asarray(up), "e4m3", axis=-1)
    np.testing.assert_array_equal(np.asarray(ju8).view(np.uint8),
                                  r0["tp/up8"])
    np.testing.assert_array_equal(np.asarray(jus).reshape(-1), r0["tp/up_s"])
    mesh = make_mesh(model=WORLD)
    jdt = getattr(jnp, dt)
    xd = jnp.asarray(x).astype(jdt)
    hd = jnp.asarray(r0["tp/h"]).astype(jdt)
    col = np.asarray(jax.jit(lambda *a: column_parallel_qmatmul(*a, mesh))(
        xd, up8, up_s), np.float32)
    got = np.concatenate([res[r][f"tp/col/{dt}"] for r in range(WORLD)], 1)
    _tp_close(got, col, dt)
    for scatter in (False, True):
        want = np.asarray(jax.jit(lambda *a: row_parallel_qmatmul(
            *a, mesh, overlap_chunks=TP_CHUNKS, scatter=scatter))(
            hd, down8, down_s), np.float32)
        for r in range(WORLD):
            for lay in ("", "chunked/"):
                _tp_close(res[r][f"tp/row/{lay}{dt}/{scatter}"], want, dt)
    want = np.asarray(jax.jit(lambda *a: tp_mlp_block(
        *a, mesh, overlap_chunks=TP_CHUNKS))(xd, up8, up_s, down8, down_s),
        np.float32)
    for r in range(WORLD):
        for lay in ("", "chunked/"):
            _tp_close(res[r][f"tp/mlp/{lay}{dt}"], want, dt)


def _jax_stage(params, x):
    import jax
    from fp8tpu.quant.config import TensorQuantConfig
    from fp8tpu.quant.fakequant import fake_quant
    cfg = TensorQuantConfig(dtype="e4m3", scheme="rne",
                            scaling="per-tensor-max")
    w1 = fake_quant(params["w1"], cfg)
    w2 = fake_quant(params["w2"], cfg)
    h = jax.nn.gelu(fake_quant(x, cfg) @ w1)
    return x + h @ w2


def _gather_rows(res, key, stages, data, stage):
    """The batch from the ranks of one stage row (rank = s * data + d)."""
    return np.concatenate([res[stage * data + d][key] for d in range(data)])


@pytest.mark.parametrize("case", PP_CASES + [(1, WORLD, 2)],
                         ids=lambda c: "x".join(map(str, c)))
def test_pipeline_matches_jax(world, case):
    import jax
    import jax.numpy as jnp
    from fp8tpu.parallel.pipeline import make_pp_mesh, pipeline_apply
    stages, data, micro = case
    params, x = pp_inputs(stages, seed=stages)
    mesh = make_pp_mesh(stages, data)
    want = np.asarray(jax.jit(lambda p, x: pipeline_apply(
        _jax_stage, p, x, mesh, n_microbatches=micro))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    res = world.results()
    key = f"pp/{stages}x{data}x{micro}"
    for s in range(stages):
        got = _gather_rows(res, key, stages, data, s)
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"{key} stage {s}: {err:.3e} of max|y|")
        assert err <= 1e-5, err


def test_pipeline_gradients_and_remat_match_jax(world):
    import jax
    import jax.numpy as jnp
    from fp8tpu.parallel.pipeline import make_pp_mesh, pipeline_apply
    stages, data, micro = PP_GRAD
    params, x = pp_inputs(stages, seed=99)
    mesh = make_pp_mesh(stages, data)

    def loss(p, x):
        return jnp.mean(pipeline_apply(_jax_stage, p, x, mesh,
                                       n_microbatches=micro) ** 2)

    y = np.asarray(jax.jit(lambda p, x: pipeline_apply(
        _jax_stage, p, x, mesh, n_microbatches=micro))(params, x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    res = world.results()
    for remat in (False, True):
        for s in range(stages):
            got = _gather_rows(res, f"ppg/{remat}/y", stages, data, s)
            assert np.abs(got - y).max() <= 1e-5 * np.abs(y).max()
            for k in ("w1", "w2"):
                for d in range(data):
                    g = res[s * data + d][f"ppg/{remat}/{k}"]
                    want = np.asarray(gp[k])[s]
                    rel = np.linalg.norm(g - want) / np.linalg.norm(want)
                    assert rel <= 1e-4, (remat, s, d, k, rel)
            gxs = _gather_rows(res, f"ppg/{remat}/x", stages, data, s)
            rel = np.linalg.norm(gxs - np.asarray(gx)) / np.linalg.norm(gx)
            assert rel <= 1e-4, (remat, s, rel)
    for r in range(WORLD):
        for k in ("y", "w1", "w2", "x"):
            np.testing.assert_array_equal(res[r][f"ppg/True/{k}"],
                                          res[r][f"ppg/False/{k}"])


@pytest.mark.parametrize("case", list(MOE_MESHES))
def test_moe_over_four_ranks_is_bit_equal_to_no_mesh(world, case):
    res = world.results()
    for r in range(WORLD):
        assert res[r][f"moe/{case}/equal"].all(), (
            r, res[r][f"moe/{case}/equal"], res[r][f"moe/{case}/maxdiff"])


def test_shard_params_local_shards_are_jax_s(world):
    import jax
    from fp8tpu.parallel import DECODER_PARAM_RULES, make_mesh, shard_params
    from fp8tpu_torch.models import variables_to_flax
    from fp8tpu_torch.models.transformer import Decoder, tiny_config
    from fp8tpu_torch.quant.interceptor import build_module_table
    res = world.results()
    full = {k[len("sp/full/"):]: torch.from_numpy(v)
            for k, v in res[0].items() if k.startswith("sp/full/")}
    table = build_module_table(Decoder(tiny_config(
        n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, max_seq_len=32)))
    flax = jax.tree.map(lambda t: t.numpy(), variables_to_flax(full, table))
    mesh = make_mesh(data=2, model=4)
    placed = shard_params(flax, mesh, DECODER_PARAM_RULES)
    devices = list(mesh.devices.flat)
    for kp, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        path = "/".join(str(k.key) for k in kp)
        shards = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for r in range(WORLD):
            np.testing.assert_array_equal(res[r][f"sp/flax/{path}"],
                                          shards[devices[r]], err_msg=path)
    # the torch names: the same shards in the torch layout
    for r in range(WORLD):
        q = res[r]["sp/torch/layer_0.attn.q_proj.weight"]
        np.testing.assert_array_equal(
            q.T, res[r]["sp/flax/params/layer_0/attn/q_proj/kernel"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
