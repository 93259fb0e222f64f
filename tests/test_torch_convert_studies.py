"""Port parity for the convert studies T1 and T2: the plain versions of
fp8tpu_torch.kernels.kexp_convert and fp8tpu_torch.kernels.fp8_linear_study
against the JAX tools' Pallas kernels (tools/kexp_convert.py,
tools/bench_pallas_linear.py) run in interpret mode on the CPU, on the same
numpy-seeded inputs.

The tools' converts call ``pltpu.bitcast``, which has no evaluation rule
outside a kernel, so each is run inside a one-line ``pallas_call`` under
``pltpu.force_tpu_interpret_mode()``.  T1's tool kernel never stores its
output (its sum stays in scratch); the test wraps the tool's own kernel
body in a ``pallas_call`` with the tool's specs plus the store at the last
grid step.  T2's ``R`` is a module global read at trace time and is set to
1 before the first trace.  The tool files are loaded from their paths and
not edited.

Tolerances: e4m3 values are multiples of 2^-9 and the conv sums here stay
far below 2^15, so f32 holds every partial sum of the fp8 conv modes
exactly: those are bit-equal.  bf16 conv sums and dot sums differ only in
the order of f32 additions of exact terms, and the full mode's exp differs
by ulps between XLA and torch, which may move a p by one bf16 step: the
tool and the port are each held to the f64 sum within
``kexp_convert.error_bound``, the bound the card's kernel is held to, at
C = 1.  T2's products may round to neighbouring bf16 values (one bf16
step, 2^-7 relative) on top of the summation order.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fp8tpu_torch.kernels import fp8_linear_study as t2
from fp8tpu_torch.kernels import kexp_convert as t1
from fp8tpu_torch.tools import bench_fp8_linear, kexp_convert

REPO = Path(__file__).resolve().parents[1]
R1, BKV = 2, 3                 # T1's reps and tiles here
N2 = 512                       # T2's output columns here


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def tool(name):
    return _load_tool(name)


def _u8_all():
    return np.arange(256, dtype=np.uint8).reshape(2, 128)


def _in_kernel(fn, u8):
    """fn(u8 array) -> bf16 inside a one-line pallas_call, in interpret
    mode; the result's bf16 bit patterns as int32."""
    def kernel(x_ref, o_ref):
        o_ref[...] = fn(x_ref[...])

    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
            u8.shape, jnp.bfloat16))(jnp.asarray(u8))
    return np.asarray(jax.lax.bitcast_convert_type(out, jnp.uint16)
                      ).astype(np.int32)


# -- (a) the converts, all 256 e4m3 bytes --------------------------------------

@pytest.mark.parametrize("which", ["kexp_bits", "linear_bits", "linear_magic"])
def test_bit_converts_match_the_tools_in_kernel(which):
    mod, fn, port = {
        "kexp_bits": ("kexp_convert", "e4m3_bits_to_bf16",
                      t1.e4m3_bits_to_bf16),
        "linear_bits": ("bench_pallas_linear", "conv_bits",
                        t1.e4m3_bits_to_bf16),
        "linear_magic": ("bench_pallas_linear", "conv_magic",
                         t1.e4m3_magic_to_bf16),
    }[which]
    u8 = _u8_all()
    want = _in_kernel(getattr(tool(mod), fn), u8)
    got = port(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got, want)
    # the NaN bytes keep their sign
    assert got[0, 0x7F] == 0x7FC0 and got[1, 0x7F] == 0xFFC0


@pytest.mark.parametrize("how", ["astype", "bits", "magic"])
def test_converts_give_e4m3_values(how):
    u8 = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    got = t1.convert(u8, how).float().numpy()
    want = u8.numpy().view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    np.testing.assert_array_equal(got[~nan], want[~nan])
    if how != "astype":
        bits = t1.bf16_from_bits(t1.e4m3_bits_to_bf16(u8)).view(torch.int16)
        assert int(bits[0x7F]) == 0x7FC0 and int(bits[0xFF]) == -64


# -- (b) T1 ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def t1_inputs():
    """The tool's recipe at BKV tiles: (q, k8, kb) as JAX arrays and as
    torch tensors with the same bits."""
    rng = np.random.default_rng(0)
    raw = jnp.asarray(rng.standard_normal((BKV, 1, t1.S, t1.D)), jnp.float32)
    k8 = raw.astype(jnp.float8_e4m3fn)
    kb = raw.astype(jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((BKV, 1, t1.G, t1.D)), jnp.bfloat16)
    to_t = {
        "q": torch.from_numpy(np.array(q).view(np.int16)).view(
            torch.bfloat16),
        "k8": torch.from_numpy(np.array(k8).view(np.uint8)).view(
            torch.float8_e4m3fn),
        "kb": torch.from_numpy(np.array(kb).view(np.int16)).view(
            torch.bfloat16),
    }
    return (q, k8, kb), to_t


def tool_stream(q, k, mode):
    """The tool's kernel body for ``mode`` with its specs, R = R1 reps, and
    the missing store of the sum at the last grid step."""
    body = tool("kexp_convert").make_kernel(mode)
    S, D = t1.S, t1.D

    def kernel(q_ref, k_ref, o_ref, acc_ref):
        body(q_ref, k_ref, o_ref, acc_ref)

        @pl.when((pl.program_id(0) == R1 - 1)
                 & (pl.program_id(1) == pl.num_programs(1) - 1))
        def _():
            o_ref[...] = acc_ref[...]

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            kernel, grid=(R1, k.shape[0]),
            in_specs=[
                pl.BlockSpec((1, 1, 8, D), lambda r, i: (i, 0, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1, S, D), lambda r, i: (i, 0, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((8, 128), lambda r, i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            scratch_shapes=[pltpu.VMEM((8, 128), jnp.float32)],
            compiler_params=pltpu.CompilerParams(
                dimension_semantics=("arbitrary", "arbitrary")),
        )(q, k))


@pytest.mark.parametrize("mode", t1.TOOL_MODES)
def test_stream_plain_matches_the_tool_kernel(mode):
    (q, k8, kb), tt = t1_inputs()
    bf16 = mode in t1.BF16_MODES
    want = tool_stream(q, kb if bf16 else k8, mode)
    k = tt["kb"] if bf16 else tt["k8"]
    got, fold = t1.stream_plain(tt["q"], k, mode, reps=R1)
    got = got.numpy()
    assert got.shape == (8, 128) and fold.shape == (R1, BKV)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    if mode in ("conv-astype", "conv-bits"):
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:
        # both against the f64 sum, within the random-walk bound at C = 1:
        # these are f32 sums of n = 6 tile terms on the CPU
        exact, tol, _, _ = t1.error_bound(tt["q"], k, mode, R1, c=1.0)
        exact, tol = exact.numpy(), tol.numpy()
        for name, val in (("tool", want), ("port", got)):
            ratio = np.abs(val.astype(np.float64) - exact) / tol
            assert (ratio <= 1).all(), (name, float(ratio.max()))


def test_full_mode_with_the_hardware_convert_equals_the_bits_one():
    # the port's eighth mode: the same values through the other convert
    _, tt = t1_inputs()
    a = t1.stream_plain(tt["q"], tt["k8"], "full-fp8-astype", reps=R1)
    b = t1.stream_plain(tt["q"], tt["k8"], "full-fp8-bits", reps=R1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_stream_plain_fold_covers_the_whole_tile():
    _, tt = t1_inputs()
    _, fold = t1.stream_plain(tt["q"], tt["k8"], "conv-bits", reps=R1)
    kf = tt["k8"].float()
    want = kf.double().sum((1, 2, 3)).float()
    assert torch.equal(fold[0], want) and torch.equal(fold[1], want)
    # the fold moves with an element far from the corner
    k2 = tt["k8"].clone()
    k2.view(torch.uint8)[1, 0, 400, 77] ^= 0x08
    _, fold2 = t1.stream_plain(tt["q"], k2, "conv-bits", reps=R1)
    assert fold2[0, 1] != fold[0, 1] and fold2[0, 0] == fold[0, 0]


@pytest.mark.parametrize("cold", [False, True])
def test_stream_on_cpu_is_the_plain_version_warm_or_cold(cold):
    _, tt = t1_inputs()
    before = t1.launches
    want = t1.stream_plain(tt["q"], tt["k8"], "dot-fp8-bits", reps=R1)
    got = t1.stream(tt["q"], tt["k8"], "dot-fp8-bits", reps=R1, cold=cold)
    assert t1.launches == before        # no kernel ran on the CPU
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    qr, kr = t1.rep_inputs(tt["q"], tt["k8"], R1, cold)
    assert kr.shape == (R1,) + tuple(tt["k8"].shape)
    assert (kr.stride(0) == 0) != cold
    got5 = t1.stream(qr, kr, "dot-fp8-bits")
    assert torch.equal(got5[0], want[0])


def test_stream_rejects_bad_inputs():
    _, tt = t1_inputs()
    with pytest.raises(ValueError, match="unknown mode"):
        t1.stream(tt["q"], tt["k8"], "conv-magic")
    with pytest.raises(ValueError, match="bf16 k"):
        t1.stream(tt["q"], tt["k8"], "dot-bf16")
    with pytest.raises(ValueError, match="e4m3 payload"):
        t1.stream(tt["q"], tt["kb"], "conv-bits")
    with pytest.raises(ValueError, match="stream needs"):
        t1.stream(tt["q"][:2], tt["k8"], "conv-bits")


# -- (c) T2 ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def t2_inputs():
    """The tool's recipe at N = N2: JAX arrays and torch tensors (the fp8
    payload made by torch from the same f32 weights)."""
    rng = np.random.default_rng(0)
    wf_np = (rng.standard_normal((4096, N2)) * 0.02).astype(np.float32)
    x_np = rng.standard_normal((64, 4096))
    wf = jnp.asarray(wf_np)
    j = {"w8": wf.astype(jnp.float8_e4m3fn), "wb": wf.astype(jnp.bfloat16),
         "x": jnp.asarray(x_np, jnp.bfloat16)}
    wt = torch.from_numpy(wf_np)
    t = {"w8": wt.to(torch.float8_e4m3fn), "wb": wt.to(torch.bfloat16),
         "x": torch.from_numpy(np.array(j["x"]).view(np.int16)).view(
             torch.bfloat16)}
    return j, t


@pytest.fixture
def t2_tool(monkeypatch):
    mod = tool("bench_pallas_linear")
    monkeypatch.setattr(mod, "R", 1)
    return mod


def test_fp8_payload_bytes_equal_jax_astype():
    j, t = t2_inputs()
    want = np.asarray(j["w8"]).view(np.uint8)
    got = t["w8"].view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    # most 0.02 * N(0, 1) weights are e4m3 subnormals (|w| < 2^-6)
    assert float(((got & 0x78) == 0).mean()) > 0.3
    np.testing.assert_array_equal(
        t["wb"].view(torch.int16).numpy(), np.asarray(j["wb"]).view(np.int16))


@pytest.mark.parametrize("mode", t2.MODES)
def test_linear_plain_matches_the_tool_kernel(mode, t2_tool):
    j, t = t2_inputs()
    key = "wb" if mode == "pl-bf16" else "w8"
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(t2_tool.pl_linear(j["x"], j[key], mode)
                          ).astype(np.float32)
    got = t2.linear_plain(t["x"], t[key], mode)
    assert got.dtype == torch.bfloat16 and got.shape == (64, N2)
    got = got.float().numpy()
    mag = (t["x"].double().abs()
           @ t2.weight_values(t[key], mode).double().abs()).numpy()
    tol = 2 * 4096 * 2.0 ** -24 * mag + 2.0 ** -7 * np.abs(want)
    assert (np.abs(got - want) <= tol).all()


def test_linear_converts_agree_bit_for_bit():
    _, t = t2_inputs()
    outs = [t2.linear_plain(t["x"], t["w8"], m).view(torch.int16)
            for m in ("pl-astype", "pl-bits", "pl-magic")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_linear_on_cpu_is_the_plain_version_and_counts_nothing():
    _, t = t2_inputs()
    before = t2.launches
    for cold in (False, True):
        got = t2.linear(t["x"], t["w8"], "pl-magic", reps=2, cold=cold)
        assert torch.equal(got, t2.linear_plain(t["x"], t["w8"], "pl-magic"))
    assert t2.launches == before
    wr = t2.rep_weights(t["w8"], 3, cold=False)
    assert wr.shape == (3, 4096, N2) and wr.stride(0) == 0
    assert t2.rep_weights(t["w8"], 3, cold=True).is_contiguous()
    with pytest.raises(ValueError, match="pl-bf16 needs bf16"):
        t2.linear(t["x"], t["w8"], "pl-bf16")
    with pytest.raises(ValueError, match="unknown mode"):
        t2.linear(t["x"], t["w8"], "pl-exact")


# -- the entry points --------------------------------------------------------------

def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kexp_convert.run("cuda", bkv=1, reps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_fp8_linear.run("cuda", n=256, reps=1)


def test_kexp_convert_entry_point_on_cpu(capsys):
    res = kexp_convert.run("cpu", bkv=2, reps=2)
    out = capsys.readouterr().out
    assert "bits-convert mismatches: 0" in out
    assert res["conv-astype mismatches"] == 0
    assert set(res["modes"]) == set(t1.MODES)
    assert res["modes"]["conv-bits"]["fold"].shape == (2, 2)


def test_bench_fp8_linear_entry_point_on_cpu(capsys):
    res = bench_fp8_linear.run("cpu", n=256, reps=2)
    out = capsys.readouterr().out
    assert "pl-bits: exact vs in-kernel astype dot" in out
    assert "pl-magic: exact" in out
    assert all(res[f"{m} mismatches"] == 0
               for m in ("pl-astype", "pl-bits", "pl-magic"))
