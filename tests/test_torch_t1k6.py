"""Port parity for T1's packed bits convert and K6's one-launch ring write.

(a) ``kexp_convert.bits_pair_twin``, the kernel's packed e4m3 -> bf16
    convert step for step in int64 (the bf16x2 multiply through f32, exact
    for a product of two bf16 values), against the tool's
    ``e4m3_bits_to_bf16`` run in JAX (inside a one-line ``pallas_call`` in
    interpret mode, as ``pltpu.bitcast`` needs) over all 65536 byte pairs,
    at both byte positions T1 converts a word in.
(b) ``inplace.ring_store_plain`` against two ``fp8tpu.kernels.inplace.
    dyn_store(..., interpret=True)`` calls and ``jnp.mod(head + 1, S)``,
    as the JAX decode step writes its ring, on a small ring, for two
    consecutive steps.  At these widths the JAX function stores through
    ``dynamic_update_slice``, which clamps an index past the ring where
    its Pallas kernel (and the port) take it mod S; the JAX calls get the
    index mod S, which is what its kernel stores at.
(c) The tiny ring decoder through ``_steps_impl``, whose ring write is now
    one ``ring_store`` a step advancing ``head`` in place, against the JAX
    package: logits, ring bytes and head.

Tolerances: (a) and (b) are bit-equal; (c) uses the serving parity
test's own against the un-jitted JAX functions (4e-3 of max|logit|, ring
payload bytes at least 0.99 equal, scales within a bf16 step).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

import test_torch_convert_studies as studies
import test_torch_serve_model as serve
from fp8tpu.kernels.inplace import dyn_store as j_dyn_store
from fp8tpu_torch.kernels import inplace
from fp8tpu_torch.kernels import kexp_convert as t1
from fp8tpu_torch.serve import RingKVCache

L, SLOTS, KV, D, S = 2, 2, 2, 16, 8      # the small ring of (b)


# -- (a) the packed bits convert --------------------------------------------------

def _tool_bits(u8: np.ndarray) -> np.ndarray:
    return studies._in_kernel(studies.tool("kexp_convert").e4m3_bits_to_bf16,
                              u8).astype(np.int64)


@pytest.mark.parametrize("half", [0, 1], ids=["bytes01", "bytes23"])
def test_packed_bits_convert_matches_the_tool_on_every_pair(half):
    pairs = np.arange(65536, dtype=np.int64)
    lo, hi = pairs & 0xFF, pairs >> 8
    # the pair at bytes (2 half, 2 half + 1), the other two bytes busy
    words = np.where(half == 0, 0xA5A50000 | pairs, (pairs << 16) | 0xA5A5)
    got = t1.bits_pair_twin(torch.from_numpy(words), 2 * half,
                            2 * half + 1).numpy()
    table = _tool_bits(np.arange(256, dtype=np.uint8).reshape(2, 128)
                       ).reshape(-1)
    want = table[lo] | (table[hi] << 16)
    np.testing.assert_array_equal(got, want)


def test_packed_bits_convert_gives_e4m3_values():
    """Every byte's half, read as bf16, is the e4m3 value (NaN -> NaN with
    the byte's sign)."""
    b = np.arange(256, dtype=np.int64)
    got = t1.bits_pair_twin(torch.from_numpy(b | (b << 8))).numpy()
    for half in (got & 0xFFFF, got >> 16):
        vals = t1.bf16_from_bits(torch.from_numpy(half)).float().numpy()
        want = b.astype(np.uint8).view(ml_dtypes.float8_e4m3fn).astype(
            np.float32)
        nan = np.isnan(want)
        assert (np.isnan(vals) == nan).all()
        np.testing.assert_array_equal(vals[~nan], want[~nan])
        assert half[0x7F] == 0x7FC0 and half[0xFF] == 0xFFC0


# -- (b) the ring write ---------------------------------------------------------

RING_TYPES = {"int8": (jnp.int8, torch.int8),
              "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _ring_case(rng, kind):
    j_t, t_t = RING_TYPES[kind]
    bk = SLOTS * KV
    kv = (rng.standard_normal((S, 2, L, bk, D)) * 40).astype(np.float32)
    sc = rng.random((S, 2, L, bk)).astype(np.float32)
    steps = [((rng.standard_normal((2, L, bk, D)) * 40).astype(np.float32),
              rng.random((2, L, bk)).astype(np.float32)) for _ in range(2)]
    jkv = jnp.asarray(kv).astype(j_t)
    tkv = torch.from_numpy(np.asarray(jkv).view(np.uint8).copy()).view(t_t)
    return j_t, t_t, jkv, tkv, sc, steps


@pytest.mark.parametrize("idx", [0, S - 1, S + 3, -1],
                         ids=["first", "last", "past", "negative"])
@pytest.mark.parametrize("kind", list(RING_TYPES))
def test_ring_store_plain_matches_two_jax_dyn_stores(rng, kind, idx):
    j_t, t_t, jkv, tkv, sc, steps = _ring_case(rng, kind)
    jsc, tsc = jnp.asarray(sc), torch.from_numpy(sc.copy())
    jhead = jnp.int32(idx)
    thead = torch.tensor(idx, dtype=torch.int32)
    head_tensor = thead
    for slab8, slabs in steps:                  # two consecutive steps
        js8 = jnp.asarray(slab8).astype(j_t)
        row = jnp.mod(jhead, S)
        jkv = j_dyn_store(jkv, js8, row, interpret=True)
        jsc = j_dyn_store(jsc, jnp.asarray(slabs), row, interpret=True)
        jhead = jnp.mod(jhead + 1, S)
        ts8 = torch.from_numpy(np.asarray(js8).view(np.uint8).copy()).view(
            t_t)
        before = inplace.launches
        inplace.ring_store_plain(tkv, ts8, tsc, torch.from_numpy(slabs),
                                 thead, S)
        assert inplace.launches == before
    assert thead is head_tensor and int(thead) == int(jhead)
    np.testing.assert_array_equal(tkv.view(torch.uint8).numpy(),
                                  np.asarray(jkv).view(np.uint8))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


def test_ring_store_on_the_cpu_is_the_plain_version(rng):
    """The wrapper takes the plain version for CPU tensors, launches
    nothing and leaves the ticket alone."""
    ring = RingKVCache.create(L, SLOTS, S, KV, D, "int8", device="cpu")
    ref = RingKVCache.create(L, SLOTS, S, KV, D, "int8", device="cpu")
    slab8 = torch.from_numpy(rng.integers(-127, 128, (2, L, SLOTS * KV, D),
                                          dtype=np.int8))
    slabs = torch.from_numpy(rng.random((2, L, SLOTS * KV),
                                        dtype=np.float32))
    head = ring.head
    before = inplace.launches
    for _ in range(S + 2):
        inplace.ring_store(ring.kv8, slab8, ring.sc, slabs, ring.head, S,
                           ring.ticket)
        inplace.ring_store_plain(ref.kv8, slab8, ref.sc, slabs, ref.head, S)
        slab8 = slab8 + 1
    assert inplace.launches == before and ring.head is head
    assert int(ring.head) == int(ref.head) == 2 and int(ring.ticket) == 0
    assert torch.equal(ring.kv8, ref.kv8) and torch.equal(ring.sc, ref.sc)


def test_ring_cache_owns_a_zeroed_ticket():
    a = RingKVCache.create(L, SLOTS, S, KV, D, "int8", device="cpu")
    b = RingKVCache(a.kv8, a.sc, a.head.clone())
    assert a.ticket.dtype == torch.int32 and a.ticket.shape == (1,)
    assert int(a.ticket) == int(b.ticket) == 0
    assert a.ticket.data_ptr() != b.ticket.data_ptr()


# -- (c) the ring decoder through the new write ----------------------------------

@pytest.mark.parametrize("fmt,kv_fmt", [("e4m3", "int8"), ("e4m3", "e4m3")])
def test_ring_decoder_matches_jax_through_ring_store(monkeypatch, fmt,
                                                     kv_fmt):
    calls = []
    orig = inplace.ring_store

    def counting(*a, **kw):
        calls.append(a[4])                     # the head it advanced
        return orig(*a, **kw)
    monkeypatch.setattr(inplace, "ring_store", counting)
    with jax.disable_jit():
        pairs, jr, tr = serve._run_both(fmt, kv_fmt, n_steps=3)
    serve._check_run(pairs, jr, tr, serve.EAGER_TOL, 0.99)
    assert len(calls) == 3                     # one ring write a step
    assert all(h is tr.head for h in calls)    # advanced in place
    assert int(tr.ticket) == 0
