"""P3's host side on the CPU: the plain version's square root (correctly
rounded by construction, held to numpy's f32 root), the grouped update
``adam8_update_many`` leaf by leaf against ``adam8_update_plain``, and the
walk and leaf table the kernel is given.  The kernel's routes themselves
run only on the card (tests/test_torch_gpu.py, chip_smoke.py's p3)."""

import numpy as np
import pytest
import torch

from fp8tpu_torch.kernels import adam8
from fp8tpu_torch.training import adamw_8bit


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().numpy().view(np.uint32)


def _midpoint_squares(rng, n: int) -> np.ndarray:
    """f32 values next to the squares of midpoints between neighbouring f32
    roots: x = f32(m^2) and its two neighbours, where the correctly
    rounded root turns on the last bits."""
    r = _f32(np.exp(rng.uniform(-40, 40, n)))
    up = np.nextafter(r, _f32(np.inf))
    m = (r.astype(np.float64) + up.astype(np.float64)) / 2
    x = _f32(m * m)
    return np.concatenate([x, np.nextafter(x, _f32(0)),
                           np.nextafter(x, _f32(np.inf))])


def test_sqrt_is_correctly_rounded_next_to_midpoints():
    """The plain version's root against numpy's (IEEE, correctly rounded)
    on values built to sit next to f32 midpoints."""
    x = _midpoint_squares(np.random.default_rng(0), 200_000)
    got = adam8._sqrt(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), np.sqrt(x).view(np.uint32))


def test_sqrt_matches_numpy_on_a_large_random_sample():
    rng = np.random.default_rng(1)
    bits = rng.integers(0x00800000, 0x7F800000, 2_000_000, dtype=np.uint32)
    x = bits.view(np.float32)
    got = adam8._sqrt(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), np.sqrt(x).view(np.uint32))


@pytest.mark.parametrize("off", [-1, 1])
def test_round_root_repairs_a_root_one_step_off(off):
    """Given a root one f32 step off (as an f64 root one ulp off can round),
    the correction lands on the correctly rounded one: the plain version
    does not depend on the host's f64 sqrt being exact."""
    x = _midpoint_squares(np.random.default_rng(2), 50_000)
    want = np.sqrt(x)
    wrong = np.nextafter(want, _f32(np.inf if off > 0 else 0))
    got = adam8._round_root(torch.from_numpy(x), torch.from_numpy(wrong))
    np.testing.assert_array_equal(_bits(got), want.view(np.uint32))


def test_sqrt_edges_as_before():
    """Zeros keep their sign, subnormals flush, inf stays, a negative gives
    the f64 root's NaN."""
    x = torch.tensor([0.0, -0.0, 1e-40, -1e-40, float("inf"), 4.0, -4.0])
    got = adam8._sqrt(x)
    old = adam8._flush(torch.sqrt(adam8._flush(x).double()).float())
    np.testing.assert_array_equal(_bits(got), _bits(old))


# -- the grouped update -------------------------------------------------------

def _state(rng, n, lo=-18.0, hi=0.0, warm=3, zero_block=False):
    """A moment state ``warm`` steps in (made by the plain version) and a
    gradient, for a leaf of n elements."""
    nb = -(-n // adam8.BLOCK)
    st = [torch.zeros((nb, adam8.BLOCK), dtype=torch.int8), torch.zeros(nb),
          torch.zeros((nb, adam8.BLOCK), dtype=torch.float8_e4m3fn),
          torch.zeros(nb)]

    def grad():
        g = (rng.standard_normal(n) * np.exp(rng.uniform(lo, hi, n)))
        if zero_block:
            g[:adam8.BLOCK] = 0.0
        return torch.from_numpy(g.astype(np.float32))

    for c in range(1, warm + 1):
        args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                               *adam8.bias_corrections(0.9, 0.999, c))
        adam8.adam8_update_plain(torch.empty(n), grad(), *st, args, "store")
    return grad(), st


# (name, shape, mode, state keywords, through the Dense (in, out) view)
MIXED = [("one", (1,), "apply", {}, False),
         ("255", (255,), "apply_decay", {}, False),
         ("257", (257,), "apply", {}, False),
         ("store", (7, 11, 3), "store", {}, False),
         ("zero block", (1024,), "apply_decay", {"zero_block": True}, False),
         ("subnormal g*g", (2048,), "apply_decay",
          {"lo": -60.0, "hi": -40.0}, False),
         ("dense", (512, 64), "apply_decay", {}, True),     # (out, in)
         ("dense masked", (256, 96), "apply", {}, True)]


def _mixed_leaves(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for name, shape, mode, kw, dense in MIXED:
        n = int(np.prod(shape))
        g, st = _state(rng, n, **kw)
        p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        g = g.reshape(shape)
        out.append((name, p, g, st, mode, dense))
    return out


def _leaf(p, g, st, mode, dense):
    return adam8.Leaf(p.t() if dense else p, g.t() if dense else g, *st,
                      mode=mode)


def test_update_many_plain_equals_leaf_by_leaf():
    """``adam8_update_many`` on CPU tensors against ``adam8_update_plain``
    a leaf at a time: parameters (through the Dense views), payload bytes
    and scales bit for bit, over a table of every kind of leaf."""
    args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                           *adam8.bias_corrections(0.9, 0.999, 4),
                           weight_decay=1e-4, neg_lr=-1e-3)
    many = _mixed_leaves()
    one = [(name, p.clone(), g.clone(), [t.clone() for t in st], mode, d)
           for name, p, g, st, mode, d in many]
    adam8.reset_launches()
    adam8.adam8_update_many([_leaf(p, g, st, mode, d)
                             for _, p, g, st, mode, d in many], args)
    assert (adam8.launches, adam8.leaves_covered) == (0, 0)  # no kernel
    for (name, p, _, st, _, _), (_, p1, g1, st1, mode, d) in zip(many, one):
        adam8.adam8_update_plain(*_leaf(p1, g1, st1, mode, d)[:6], args,
                                 mode)
        np.testing.assert_array_equal(_bits(p), _bits(p1), err_msg=name)
        for a, b in zip(st, st1):
            np.testing.assert_array_equal(
                a.view(torch.uint8).numpy(), b.view(torch.uint8).numpy(),
                err_msg=name)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, device="meta")


@pytest.mark.parametrize("where", ["cpu-leaf-first", "meta-leaf-first",
                                   "one-leaf-g-elsewhere"])
def test_leaves_on_more_than_one_device_raise(where):
    """P3 takes its plain version only when every tensor of every leaf
    lies on the CPU: leaves spread over devices raise before any update,
    whichever leaf comes first (a meta tensor stands for a card's)."""
    args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                           *adam8.bias_corrections(0.9, 0.999, 2),
                           weight_decay=1e-4, neg_lr=-1e-3)
    rng = np.random.default_rng(5)
    g, st = _state(rng, 300, warm=1)
    p = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    before = [_bits(p)] + [t.view(torch.uint8).numpy().copy() for t in st]
    cpu = adam8.Leaf(p, g, *st)
    other = adam8.Leaf(*(_meta(t) for t in cpu[:6]))
    with pytest.raises(ValueError, match="one CUDA device"):
        if where == "cpu-leaf-first":
            adam8.adam8_update_many([cpu, other], args)
        elif where == "meta-leaf-first":
            adam8.adam8_update_many([other, cpu], args)
        else:
            adam8.adam8_update(p, _meta(g), *st, args)
    after = [_bits(p)] + [t.view(torch.uint8).numpy() for t in st]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


def test_walks():
    """The walk P3 takes: 16-byte loads of an aligned contiguous leaf; the
    staged tile for a transposed view with rows of a multiple of 256 and
    32 storage columns at a time (every Dense weight of the large decoder);
    strided accesses otherwise."""
    for out_, in_ in ((768, 768), (256, 768), (2304, 768), (768, 2304)):
        w = torch.zeros(out_, in_)
        assert adam8.walk_of(w.t()) == "tile", (out_, in_)
    assert adam8.walk_of(torch.zeros(300, 257)) == "vector"
    assert adam8.walk_of(torch.zeros(200, 64).t()) == "strided"  # 200 % 256
    assert adam8.walk_of(torch.zeros(256, 48).t()) == "strided"  # 48 % 32
    assert adam8.walk_of(torch.zeros(1001)[1:]) == "strided"     # unaligned


def test_leaf_table_layout_and_reuse():
    """The table's rows (the kernel's Leaf: pointers, n, geometry, first
    unit, walk | mode << 32), its units, and its reuse: kept while every
    pointer, shape and mode is the same, rebuilt when one changes."""
    many = _mixed_leaves(1)
    leaves = [_leaf(p, g, st, mode, d) for _, p, g, st, mode, d in many]
    tab = adam8.leaf_table(leaves)
    rows = tab.table.numpy()
    assert rows.shape == (len(leaves), 12)
    first = 0
    for row, lf in zip(rows, leaves):
        walk, cols, s0, s1 = adam8._geometry(lf)
        assert list(row[:6]) == [t.data_ptr() for t in lf[:6]]
        assert list(row[6:10]) == [lf.p.numel(), cols, s0, s1]
        assert row[10] == first
        assert row[11] == walk | (adam8.MODES[lf.mode] << 32)
        first += adam8._units(lf.p.numel(), walk, cols)
    assert tab.units == first and tab.tiles
    # the (512, 64) Dense weight, (64, 512) in its view: 2 strips of 32
    # in-columns x 2 bands of 256 out-rows
    assert adam8._units(512 * 64, adam8.WALKS["tile"], 512) == 4
    assert adam8.leaf_table(leaves, tab) is tab
    moved = list(leaves)
    moved[2] = moved[2]._replace(g=moved[2].g.clone())
    assert adam8.leaf_table(moved, tab) is not tab
    assert adam8.leaf_table(leaves[:3] + [leaves[3]._replace(mode="apply")]
                            + leaves[4:], tab) is not tab


def test_adamw_8bit_step_equals_plain_leaf_by_leaf():
    """``Adam8W.step`` through the grouped update (masked and unmasked
    decay) leaves the parameters that per-leaf plain updates give."""
    rng = np.random.default_rng(2)
    init = {"w": rng.standard_normal((40, 24)).astype(np.float32),
            "b": rng.standard_normal(24).astype(np.float32)}
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ref = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = adamw_8bit(params, 1e-3, mask={"w": True, "b": False})
    st = {k: [torch.zeros((-(-p.numel() // 256), 256), dtype=torch.int8),
              torch.zeros(-(-p.numel() // 256)),
              torch.zeros((-(-p.numel() // 256), 256),
                          dtype=torch.float8_e4m3fn),
              torch.zeros(-(-p.numel() // 256))] for k, p in ref.items()}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    for step in range(1, 4):
        for k, p in params.items():
            grads[k].copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
            p.grad = grads[k]
        opt.step()
        args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                               *adam8.bias_corrections(0.9, 0.999, step),
                               weight_decay=1e-4, neg_lr=-1e-3)
        for k, p in ref.items():
            adam8.adam8_update_plain(p, grads[k], *st[k], args,
                                     "apply_decay" if k == "w" else "apply")
    for k in init:
        np.testing.assert_array_equal(_bits(params[k]), _bits(ref[k]))
