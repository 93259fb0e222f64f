"""fp8tpu_torch.utils (stats, bindump, metrics, profiling) against
fp8tpu.utils, JAX on the CPU: statistics and exponent histograms equal,
bindump files equally named and byte-equal, the JAX package's own cases
of tests/test_utils.py mirrored, and the timers on the CPU."""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fp8tpu import utils as ju
from fp8tpu_torch import utils as tu


def _wide(rng, n=4000):
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-40, 40, n))).astype(
        np.float32)
    x[:5] = [0.0, -0.0, 1.0, 2.0 ** -30, -(2.0 ** 39)]
    return x


def test_tensor_stats_equal_to_jax(rng):
    x = _wide(rng)
    want = {k: float(v) for k, v in ju.tensor_stats(jnp.asarray(x)).items()}
    got = {k: float(v) for k, v in tu.tensor_stats(torch.from_numpy(x))
           .items()}
    assert got["absmax"] == want["absmax"]
    assert got["absmin_nonzero"] == want["absmin_nonzero"]
    # a mean and a std are sums, taken in another order
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5)
    np.testing.assert_allclose(got["std"], want["std"], rtol=1e-5)


@pytest.mark.parametrize("lo,hi", [(-40, 40), (-4, 4)])
def test_log2_histogram_equal_to_jax(rng, lo, hi):
    x = _wide(rng)
    want = np.asarray(ju.log2_histogram(jnp.asarray(x), lo, hi))
    got = tu.log2_histogram(torch.from_numpy(x), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_tree_stats_names_leaves_as_jax(rng):
    tree = {"b": [np.ones((2, 3), np.float32), np.arange(3, dtype=np.int32)],
            "a": {"kernel": _wide(rng, 64)}}
    want = ju.tree_stats(jax.tree.map(jnp.asarray, tree))
    got = tu.tree_stats(jax.tree.map(torch.from_numpy, tree))
    assert set(got) == set(want) == {"a/kernel", "b/[0]"}
    for k in want:
        assert float(got[k]["absmax"]) == float(want[k]["absmax"])


def test_stats_window():
    for step in (0, 1, 999, 1000, 2001):
        for w, width in ((1000, 1), (10, 3)):
            assert tu.stats_window_enabled(step, w, width) \
                == ju.stats_window_enabled(step, w, width)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn",
                                   "int8"])
def test_bindump_files_equal_to_jax(tmp_path, rng, dtype):
    x = rng.standard_normal((4, 8)).astype(np.float32) * 8
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jp = ju.bindump_tensor(jx, 7, "layer1/conv", "inp",
                           str(tmp_path / "jax"))
    tp = tu.bindump_tensor(tx, 7, "layer1/conv", "inp",
                           str(tmp_path / "port"))
    assert os.path.basename(tp) == os.path.basename(jp) \
        == f"7_layer1.conv_inp_4x8_{dtype}.bin"
    assert open(tp, "rb").read() == open(jp, "rb").read()


def test_bindump_tree_and_schedule(tmp_path):
    tree = {"w": np.ones((2, 2), np.float32), "s": [np.zeros(3, np.int32)]}
    jp = ju.bindump_tree(jax.tree.map(jnp.asarray, tree), 3, "wt",
                         str(tmp_path / "jax"))
    tp = tu.bindump_tree(jax.tree.map(torch.from_numpy, tree), 3, "wt",
                         str(tmp_path / "port"))
    assert sorted(map(os.path.basename, tp)) \
        == sorted(map(os.path.basename, jp))
    s = tu.BindumpSchedule(start_step=10, end_step=12)
    assert not s.enabled(9) and s.enabled(10) and s.enabled(11)
    assert not s.enabled(12)


def test_tensordump_helper(tmp_path):
    h = tu.TensorDumpHelper(str(tmp_path))
    h.add("mod", "wt", torch.ones(3))
    h.add("mod", "wt", torch.zeros(3))
    with open(h.dump(), "rb") as f:
        d = pickle.load(f)
    assert len(d["mod"]["wt"]) == 2
    np.testing.assert_array_equal(d["mod"]["wt"][0], np.ones(3, np.float32))


def test_metric_logger():
    m = tu.MetricLogger()
    for i in range(10):
        m.update(loss=float(i), imgs_per_s=100.0 + i)
    assert m.loss.count == 10
    assert m.loss.global_avg == 4.5
    assert "loss" in str(m)


def test_smoothed_value_window():
    v = tu.SmoothedValue(window_size=3)
    for x in [1, 2, 3, 4, 5]:
        v.update(x)
    assert v.median == 4.0      # window [3,4,5]
    assert v.global_avg == 3.0


def test_accuracy_equal_to_jax(rng):
    logits = np.asarray([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]], np.float32)
    labels = np.asarray([1, 2])
    top1, top2 = tu.accuracy(torch.from_numpy(logits),
                             torch.from_numpy(labels), topk=(1, 2))
    assert float(top1) == 50.0
    assert float(top2) == 100.0
    logits = rng.integers(0, 4, (64, 10)).astype(np.float32)   # ties
    labels = rng.integers(0, 10, 64)
    want = ju.accuracy(jnp.asarray(logits), jnp.asarray(labels), (1, 3))
    got = tu.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                      (1, 3))
    assert [float(g) for g in got] == [float(w) for w in want]


def test_all_reduce_mean_is_the_identity_without_a_group():
    t = torch.tensor(3.0)
    assert tu.all_reduce_mean(t) is t
    assert tu.all_reduce_mean(2.5) == 2.5


def test_timer_and_benchmark_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    t = tu.Timer().start()
    y = x @ x
    assert t.stop(sync_on={"y": y}) >= 0.0 and t.elapsed >= 0.0
    assert tu.benchmark(lambda a: a @ a, x, iters=3) > 0.0
    with tu.trace(str(tmp_path)):
        with tu.annotate("matmul"):
            x @ x
    assert os.path.exists(tmp_path / "trace.json")
    assert "matmul" in open(tmp_path / "trace.json").read()
