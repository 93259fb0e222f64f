"""torchvision ResNet state_dicts -> the port's ResNet: a copy of the
ResNet half of the JAX package's ``tools/convert_torch.py`` (NumPy only).

:func:`convert_resnet` maps a torchvision ResNet state_dict (resnet18 /
34 / 50 / 101, resnext, wide_resnet: anything built from BasicBlock /
Bottleneck with the ``layer{L}.{B}.conv{i} / bn{i} / downsample`` naming)
onto Flax-layout variables of ``ResNet(cfg)`` with ``norm_mode='bn'``,
exactly as the JAX package's function does;
``models.variables_from_flax`` then gives the port's state_dict.  This is
the reference's imagenet_test.py pretrained-load path
(``examples.resnet_ptq --torch_ckpt``).
"""

from __future__ import annotations

import numpy as np


def _np(t):
    """torch.Tensor | ndarray -> float32 / int ndarray on the host."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv(t):
    """torch conv weight OIHW -> Flax HWIO (grouped convs included: the I
    axis is already in / groups on both sides)."""
    return np.transpose(_np(t), (2, 3, 1, 0))


def _dense(t):
    return np.ascontiguousarray(_np(t).T)


class _Taken:
    """Tracks which state_dict keys the mapping consumed, so leftovers (a
    wrong architecture guess) fail loudly instead of silently."""

    def __init__(self, sd):
        self.sd = dict(sd)
        self.used = set()

    def __call__(self, key):
        self.used.add(key)
        return self.sd[key]

    def __contains__(self, key):
        return key in self.sd

    def leftovers(self, ignore=()):
        return sorted(k for k in self.sd if k not in self.used
                      and not any(k.startswith(p) or k.endswith(p)
                                  for p in ignore))


def convert_resnet(state_dict, cfg) -> dict:
    """torchvision ResNet state_dict -> Flax-layout ResNet variables
    ({"params": ..., "batch_stats": ...}) for ``ResNet(cfg)`` with
    ``norm_mode='bn'``."""
    sd = _Taken(state_dict)
    params, stats = {}, {}

    def norm(pdst, sdst, name, src):
        pdst[name] = {"bn": {"scale": _np(sd(f"{src}.weight")),
                             "bias": _np(sd(f"{src}.bias"))}}
        sdst[name] = {"bn": {"mean": _np(sd(f"{src}.running_mean")),
                             "var": _np(sd(f"{src}.running_var"))}}

    params["conv1"] = {"kernel": _conv(sd("conv1.weight"))}
    norm(params, stats, "norm1", "bn1")

    n_convs = 3 if cfg.bottleneck else 2
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            tp = f"layer{stage + 1}.{b}"
            fp = f"stage{stage}_block{b}"
            bp, bs = {}, {}
            for i in range(1, n_convs + 1):
                bp[f"conv{i}"] = {"kernel": _conv(sd(f"{tp}.conv{i}.weight"))}
                norm(bp, bs, f"norm{i}", f"{tp}.bn{i}")
            if f"{tp}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {
                    "kernel": _conv(sd(f"{tp}.downsample.0.weight"))}
                norm(bp, bs, "downsample_norm", f"{tp}.downsample.1")
            params[fp] = bp
            stats[fp] = bs

    params["fc"] = {"kernel": _dense(sd("fc.weight")),
                    "bias": _np(sd("fc.bias"))}
    left = sd.leftovers(ignore=("num_batches_tracked",))
    if left:
        raise ValueError(f"unconsumed torch keys (architecture mismatch?): "
                         f"{left[:8]}{'...' if len(left) > 8 else ''}")
    return {"params": params, "batch_stats": stats}
