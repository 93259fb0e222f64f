"""Quantization-aware fine-tuning, the port of the JAX package's
``examples/resnet_qat.py`` (the reference's imagenet_qat.py flow): the PTQ
policy with the weights re-quantized inside each step (straight-through),
SGD with momentum 0.9, BatchNorm statistics updated in the step, a
quantized evaluation each epoch and a checkpoint with the policy
(imagenet_qat.py:104-224, 209-219).  On the card the casts run on K1.

    python -m fp8tpu_torch.examples.resnet_qat --epochs 2

``--imagenet_dir`` trains on an ImageFolder tree instead of the synthetic
patterns: 1024 images drawn in a shuffled order, each through the
reference's random-resized-crop + flip transform
(``fp8tpu_torch.data.imagenet``), as the JAX script draws them.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.examples._common import (Log, add_device_flag, from_flax,
                                           sync)
from fp8tpu_torch.linen import init_params
from fp8tpu_torch.models import variables_to_flax
from fp8tpu_torch.models.resnet import RESNET_EXEMPT, ResNet, ResNetConfig
from fp8tpu_torch.quant.interceptor import build_module_table, quantized_apply
from fp8tpu_torch.quant.policy import get_policy
from fp8tpu_torch.utils import MetricLogger, accuracy, save_checkpoint


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="e4m3", choices=["e4m3", "e3m4",
                                                       "hybrid"])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--imagenet_dir", default=None,
                   help="real ImageFolder train tree (class-per-folder); "
                        "random-resized-crop + flip transform")
    p.add_argument("--num-classes", type=int, default=8)
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    args = parse(argv)
    device = resolve_device(args.device)
    log_line = Log()
    if args.imagenet_dir:
        from fp8tpu_torch.data.imagenet import (list_image_folder,
                                                load_image_train)
        paths, labels, classes = list_image_folder(args.imagenet_dir)
        rng = np.random.default_rng(0)
        # shuffle before truncating: the listing is class-sorted
        order = rng.permutation(len(paths))[:1024]
        xs = np.stack([load_image_train(paths[i], rng) for i in order])
        ys = np.asarray([labels[i] for i in order], np.int32)
        cfg = ResNetConfig(stage_sizes=(1, 1), width=16,
                           num_classes=len(classes), small_images=False)
    else:
        # learnable class-conditional patterns: QAT top-1 is a real signal
        from fp8tpu_torch.data import pattern_images
        xs, ys = pattern_images(1024, size=32, n_classes=args.num_classes,
                                seed=0)
        cfg = ResNetConfig(stage_sizes=(1, 1), width=16,
                           num_classes=args.num_classes, small_images=True)
    with torch.device(device):
        model = ResNet(cfg)
    init_params(model, torch.Generator(device).manual_seed(2))
    model = from_flax(model, variables)
    x = torch.from_numpy(np.ascontiguousarray(xs.transpose(0, 3, 1, 2)))
    x, y = x.to(device), torch.from_numpy(ys).long().to(device)

    # QAT policy: the PTQ preset, weights re-quantized inside the step
    # (live fake-quant like the reference's training-mode hooks).
    policy = get_policy(args.dtype).with_exempt(*RESNET_EXEMPT)
    table = build_module_table(model)
    params = dict(model.named_parameters())
    state = {**params, **dict(model.named_buffers())}
    opt = torch.optim.SGD(params.values(), lr=args.lr, momentum=0.9)

    def qat_apply(xb, train=False):
        model.train(train)
        return quantized_apply(model, policy, xb, params=state,
                               module_table=table)

    log = MetricLogger()
    bs = args.batch_size
    losses, step_s, top1 = [], [], None
    for epoch in range(args.epochs):
        for step in range(args.steps_per_epoch):
            i = (step * bs) % (x.shape[0] - bs)
            sync(device)
            t0 = time.perf_counter()
            loss = F.cross_entropy(qat_apply(x[i:i + bs], train=True),
                                   y[i:i + bs])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            loss = float(loss.detach())
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            log.update(loss=loss)
        with torch.no_grad():
            top1 = float(accuracy(qat_apply(x[:64]), y[:64])[0])
        log_line(f"epoch {epoch}: {log}  quantized top-1 {top1:.1f}")
        if args.checkpoint_dir:
            trace = {n: opt.state[p]["momentum_buffer"]
                     for n, p in params.items() if p in opt.state}
            save_checkpoint(args.checkpoint_dir,
                            epoch * args.steps_per_epoch + step,
                            variables_to_flax(state, table),
                            {"trace": trace}, policy=policy)
    model.eval()

    def quantized_eval(xb):
        with torch.no_grad():
            return qat_apply(xb)

    return {"lines": log_line.lines, "losses": losses, "step_s": step_s,
            "images_per_s": [bs / s for s in step_s], "model": model,
            "top1": top1, "eval": quantized_eval}


if __name__ == "__main__":
    main()
