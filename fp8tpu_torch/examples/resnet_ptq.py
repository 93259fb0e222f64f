"""ResNet post-training quantization, the port of the JAX package's
``examples/resnet_ptq.py`` (the reference's ImageNet PTQ recipe,
examples/inference/classifier/imagenet_test.py):

  baseline eval -> quantize_model -> calibration sweep -> BN -> ScaleShift
  fusion -> quantized eval, with the reference's exempt-layer policy
  (first conv + classifier head) and dtype sweep (launch.py:14-80).

Runs on synthetic data by default (learnable class-conditional patterns,
``fp8tpu_torch.data.pattern_images``); ``--data_npz`` takes {x: (N, H, W,
C), y: (N,)} arrays.  On the card the casts run on K1.

    python -m fp8tpu_torch.examples.resnet_ptq --model resnet50 --sweep

``--torch_ckpt`` loads a pretrained torchvision ResNet state_dict
(``tools.convert_torch.convert_resnet``) in place of the random weights.
The vision ``tiny_*`` families and ``--imagenet_dir`` wait for the vision
models and the ImageNet loader, and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from fp8tpu_torch import quantize_model
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.examples._common import (VISION, Clock, Log,
                                           add_device_flag, from_flax)
from fp8tpu_torch.linen import init_params
from fp8tpu_torch.models.resnet import RESNET_EXEMPT, ResNet, ResNetConfig
from fp8tpu_torch.utils import MetricLogger, accuracy

RESNETS = {
    "resnet18": ResNetConfig(stage_sizes=(2, 2, 2, 2)),
    "resnet50": ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True),
    "resnext50_32x4d": ResNetConfig(stage_sizes=(3, 4, 6, 3),
                                    bottleneck=True, groups=32,
                                    base_width=4),
    "wide_resnet50_2": ResNetConfig(stage_sizes=(3, 4, 6, 3),
                                    bottleneck=True, base_width=128),
    "tiny": ResNetConfig(stage_sizes=(1, 1), width=16, small_images=True),
    "tiny_resnext": ResNetConfig(stage_sizes=(1, 1), width=16,
                                 bottleneck=True, groups=4, base_width=32,
                                 small_images=True),
}
VISION_MODELS = ("tiny_vgg", "tiny_mobilenet", "tiny_inception",
                 "tiny_densenet", "tiny_shufflenet", "tiny_squeezenet",
                 "tiny_mbconv", "tiny_mbconv_hs", "tiny_vit")


def get_model(name: str, num_classes: int, norm_mode: str = "bn",
              device="cuda", seed: Optional[int] = None) -> ResNet:
    """The script's ResNet ``name`` on ``device``, its conv and Dense
    weights drawn from ``seed`` when one is given."""
    if name in VISION_MODELS:
        raise NotImplementedError(f"--model {name} needs {VISION}")
    cfg = dataclasses.replace(RESNETS[name], num_classes=num_classes,
                              norm_mode=norm_mode)
    dev = resolve_device(device)
    with torch.device(dev):
        model = ResNet(cfg)
    if seed is not None:
        init_params(model, torch.Generator(dev).manual_seed(seed))
    return model


def load_data(args, device):
    """(images NCHW f32, labels) on ``device``."""
    if args.imagenet_dir:
        raise NotImplementedError(f"--imagenet_dir needs {VISION}")
    if args.data_npz:
        d = np.load(args.data_npz)
        x, y = d["x"].astype(np.float32), d["y"]
    else:
        # Learnable synthetic patterns: class-conditional frequency
        # content + noise, so PTQ top-1 deltas mean something.
        from fp8tpu_torch.data import pattern_images
        hw = 32 if args.model.startswith("tiny") else 224
        x, y = pattern_images(args.num_samples, size=hw,
                              n_classes=min(args.num_classes, 8), seed=0)
    x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return x.to(device), torch.from_numpy(np.asarray(y)).long().to(device)


def evaluate(apply_fn, x, y, batch: int, log: MetricLogger):
    """Mean top-1 over whole batches, and the first batch's logits."""
    n = x.shape[0] // batch * batch
    top1s, first = [], None
    with torch.no_grad():
        for i in range(0, n, batch):
            logits = apply_fn(x[i:i + batch])
            first = logits if first is None else first
            top1, top5 = accuracy(logits, y[i:i + batch], topk=(1, 5))
            top1s.append(float(top1))
            log.update(top1=float(top1), top5=float(top5))
    return float(np.mean(top1s)), first


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="tiny",
                   choices=["tiny", "resnet18", "resnet50",
                            "resnext50_32x4d", "wide_resnet50_2",
                            "tiny_resnext", *VISION_MODELS])
    p.add_argument("--dtype", default="e4m3",
                   choices=["e4m3", "e3m4", "hybrid", "e5m2"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-calibration-batches", type=int, default=4)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--num-samples", type=int, default=256)
    p.add_argument("--data_npz", default=None)
    p.add_argument("--imagenet_dir", default=None,
                   help="ImageFolder val tree (class-per-folder); "
                        "preprocessed with the reference's val transform")
    p.add_argument("--sweep", action="store_true",
                   help="sweep all dtypes (launch.py behavior)")
    p.add_argument("--torch_ckpt", default=None,
                   help="pretrained torchvision state_dict (.pt/.pth), "
                        "evaluated instead of random weights")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    args = parse(argv)
    device = resolve_device(args.device)
    log_line = Log()
    model = get_model(args.model, args.num_classes, device=device, seed=2)
    x, y = load_data(args, device)
    if args.torch_ckpt:
        from fp8tpu_torch.tools.convert_torch import convert_resnet
        blob = torch.load(args.torch_ckpt, map_location="cpu",
                          weights_only=True)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) \
            else blob
        model = from_flax(model, convert_resnet(sd, model.cfg))
        log_line(f"loaded pretrained torch checkpoint {args.torch_ckpt}")
    else:
        model = from_flax(model, variables)
        # Touch BN stats so folding is meaningful.
        model.train()
        with torch.no_grad():
            for i in range(3):
                model(x[i * 8:(i + 1) * 8])
    model.eval()

    log = MetricLogger()
    with Clock(device) as clock:
        baseline, logits = evaluate(model, x, y, args.batch_size, log)
    log_line(f"baseline fp32 top-1: {baseline:.2f}")
    result = {"lines": log_line.lines, "top1": {"fp32": baseline},
              "logits": {"fp32": logits}, "seconds": {"fp32": clock.seconds}}

    dtypes = (["e4m3", "e3m4", "hybrid"] if args.sweep else [args.dtype])
    for dtype in dtypes:
        t0 = time.time()
        infer_model = get_model(args.model, args.num_classes,
                                norm_mode="scale_shift", device=device)
        calib = [x[i * args.batch_size:(i + 1) * args.batch_size]
                 for i in range(args.num_calibration_batches)]
        calib = [c for c in calib if c.shape[0] > 0]  # short datasets
        qm = quantize_model(model, (x[:2],), dtype=dtype, fuse_bn=True,
                            inference_model=infer_model,
                            calibration_batches=calib,
                            list_exempt_layers=RESNET_EXEMPT, device=device)
        with Clock(device) as clock:
            top1, logits = evaluate(qm, x, y, args.batch_size, log)
        log_line(f"{dtype:8s} PTQ top-1: {top1:.2f} "
                 f"(Δ {top1 - baseline:+.2f}) in {time.time()-t0:.0f}s")
        result["top1"][dtype] = top1
        result["logits"][dtype] = logits
        result["seconds"][dtype] = clock.seconds
    result["images"] = x.shape[0] // args.batch_size * args.batch_size
    return result


if __name__ == "__main__":
    main()
