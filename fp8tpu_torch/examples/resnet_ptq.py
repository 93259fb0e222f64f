"""ResNet post-training quantization, the port of the JAX package's
``examples/resnet_ptq.py`` (the reference's ImageNet PTQ recipe,
examples/inference/classifier/imagenet_test.py):

  baseline eval -> quantize_model -> calibration sweep -> BN -> ScaleShift
  fusion -> quantized eval, with the reference's exempt-layer policy
  (first conv + classifier head) and dtype sweep (launch.py:14-80).

Runs on synthetic data by default (learnable class-conditional patterns,
``fp8tpu_torch.data.pattern_images``); ``--data_npz`` takes {x: (N, H, W,
C), y: (N,)} arrays and ``--imagenet_dir`` an ImageFolder tree through the
reference's val transform (``fp8tpu_torch.data.imagenet``).  On the card
the casts run on K1.

    python -m fp8tpu_torch.examples.resnet_ptq --model resnet50 --sweep
    python -m fp8tpu_torch.examples.resnet_ptq --model tiny_vit

Besides the ResNets, ``--model`` takes the vision families' ``tiny_*``
models (``models.vision``), each with its exempt list; a family with
BatchNorm is folded into its ``norm_mode="scale_shift"`` twin (the JAX
script builds that twin with BatchNorm, so its fold fails for them),
the norm-free SqueezeNet and the LayerNorm ViT are quantized unfolded.
``--torch_ckpt`` loads a pretrained torchvision ResNet state_dict
(``tools.convert_torch.convert_resnet``) in place of the random weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from fp8tpu_torch import quantize_model
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.examples._common import (Clock, Log, add_device_flag,
                                           from_flax)
from fp8tpu_torch.linen import BatchNorm, init_params
from fp8tpu_torch.models import vision
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
# name: (constructor, exempt list)
VISION_MODELS = {
    "tiny_vgg": (vision.tiny_vgg, vision.VGG_EXEMPT),
    "tiny_mobilenet": (vision.tiny_mobilenet, vision.MOBILENET_EXEMPT),
    "tiny_inception": (vision.tiny_inception, vision.INCEPTION_EXEMPT),
    "tiny_densenet": (vision.tiny_densenet, vision.DENSENET_EXEMPT),
    "tiny_shufflenet": (vision.tiny_shufflenet, vision.SHUFFLENET_EXEMPT),
    "tiny_squeezenet": (vision.tiny_squeezenet, vision.SQUEEZENET_EXEMPT),
    "tiny_mbconv": (vision.tiny_mbconv, vision.MBCONV_EXEMPT),
    "tiny_mbconv_hs": (functools.partial(vision.tiny_mbconv,
                                         act="hardswish"),
                       vision.MBCONV_EXEMPT),
    "tiny_vit": (vision.tiny_vit, vision.VIT_EXEMPT),
}
MODEL_EXEMPT = {**{name: RESNET_EXEMPT for name in RESNETS},
                **{name: v[1] for name, v in VISION_MODELS.items()}}


def get_model(name: str, num_classes: int, norm_mode: str = "bn",
              device="cuda", seed: Optional[int] = None) -> torch.nn.Module:
    """The script's model ``name`` on ``device``, its conv and Dense
    weights (and ViT's positional embedding) drawn from ``seed`` when one
    is given."""
    dev = resolve_device(device)
    gen = None if seed is None else torch.Generator(dev).manual_seed(seed)
    if name in VISION_MODELS:
        # only a family with BatchNorm is asked for its scale-shift twin
        kw = {} if norm_mode == "bn" else {"norm_mode": norm_mode}
        return VISION_MODELS[name][0](num_classes, device=dev,
                                      generator=gen, **kw)
    cfg = dataclasses.replace(RESNETS[name], num_classes=num_classes,
                              norm_mode=norm_mode)
    with torch.device(dev):
        model = ResNet(cfg)
    if gen is not None:
        init_params(model, gen)
    return model


def has_batchnorm(model: torch.nn.Module) -> bool:
    return any(isinstance(m, BatchNorm) for m in model.modules())


def load_data(args, device):
    """(images NCHW f32, labels) on ``device``."""
    if args.imagenet_dir:
        # a real ImageFolder tree through the reference's val transform
        # (Resize 256 -> CenterCrop 224 -> normalize, imagenet_test.py:95-99)
        from fp8tpu_torch.data.imagenet import imagenet_val_batches
        xs, ys = zip(*imagenet_val_batches(args.imagenet_dir,
                                           batch_size=args.batch_size,
                                           limit=args.num_samples))
        x, y = np.concatenate(xs).astype(np.float32), np.concatenate(ys)
    elif args.data_npz:
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
                   choices=[*RESNETS, *VISION_MODELS])
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
        # Touch BN stats so folding is meaningful (norm-free families have
        # none).
        if has_batchnorm(model):
            model.train()
            with torch.no_grad():
                for i in range(3):
                    model(x[i * 8:(i + 1) * 8])
    model.eval()
    has_bn = has_batchnorm(model)

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
                                norm_mode="scale_shift", device=device) \
            if has_bn else None
        calib = [x[i * args.batch_size:(i + 1) * args.batch_size]
                 for i in range(args.num_calibration_batches)]
        calib = [c for c in calib if c.shape[0] > 0]  # short datasets
        qm = quantize_model(model, (x[:2],), dtype=dtype, fuse_bn=has_bn,
                            inference_model=infer_model,
                            calibration_batches=calib,
                            list_exempt_layers=MODEL_EXEMPT[args.model],
                            device=device)
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
