"""PTQ sweep over model x dtype, the port of the JAX package's
``examples/launch_sweep.py`` (the reference's launch.py,
examples/inference/classifier/launch.py:14-80, which iterates 12
torchvision models over {e5m2, e4m3, e3m4, hybrid} and prints a top-1
table): ``quantize_model`` with calibration over the bundled model zoo,
one table row per (model, dtype).  It reuses
``fp8tpu_torch.examples.resnet_ptq``'s models, data and exempt lists; as
the JAX sweep does, it quantizes without the BN fold.  On the card the
casts run on K1.

    python -m fp8tpu_torch.examples.launch_sweep --models tiny resnet18 \\
        --dtypes e4m3 e3m4 hybrid --num_samples 256
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from fp8tpu_torch import quantize_model
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.examples._common import Log, add_device_flag, from_flax
from fp8tpu_torch.examples.resnet_ptq import (MODEL_EXEMPT, RESNETS,
                                              VISION_MODELS, get_model,
                                              load_data)
from fp8tpu_torch.utils import accuracy


def evaluate(apply_fn, x, y, batch: int = 64) -> float:
    top1 = n = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            yb = y[i:i + batch]
            top1 += float(accuracy(apply_fn(x[i:i + batch]), yb)[0]) \
                * len(yb)
            n += len(yb)
    return top1 / max(n, 1)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=["tiny"],
                    choices=[*RESNETS, *VISION_MODELS])
    ap.add_argument("--dtypes", nargs="+",
                    default=["e4m3", "e3m4", "hybrid", "e5m2"])
    ap.add_argument("--num_samples", type=int, default=128)
    ap.add_argument("--num_classes", type=int, default=10)
    ap.add_argument("--calib_batches", type=int, default=4)
    ap.add_argument("--data_npz", default=None)
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    """The sweep; ``variables`` maps a model name to the JAX sweep's Flax
    variables of that model."""
    args = parse(argv)
    device = resolve_device(args.device)
    log_line = Log()
    log_line(f"{'model':10s} {'dtype':8s} {'fp32 top1':>9s} "
             f"{'quant top1':>10s} {'Δ':>6s} {'sec':>6s}")
    rows = []
    for name in args.models:
        margs = argparse.Namespace(model=name, data_npz=args.data_npz,
                                   imagenet_dir=None,
                                   num_samples=args.num_samples,
                                   num_classes=args.num_classes)
        x, y = load_data(margs, device)
        model = from_flax(get_model(name, args.num_classes, device=device,
                                    seed=0),
                          (variables or {}).get(name))
        model.eval()
        base = evaluate(model, x, y)

        bs = max(args.num_samples // max(args.calib_batches, 1), 1)
        calib = [x[i * bs:(i + 1) * bs] for i in range(args.calib_batches)]
        for dtype in args.dtypes:
            t0 = time.time()
            qm = quantize_model(model, (x[:1],), dtype=dtype,
                                calibration_batches=calib,
                                list_exempt_layers=MODEL_EXEMPT[name],
                                device=device)
            top1 = evaluate(qm, x, y)
            seconds = time.time() - t0
            with torch.no_grad():
                first = qm(x[:64])
            log_line(f"{name:10s} {dtype:8s} {base:9.2f} {top1:10.2f} "
                     f"{top1 - base:6.2f} {seconds:6.1f}")
            rows.append({"model": name, "dtype": dtype, "fp32_top1": base,
                         "top1": top1, "seconds": seconds,
                         "first_logits": first})
    return {"lines": log_line.lines, "rows": rows}


if __name__ == "__main__":
    main()
