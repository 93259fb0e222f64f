"""User-facing facade: post-training quantization, and FP8 mixed-precision
training through ``initialize`` (re-exported from ``training``).

``quantize_model(...)`` returns a :class:`QuantizedModel` that bundles the
model, the policy, the quantized weights (a state_dict) and the calibrated
qparams; calling it runs the model with the activation casts (and, with
``policy.with_hw_patching()``, the fused engine) through
``torch.func.functional_call``, so the caller's module is never modified.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.func import functional_call

from fp8tpu_torch import linen
from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.numerics.prng import PRNGKey
from fp8tpu_torch.ops.scale_shift import fold_batchnorm
from fp8tpu_torch.quant.calibrate import calibrate as _calibrate
from fp8tpu_torch.quant.calibrate import qparams_from_stats
from fp8tpu_torch.quant.interceptor import (
    build_module_table,
    make_quant_interceptor,
    quantize_params,
)
from fp8tpu_torch.quant.policy import QuantPolicy, get_policy
from fp8tpu_torch.training.mpt import initialize  # noqa: F401  (re-export)


def _to(device, args):
    return tuple(a.to(device) if torch.is_tensor(a) else a for a in args)


@dataclasses.dataclass
class QuantizedModel:
    """A PTQ'd model: quantized weights + activation-cast policy."""

    model: torch.nn.Module
    policy: QuantPolicy
    variables: Dict[str, torch.Tensor]
    module_table: Dict
    device: torch.device
    stats: Optional[Dict] = None
    qparams: Optional[Dict] = None

    def apply(self, *args, variables=None, **kwargs):
        """Quantized forward on ``self.device`` (weights are already
        fake-quantized; the interceptor applies the activation casts)."""
        v = variables if variables is not None else self.variables
        with linen.intercept_methods(make_quant_interceptor(self.policy),
                                     self.model):
            return functional_call(self.model, v, _to(self.device, args),
                                   kwargs)

    def __call__(self, *args, **kwargs):
        return self.apply(*args, **kwargs)

    def print_config(self):
        """Print the resolved per-module policy."""
        for path, kind in sorted(self.module_table.items()):
            print(f"{self.policy.resolve(path, kind)} {path:40s}")


def quantize_model(
    model: torch.nn.Module,
    sample_args: Tuple,
    dtype: str = "e4m3",
    calibration_batches: Optional[Iterable] = None,
    fuse_bn: bool = False,
    inference_model: Optional[torch.nn.Module] = None,
    list_exempt_layers: Tuple[str, ...] = (),
    list_layers_output_fused: Tuple[str, ...] = (),
    policy: Optional[QuantPolicy] = None,
    key: Optional[PRNGKey] = None,
    device="cuda",
) -> QuantizedModel:
    """Post-training quantization.

    ``dtype``: e4m3 | e3m4 | hybrid | e5m2 | bfloat16 selects the preset
    policy (``policy`` overrides it).  ``fuse_bn``: fold BatchNorm into
    ScaleShift first; ``inference_model`` is the same model built with
    ``norm_mode="scale_shift"``.  ``calibration_batches``: input batches
    for the stats sweep; per-module calibrated scales land in
    ``.qparams``.  Runs on ``device`` (CUDA unless the caller asks for the
    CPU); the models are put in eval mode and otherwise left as they are.
    """
    device = resolve_device(device)
    if policy is None:
        policy = get_policy(dtype, training=False)
    if list_exempt_layers:
        policy = policy.with_exempt(*list_exempt_layers)
    if list_layers_output_fused:
        policy = policy.with_output_fused(*list_layers_output_fused)

    variables = {k: v.detach().to(device)
                 for k, v in model.state_dict().items()}
    if fuse_bn:
        if inference_model is None:
            raise ValueError(
                "fuse_bn=True needs inference_model (the model built with "
                "norm_mode='scale_shift')")
        variables = fold_batchnorm(variables)
        model = inference_model
    model.eval()
    del sample_args  # the table comes from named_modules; kept for the API

    table = build_module_table(model)
    stats = qparams = None
    if calibration_batches is not None:
        batches = [_to(device, b if isinstance(b, tuple) else (b,))
                   for b in calibration_batches]
        stats = _calibrate(model, batches, policy=policy, params=variables)
        qparams = qparams_from_stats(stats, policy, table)

    with torch.no_grad():
        qvariables = quantize_params(variables, policy, table, key)
    return QuantizedModel(model=model, policy=policy, variables=qvariables,
                          module_table=table, device=device, stats=stats,
                          qparams=qparams)
