"""Activation-aware weight equalization (AWQ) for serving artifacts.

The JAX package's ``fp8tpu/quant/awq.py`` in PyTorch: per-input-channel
scales ``s`` derived from calibration activations (Lin et al. 2023,
arXiv:2306.00978), grid-searched over a small exponent set to minimise
the quantized layer's output error on real activations, then folded into
the preceding op so the runtime pays nothing:

=============  ==========================  ===========================
site           input comes from            where 1/s folds
=============  ==========================  ===========================
q/k/v_proj     attn_norm output            ``attn_norm.scale /= s``
gate/up_proj   mlp_norm output             ``mlp_norm.scale  /= s``
down_proj      ``silu(gate) * up``         ``up_proj`` rows ``/= s``
=============  ==========================  ===========================

``o_proj`` is left unscaled (under GQA its input channels mix v outputs
shared across head groups), MoE layers equalize only their attention
sites, and the tied LM head cannot absorb a fold.  Equalization is
output-invariant in exact arithmetic; only the quantization error moves.

Variables are the state_dict of :class:`fp8tpu_torch.models.Decoder`
(Dense weights ``(out, in)``, where the JAX package's kernels are
``(in, out)``): an input channel is a column of a weight here.  The
activations are captured with forward hooks on the named modules (Flax's
``capture_intermediates``), and every f32 product runs IEEE, never TF32
(``full_fp32``), since a TF32 ``x @ w`` would move the MSE that chooses
alpha.

Usage::

    eq_vars, info = awq_calibrate_decoder(model, model.state_dict(), cfg,
                                          calib_tokens, fmt="int4")
    artifact = convert_decoder_params(eq_vars, cfg, "int4")
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.kernels.qmatmul import (FP8_DTYPES, div_exact, flush_amax,
                                          fp8_payload)
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.numerics.formats import FORMATS

_SITES = {"qkv": "attn_norm", "gateup": "mlp_norm"}


# ---------------------------------------------------------------------------
# Quantizer simulation: the serving producers' value grids
# (kernels/qmatmul.py::quantize_weights, serve/model.py::
# quantize_weights_int4)
# ---------------------------------------------------------------------------

def _qdq_weights(w: torch.Tensor, fmt: str,
                 int4_group: Optional[int]) -> torch.Tensor:
    """Round-trip ``w`` (K, N) through the serving quantizer's value grid:
    per-output-channel scales for fp8 / int8, per (K-group, N) for int4."""
    wf = w.to(torch.float32)
    K, N = wf.shape
    if fmt == "int4":
        gs = K if (int4_group is None or K % int4_group != 0
                   or K < int4_group) else int4_group
        wg = wf.reshape(K // gs, gs, N)
        amax = flush_amax(wg.abs().amax(dim=1, keepdim=True))
        s = torch.where(amax > 0, div_exact(amax, 7.0), torch.ones_like(amax))
        return (torch.clip(torch.round(wg / s), -8, 7) * s).reshape(K, N)
    amax = flush_amax(wf.abs().amax(dim=0, keepdim=True))
    one = torch.ones_like(amax)
    if fmt == "int8":
        s = torch.where(amax > 0, div_exact(amax, 127.0), one)
        return torch.clip(torch.round(wf / s), -127, 127) * s
    if fmt not in FP8_DTYPES:
        raise ValueError(f"AWQ simulates e4m3, e5m2, int8 or int4, got "
                         f"{fmt!r}")
    top = FORMATS[fmt].max_normal
    s = torch.where(amax > 0, div_exact(amax, top), one)
    q = fp8_payload(torch.clip(wf / s, -top, top), fmt)
    return q.to(torch.float32) * s


# ---------------------------------------------------------------------------
# Calibration stats: per-channel absmax + a row subsample per site
# ---------------------------------------------------------------------------

def _capture(model, variables, toks) -> Dict[int, Dict[str, torch.Tensor]]:
    """One forward of ``model`` with ``variables`` on ``toks``: each
    layer's foldable sites' inputs as (rows, K) f32 (layer: {site: x})."""
    got: Dict[int, Dict[str, torch.Tensor]] = {}
    gates: Dict[int, torch.Tensor] = {}
    hooks = []

    def keep(li, site):
        def hook(_mod, _inp, out):
            got.setdefault(li, {})[site] = out.reshape(-1, out.shape[-1])
        return hook

    def keep_gate(li):
        def hook(_mod, _inp, out):
            gates[li] = out.reshape(-1, out.shape[-1]).to(torch.float32)
        return hook

    def keep_down(li):
        def hook(_mod, _inp, out):
            up = out.reshape(-1, out.shape[-1]).to(torch.float32)
            got.setdefault(li, {})["down"] = F.silu(gates.pop(li)) * up
        return hook

    for li in range(model.cfg.n_layers):
        layer = getattr(model, f"layer_{li}")
        hooks.append(layer.attn_norm.register_forward_hook(keep(li, "qkv")))
        if hasattr(layer, "mlp"):
            hooks.append(layer.mlp_norm.register_forward_hook(
                keep(li, "gateup")))
            hooks.append(layer.mlp.gate_proj.register_forward_hook(
                keep_gate(li)))
            hooks.append(layer.mlp.up_proj.register_forward_hook(
                keep_down(li)))
    try:
        with torch.no_grad(), full_fp32():
            torch.func.functional_call(model, variables, (toks,))
    finally:
        for h in hooks:
            h.remove()
    return got


def collect_awq_stats(model, variables, token_batches: Sequence,
                      n_sample: int = 512, seed: int = 0
                      ) -> Dict[int, Dict[str, Dict[str, torch.Tensor]]]:
    """Run calibration batches through the float model, capturing the
    inputs of every foldable site.

    Returns ``{layer_idx: {site: {"amax": (K,), "x": (n, K)}}}`` with
    sites in {"qkv", "gateup", "down"}.  ``x`` is a fixed-size row
    subsample of the first batch (drawn as the JAX package draws it:
    ``choice(split(key)[1], rows, n, replace=False)`` a site, layers in
    order and sites in sorted order, so the same rows); ``amax`` is the
    per-channel absolute maximum over ALL batches."""
    device = next(iter(variables.values())).device
    stats: Dict[int, Dict[str, Dict[str, torch.Tensor]]] = {}
    rng = prng.key(seed)
    for toks in token_batches:
        toks = torch.as_tensor(toks).to(device=device, dtype=torch.int64)
        got = _capture(model, variables, toks)
        for li in sorted(got):
            dst = stats.setdefault(li, {})
            for site in sorted(got[li]):
                x = got[li][site]
                amax = x.to(torch.float32).abs().amax(dim=0)
                rec = dst.setdefault(site, {"amax": amax, "x": None})
                rec["amax"] = torch.maximum(rec["amax"], amax)
                if rec["x"] is None:
                    n = min(n_sample, x.shape[0])
                    rng, sub = prng.split(rng)
                    idx = prng.choice(sub, x.shape[0], n, device=x.device)
                    rec["x"] = x[idx].to(torch.float32)
        del got
    return stats


# ---------------------------------------------------------------------------
# Scale search + folding
# ---------------------------------------------------------------------------

def _site_errs(weights: Tuple[torch.Tensor, ...], a: torch.Tensor,
               x: torch.Tensor, alphas: Sequence[float], fmt: str,
               int4_group: Optional[int]) -> torch.Tensor:
    """Summed quantized-output MSE for every candidate alpha; ``weights``
    are (K, N) kernels of the site."""
    with full_fp32():
        ref = [x @ w.to(torch.float32) for w in weights]
        errs = []
        for alpha in alphas:
            s = torch.clip(a ** alpha, 1e-3, 1e3)
            e = torch.zeros((), dtype=torch.float32, device=x.device)
            for w, r in zip(weights, ref):
                wq = _qdq_weights(w.to(torch.float32) * s[:, None], fmt,
                                  int4_group) / s[:, None]
                e = e + torch.mean(torch.square(x @ wq - r))
            errs.append(e)
    return torch.stack(errs)


def _search_site_scale(weights: List[torch.Tensor], amax: torch.Tensor,
                       x: torch.Tensor, fmt: str, int4_group: Optional[int],
                       alphas: Sequence[float]) -> Tuple[torch.Tensor, dict]:
    """Grid-search ``s = (amax / mean(amax)) ** alpha`` minimising the
    summed quantized-output MSE over the site's (K, N) weights on the
    sampled activations.  ``alpha = 0`` (identity) is always a candidate,
    so the result is never worse than no equalization on the calibration
    set."""
    pos = amax > 0
    a = torch.where(pos, amax, torch.where(pos, amax, 1.0).mean())
    a = (a / a.mean()).to(torch.float32)
    alist = [float(al) for al in alphas]
    errs_t = _site_errs(tuple(weights), a, x.to(torch.float32), alist, fmt,
                        int4_group).tolist()
    errs = {al: float(e) for al, e in zip(alist, errs_t)}
    best_alpha = min(errs, key=errs.get)
    best_s = torch.clip(a ** best_alpha, 1e-3, 1e3)
    info = {"alpha": best_alpha, "err": errs[best_alpha],
            "err_identity": errs.get(0.0), "errs": errs}
    return best_s, info


def _scaled(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (w.to(torch.float32) * s).to(w.dtype)


def awq_equalize(variables: Dict[str, torch.Tensor], cfg, stats,
                 fmt: str = "e4m3", int4_group: Optional[int] = 128,
                 alphas: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0)
                 ) -> Tuple[dict, dict]:
    """Fold grid-searched AWQ scales into a copy of ``variables`` (the
    tensors it changes are new; the rest are shared).

    Returns ``(equalized_variables, info)`` where ``info[layer][site]``
    records the chosen alpha and the before / after quantized-output MSE.
    Feed the result to ``convert_decoder_params`` (same ``fmt`` /
    ``int4_group``): the artifact's min-max scales then quantize the
    equalized weights."""
    out = dict(variables)
    info: Dict[str, dict] = {}
    for li in sorted(stats):
        pre = f"layer_{li}."
        linfo: Dict[str, dict] = {}
        st = stats[li]
        for site, block, names in (
                ("qkv", "attn", ("q_proj", "k_proj", "v_proj")),
                ("gateup", "mlp", ("gate_proj", "up_proj"))):
            if site not in st or (block == "mlp"
                                  and pre + "mlp.up_proj.weight" not in out):
                continue
            keys = [f"{pre}{block}.{n}.weight" for n in names]
            s, rec = _search_site_scale([out[k].t() for k in keys],
                                        st[site]["amax"], st[site]["x"], fmt,
                                        int4_group, alphas)
            for k in keys:                    # input columns *= s
                out[k] = _scaled(out[k], s[None, :])
            norm = f"{pre}{_SITES[site]}.scale"
            out[norm] = (out[norm].to(torch.float32) / s).to(out[norm].dtype)
            linfo[site] = rec
        if "down" in st and pre + "mlp.down_proj.weight" in out:
            dk, uk = pre + "mlp.down_proj.weight", pre + "mlp.up_proj.weight"
            s, rec = _search_site_scale([out[dk].t()], st["down"]["amax"],
                                        st["down"]["x"], fmt, int4_group,
                                        alphas)
            out[dk] = _scaled(out[dk], s[None, :])
            up = out[uk]                      # up_proj output rows /= s
            out[uk] = (up.to(torch.float32) / s[:, None]).to(up.dtype)
            linfo["down"] = rec
        info[f"layer_{li}"] = linfo
    return out, info


def awq_calibrate_decoder(model, variables, cfg, tokens,
                          fmt: str = "e4m3",
                          int4_group: Optional[int] = 128,
                          batch: int = 8, n_batches: int = 4,
                          n_sample: int = 512,
                          alphas: Sequence[float] = (0.0, 0.25, 0.5,
                                                     0.75, 1.0),
                          seed: int = 0) -> Tuple[dict, dict]:
    """One-call AWQ: capture calibration activations from ``tokens`` ((N, S)
    ints; the first ``batch * n_batches`` rows are used), grid-search
    per-site scales, and return the equalized variables plus the per-site
    search log."""
    batches = [tokens[i * batch:(i + 1) * batch]
               for i in range(n_batches)
               if tokens[i * batch:(i + 1) * batch].shape[0] > 0]
    stats = collect_awq_stats(model, variables, batches,
                              n_sample=n_sample, seed=seed)
    return awq_equalize(variables, cfg, stats, fmt=fmt,
                        int4_group=int4_group, alphas=alphas)
