"""FP8 LLM serving: quantize a decoder to fp8 / int8 / int4 payloads, start
the continuous-batching engine and generate; the port of the JAX package's
``examples/serve_llm.py``.  On the card the linears run on K3 (K5 for int4
weights), the ring write on K6 and, with ``--paged``, decode attention on
K4: the paged engine's ServeConfig takes ``paged_decode_impl="kernel"``,
where the JAX script keeps its default gathered ring view.

    python -m fp8tpu_torch.examples.serve_llm --weight-fmt e4m3
    python -m fp8tpu_torch.examples.serve_llm --paged --prefix-cache
    python -m fp8tpu_torch.examples.serve_llm --speculative 4 [--paged]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.examples._common import (Log, add_device_flag, from_flax,
                                           random_decoder, sync)
from fp8tpu_torch.models.transformer import DecoderConfig
from fp8tpu_torch.serve import (Request, ServeConfig, ServingEngine,
                                convert_decoder_params, speculative_decode)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--n-layers", type=int, default=8)
    p.add_argument("--weight-fmt", default="int8",
                   choices=["int8", "e4m3", "e5m2", "int4", "bf16"])
    p.add_argument("--kv-fmt", default="int8",
                   choices=["int8", "e4m3", "e5m2", "bf16"])
    p.add_argument("--paged", action="store_true",
                   help="page-pool KV memory (long context) instead of "
                        "the ring")
    p.add_argument("--prefix-cache", action="store_true",
                   help="(paged) share content-addressed prompt pages "
                        "across requests with a common prefix")
    p.add_argument("--prefix-compute-reuse", action="store_true",
                   help="(paged, implies --prefix-cache) admission "
                        "scores only the uncached prompt suffix "
                        "against the shared pages")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=512)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--n-experts", type=int, default=0,
                   help="MoE FFN: serve quantized expert stacks with "
                        "exact top-2 combine (0 = dense)")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="B=1 latency mode: draft K tokens per round "
                        "with a small draft model, verify in one "
                        "multi-token pass (greedy output is identical "
                        "to plain decode)")
    add_device_flag(p)
    return p.parse_args(argv)


def config(args) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=4096, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(4, args.d_model // 64),
        d_ff=args.d_model * 3, max_seq_len=args.max_seq,
        n_experts=args.n_experts)


def draft_config(cfg: DecoderConfig, args) -> DecoderConfig:
    return dataclasses.replace(
        cfg, n_layers=max(1, args.n_layers // 4),
        d_model=max(64, args.d_model // 4),
        n_heads=max(2, args.d_model // 256),
        n_kv_heads=max(2, args.d_model // 256),
        d_ff=max(64, args.d_model // 4) * 3, n_experts=0)


def serve_config(cfg: DecoderConfig, args) -> ServeConfig:
    """The engine's ServeConfig; paged decode walks the pages (K4)."""
    return ServeConfig(model=cfg, weight_fmt=args.weight_fmt,
                       kv_fmt=args.kv_fmt,
                       paged_decode_impl="kernel" if args.paged
                       else "ringview")


def serve_params(cfg, fmt, device, seed, variables=None) -> Dict:
    """The serving artifact of a decoder: random from ``seed`` on
    ``device``, or the Flax-layout ``variables``, quantized to ``fmt``."""
    model = from_flax(random_decoder(cfg, device, seed), variables)
    with torch.no_grad():
        params = convert_decoder_params(model.state_dict(), cfg, fmt=fmt)
    del model
    return params


def requests(args):
    return [Request(uid=i, prompt=list(range(1 + i, 12 + i)),
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature)
            for i in range(args.requests)]


def main(argv=None, variables: Optional[Dict] = None) -> Dict:
    args = parse(argv)
    device = resolve_device(args.device)
    log = Log()
    cfg = config(args)
    params = serve_params(cfg, args.weight_fmt, device, 0, variables)
    scfg = serve_config(cfg, args)
    prefix = args.prefix_cache or args.prefix_compute_reuse
    result = {"lines": log.lines}

    if args.speculative:
        dcfg = draft_config(cfg, args)
        dparams = serve_params(dcfg, args.weight_fmt, device, 1)
        dscfg = serve_config(dcfg, args)
        if args.paged:
            # batched speculation under continuous batching
            engine = ServingEngine(
                params, scfg, n_slots=args.slots, max_seq=args.max_seq,
                use_paged=True, prefix_cache=prefix,
                prefix_compute_reuse=args.prefix_compute_reuse,
                draft_params=dparams, draft_cfg=dscfg,
                k_spec=args.speculative, device=device)
            sync(device)
            t0 = time.perf_counter()
            out = engine.run(requests(args))
            dt = time.perf_counter() - t0
            total = sum(len(v) for v in out.values())
            acc = engine.spec_accepted / max(engine.spec_drafted, 1)
            log(f"batched speculative K={args.speculative}: "
                f"{len(out)} requests, {total} tokens in {dt:.1f}s "
                f"({total/dt:.0f} tok/s), acceptance {acc:.2f}, "
                f"{engine.spec_rounds} rounds")
            return {**result, "tokens": out, "seconds": dt,
                    "tokens_per_s": total / dt, "acceptance": acc}
        prompt = list(range(1, 12))
        sync(device)
        t0 = time.perf_counter()
        toks, stats = speculative_decode(
            params, dparams, prompt, args.max_new_tokens, scfg, dscfg,
            k_spec=args.speculative, max_seq=args.max_seq,
            temperature=args.temperature)
        dt = time.perf_counter() - t0
        log(f"speculative K={args.speculative}: {len(toks)} tokens in "
            f"{dt:.1f}s ({len(toks)/dt:.0f} tok/s), acceptance "
            f"{stats.acceptance_rate:.2f}, "
            f"{stats.tokens_per_round:.2f} tok/round")
        log(f"  tokens: {toks[:16]}{'...' if len(toks) > 16 else ''}")
        return {**result, "tokens": {0: toks}, "seconds": dt,
                "tokens_per_s": len(toks) / dt,
                "acceptance": stats.acceptance_rate}

    engine = ServingEngine(params, scfg, n_slots=args.slots,
                           max_seq=args.max_seq, use_paged=args.paged,
                           prefix_cache=prefix,
                           prefix_compute_reuse=args.prefix_compute_reuse,
                           device=device)
    sync(device)
    t0 = time.perf_counter()
    out = engine.run(requests(args))
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    log(f"{len(out)} requests, {total} tokens in {dt:.1f}s "
        f"({total / dt:.0f} tok/s incl. prefills) "
        f"[weights {args.weight_fmt}, kv {args.kv_fmt}]")
    for uid in sorted(out):
        log(f"  req {uid}: {out[uid][:12]}"
            f"{'...' if len(out[uid]) > 12 else ''}")
    return {**result, "tokens": out, "seconds": dt,
            "tokens_per_s": total / dt, "params": params, "cfg": scfg}


if __name__ == "__main__":
    main()
