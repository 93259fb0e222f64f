"""Speculative decoding for the serving stack (draft and verify).

A small draft model proposes ``K`` tokens autoregressively, then the target
model scores all ``K + 1`` positions in ONE multi-token pass, so one pass
over the target's weights yields ``a + 1`` tokens when ``a`` drafts are
accepted (Leviathan et al. 2023).  The port of
``fp8tpu/serve/speculative.py``:

- **Verification is one batched pass** (:func:`score_tokens` on the ring,
  :func:`score_tokens_paged` on the paged pool): fresh Q/K/V for the T
  tokens, the cached prefix combined flash-style with the causal in-block
  part, which reads the QUANTIZED fresh K/V (what later steps read back
  from the cache).  Every linear is one K3 launch at M = B * T on a CUDA
  tensor (its decode form up to 64 rows, the prefill route above); the
  attention products and the LM head are library matmuls, as they are XLA
  dots in the JAX package.
- **The cache writes are in place.**  :func:`score_tokens` stores its T
  rows with T K6 ``ring_store`` launches, each advancing the ring's head
  on the device; :func:`rollback` moves that same head back in place.  The
  paged pass scatters its valid rows into the pool (padding rows to the
  scratch page); pages address by logical position, so per-slot acceptance
  needs no rollback.
- **Acceptance runs on the device** (:func:`greedy_verify`,
  :func:`sample_verify`), and :func:`spec_rounds` chains R rounds with
  positions and the pending tokens kept as device tensors: a dispatch
  never synchronises with the host.

Sampling-mode verification is the lossless rejection rule: accept ``d_t``
with probability ``min(1, p_t(d_t) / q_t(d_t))``; at the first rejection
resample from ``norm(max(p_t - q_t, 0))``; if all K are accepted the bonus
token samples from ``p_K``.  Draws come from a ``torch.Generator`` on the
logits' device (the JAX package splits keys), so sampled runs agree with
the JAX package in law, not draw for draw.

Where the JAX functions return new caches, these update ``ring.kv8`` /
``ring.sc`` / ``ring.head`` (``paged.pool`` / ``paged.sc``) in place and
return the same cache object.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.models.transformer import rope_freqs

from .kv_cache import RingKVCache, bits, quantize_kv
from .model import (_CANDIDATES, _NEG, ServeConfig, _categorical, _check_cfg,
                    _dot_f32, _embed_lookup, _ffn_block, _layer_xs, _lm_head,
                    _make_linear, _out_proj, _paged_scatter, _qkv,
                    _ring_write_step, _rms, _rope, _scaled_query,
                    _scatter_slots, _steps_impl, _steps_impl_paged, _tp,
                    local_heads, prefill, ring_valid_mask, sample_tokens)


# ---------------------------------------------------------------------------
# Multi-token scoring (the verify forward)
# ---------------------------------------------------------------------------

def _block_qkv(h, xs, cos, sin, cfg: ServeConfig, linear, params):
    """One layer's fresh projections for a (B, T) block: rotated q (B, T,
    H, D), the quantized k / v (B, T, KV, D) with scales (B, T, KV), and
    q / sqrt(D) as (B, KV, T * G, D), kv-head-major like the caches'
    columns (the heads this rank attends with, under a mesh)."""
    mcfg = cfg.model
    (H, KV), D = local_heads(params, mcfg), mcfg.head_dim
    B, T = h.shape[:2]
    x = _rms(h, xs["attn_norm"], mcfg.norm_eps)
    q, k, v = _qkv(x, xs, linear, _tp(params), (B, T), D)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    kq8, kqs = quantize_kv(k, cfg.kv_fmt)
    vq8, vqs = quantize_kv(v, cfg.kv_fmt)
    qg = _scaled_query(q).reshape(B, T, KV, H // KV, D).permute(0, 2, 1, 3, 4)
    return qg.reshape(B, KV, -1, D), kq8, kqs[..., 0], vq8, vqs[..., 0]


def _in_block(qg, kq8, kqs, causal, B, KV, T):
    """Scores of the block against its own QUANTIZED keys: qg (B, KV, T*G,
    D), kq8 (B, T, KV, D), kqs (B, T, KV); causal broadcasts against (B,
    KV, Tq, G, Tk).  (B, KV, T, G, T) f32."""
    D = qg.shape[-1]
    kf = kq8.permute(0, 2, 3, 1).reshape(B * KV, D, T).to(qg.dtype)
    ss = _dot_f32(qg.reshape(B * KV, -1, D), kf).reshape(B, KV, T, -1, T)
    ss = ss * kqs.permute(0, 2, 1)[:, :, None, None, :]
    return torch.where(causal, ss, _NEG)


def _combine(scores, sscores, pv, vq8, vqs, B, KV, T):
    """Flash combine of the cached part and the in-block part: scores (B,
    KV, T, G, S) and sscores (B, KV, T, G, T) f32; ``pv(pc)`` gives the
    cached part's unnormalised context (B, KV, T, G, D) from its exp
    weights.  Returns the normalised context (B, T, KV * G * D) in bf16."""
    m = torch.maximum(scores.amax(dim=-1), sscores.amax(dim=-1))
    pc = torch.exp(scores - m[..., None])
    ps = torch.exp(sscores - m[..., None])
    denom = pc.sum(-1) + ps.sum(-1)
    ctx = pv(pc)
    wv = ps * vqs.permute(0, 2, 1)[:, :, None, None, :]   # (B,KV,Tq,G,Tk)
    vf = vq8.permute(0, 2, 1, 3).to(torch.float32)        # (B,KV,Tk,D)
    with full_fp32():
        ctx = ctx + torch.matmul(wv.reshape(B, KV, -1, T),
                                 vf).reshape(ctx.shape)
    ctx = (ctx / denom[..., None]).permute(0, 2, 1, 3, 4)
    return ctx.reshape(B, T, -1).to(torch.bfloat16)


def _block_rope(positions, T, mcfg, dev):
    pos_bt = positions.to(torch.int64)[:, None] \
        + torch.arange(T, device=dev)[None]
    ang = pos_bt[..., None].to(torch.float32) * rope_freqs(mcfg, dev)
    return torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]


@torch.no_grad()
def score_tokens(params: Dict, ring: RingKVCache, tokens: torch.Tensor,
                 positions: torch.Tensor, cfg: ServeConfig
                 ) -> Tuple[torch.Tensor, RingKVCache]:
    """Score T tokens per slot against the ring prefix in one pass.

    tokens (B, T) int32; positions (B,) each slot's current length (the
    position of tokens[:, 0]).  Returns (logits (B, T, V) f32, ring with
    the T fresh rows written at head..head+T-1 and head advanced by T, in
    place, with no host synchronisation).

    logits[:, t] is the next-token distribution after tokens[:, :t+1], what
    t + 1 plain decode steps give.  The ring's validity window shrinks to
    ``S - T`` rows, so rows rolled back after this pass never alias into
    the mask once a slot's position exceeds the ring size."""
    _check_cfg(cfg)
    mcfg = cfg.model
    KV, D, L = local_heads(params, mcfg)[1], mcfg.head_dim, mcfg.n_layers
    B, T = tokens.shape
    S = ring.max_seq
    BK = B * KV
    dev = tokens.device
    linear = _make_linear(cfg, params)
    cos, sin = _block_rope(positions, T, mcfg, dev)
    # the prefix mask is the same for every t of the block; T rows are kept
    # out of the window for the block in flight
    lens = torch.clamp(positions.to(torch.int32), max=S - T)
    ring_mask = ring_valid_mask(ring.head, lens, S)[:, None, None, None]
    t = torch.arange(T, device=dev)
    causal = (t[None, :] <= t[:, None])[None, None, :, None, :]

    h = _embed_lookup(params, tokens.to(torch.int32)).to(torch.bfloat16)
    slab8 = torch.empty((T, 2, L, BK, D), dtype=ring.kv8.dtype, device=dev)
    slabs = torch.empty((T, 2, L, BK), dtype=torch.float32, device=dev)
    slab_bits = bits(slab8)
    for li in range(L):
        xs = _layer_xs(params, li)
        qg, kq8, kqs, vq8, vqs = _block_qkv(h, xs, cos, sin, cfg, linear,
                                            params)
        rk8, rks = ring.kv8[:, 0, li], ring.sc[:, 0, li]   # (S,BK,D),(S,BK)
        rv8, rvs = ring.kv8[:, 1, li], ring.sc[:, 1, li]
        scores = _dot_f32(qg.reshape(BK, -1, D),
                          rk8.to(qg.dtype).permute(1, 2, 0)
                          ).reshape(B, KV, T, -1, S) \
            * rks.t().reshape(B, KV, 1, 1, S)
        scores = torch.where(ring_mask, scores, _NEG)
        sscores = _in_block(qg, kq8, kqs, causal, B, KV, T)

        def pv(pc):
            pcs = (pc * rvs.t().reshape(B, KV, 1, 1, S)).to(qg.dtype)
            return _dot_f32(pcs.reshape(BK, -1, S),
                            rv8.to(qg.dtype).permute(1, 0, 2)
                            ).reshape(B, KV, T, -1, D)

        ctx = _combine(scores, sscores, pv, vq8, vqs, B, KV, T)
        h = h + _out_proj(ctx, xs, linear, _tp(params))
        h = _ffn_block(h, xs, mcfg, linear, _tp(params))
        # rows-first: slab t holds token t of every slot, column b*KV + kv
        slab_bits[:, 0, li] = bits(kq8).permute(1, 0, 2, 3).reshape(T, BK, D)
        slab_bits[:, 1, li] = bits(vq8).permute(1, 0, 2, 3).reshape(T, BK, D)
        slabs[:, 0, li] = kqs.permute(1, 0, 2).reshape(T, BK)
        slabs[:, 1, li] = vqs.permute(1, 0, 2).reshape(T, BK)

    # every layer read the ring as it was before the block: now the T rows,
    # each with its head advance (K6 ring_store on a CUDA ring)
    for i in range(T):
        _ring_write_step(ring, slab8[i], slabs[i])

    h = _rms(h, params["final_norm"], mcfg.norm_eps)
    logits = _lm_head(params, h.reshape(B * T, -1)).reshape(B, T, -1)
    return logits, ring


def _paged_write_block(paged, fk8, fks, fv8, fvs, starts, valid_t,
                       table=None, row_valid=None):
    """Scatter a (B, T) block of fresh k/v into the page pool in place: row
    b's token t lands at logical position ``starts[b] + t``; tokens with
    ``t >= valid_t[b]``, out-of-window positions and unmapped pages DROP (to
    the pool's scratch page).  fk8/fv8: (L, B, T, KV, D); fks/fvs: (L, B,
    T, KV).  ``table`` (B, MP) overrides the pool's own page table; rows
    with ``row_valid[b] == False`` drop entirely."""
    L, B, T, KV, D = fk8.shape
    page = paged.page_size
    dev = paged.pool.device
    if table is None:
        table = paged.page_table
    t = torch.arange(T, device=dev)
    tpos = starts.to(torch.int64)[:, None] + t[None]            # (B, T)
    lp = torch.clamp(tpos // page, max=paged.max_pages - 1)
    pg = table.to(torch.int64).gather(1, lp)                    # (B, T)
    valid = ((t[None] < valid_t[:, None]) & (tpos < paged.max_seq)
             & (pg >= 0))
    if row_valid is not None:
        valid = valid & row_valid[:, None]
    pg = torch.where(valid, pg, paged.n_pages)                  # drops
    rows = (tpos % page)[:, :, None] * KV \
        + torch.arange(KV, device=dev)[None, None]              # (B, T, KV)
    return _paged_scatter(paged, pg[:, :, None], rows, fk8, fks, fv8, fvs)


@torch.no_grad()
def score_tokens_paged(params: Dict, paged, tokens: torch.Tensor,
                       positions: torch.Tensor, cfg: ServeConfig,
                       valid_t: Optional[torch.Tensor] = None,
                       slots: Optional[torch.Tensor] = None):
    """Paged twin of :func:`score_tokens` with PER-SLOT validity.

    tokens (B, T); positions (B,) each slot's current length (where
    tokens[:, 0] goes); valid_t (B,) how many of the T tokens are real for
    each slot (default T); slots (B,) picks page-table rows, and rows with
    ``slots >= n_slots`` are padding that writes nothing.  Returns (logits
    (B, T, V), paged with the valid fresh rows written at
    positions..positions+valid_t-1, in place).

    Pages address by LOGICAL position, so per-slot acceptance needs no
    rollback: the caller advances each slot's position by its own accepted
    count, and rejected rows are invisible to the position mask until they
    are written again."""
    _check_cfg(cfg)
    mcfg = cfg.model
    KV, D, L = local_heads(params, mcfg)[1], mcfg.head_dim, mcfg.n_layers
    B, T = tokens.shape
    dev = tokens.device
    linear = _make_linear(cfg, params)
    page = paged.page_size
    if valid_t is None:
        valid_t = torch.full((B,), T, dtype=torch.int32, device=dev)
    if slots is None:
        table, row_valid = paged.page_table, None
    else:
        slots = slots.to(torch.int64)
        table = paged.page_table[torch.clamp(slots, 0, paged.n_slots - 1)]
        row_valid = slots < paged.n_slots
    safe = torch.clamp(table, min=0).to(torch.int64)
    kv_pages = bits(paged.pool)[safe].view(paged.pool.dtype)
    sc_pages = paged.sc[safe]          # (B, MP, 2, L, page*KV[, D])
    MP = kv_pages.shape[1]
    S = MP * page

    cos, sin = _block_rope(positions, T, mcfg, dev)
    page_mask = (torch.arange(S, device=dev)[None]
                 < positions.to(torch.int64)[:, None])[:, None, None, None]
    t = torch.arange(T, device=dev)
    causal = ((t[None, None, :] <= t[None, :, None])
              & (t[None, None, :] < valid_t[:, None, None]))  # (B, Tq, Tk)
    causal = causal[:, None, :, None, :]

    h = _embed_lookup(params, tokens.to(torch.int32)).to(torch.bfloat16)
    fresh = []
    for li in range(L):
        xs = _layer_xs(params, li)
        qg, kq8, kqs, vq8, vqs = _block_qkv(h, xs, cos, sin, cfg, linear,
                                            params)
        # (B, MP, page*KV, D) is (B, S, KV, D) with the token-major rows split
        kp = kv_pages[:, :, 0, li].reshape(B, S, KV, D)
        vp = kv_pages[:, :, 1, li].reshape(B, S, KV, D)
        kss = sc_pages[:, :, 0, li].reshape(B, S, KV).permute(0, 2, 1)
        vss = sc_pages[:, :, 1, li].reshape(B, S, KV).permute(0, 2, 1)
        scores = _dot_f32(
            qg.reshape(B * KV, -1, D),
            kp.to(qg.dtype).permute(0, 2, 3, 1).reshape(B * KV, D, S)
        ).reshape(B, KV, T, -1, S) * kss[:, :, None, None, :]
        scores = torch.where(page_mask, scores, _NEG)
        sscores = _in_block(qg, kq8, kqs, causal, B, KV, T)

        def pv(pc):
            pcs = (pc * vss[:, :, None, None, :]).to(qg.dtype)
            return _dot_f32(
                pcs.reshape(B * KV, -1, S),
                vp.to(qg.dtype).permute(0, 2, 1, 3).reshape(B * KV, S, D)
            ).reshape(B, KV, T, -1, D)

        ctx = _combine(scores, sscores, pv, vq8, vqs, B, KV, T)
        h = h + _out_proj(ctx, xs, linear, _tp(params))
        h = _ffn_block(h, xs, mcfg, linear, _tp(params))
        fresh.append((bits(kq8), kqs, bits(vq8), vqs))

    dt = paged.pool.dtype
    fk8, fks, fv8, fvs = (torch.stack(f) for f in zip(*fresh))
    _paged_write_block(paged, fk8.view(dt), fks, fv8.view(dt), fvs,
                       positions, valid_t, table=table, row_valid=row_valid)

    h = _rms(h, params["final_norm"], mcfg.norm_eps)
    logits = _lm_head(params, h.reshape(B * T, -1)).reshape(B, T, -1)
    return logits, paged


def rollback(ring: RingKVCache, n) -> RingKVCache:
    """Discard the last ``n`` written rows by retreating the ring's head in
    place (the same tensor the ring writes advance; no host
    synchronisation).  Rolled-back rows stay masked because
    :func:`score_tokens` keeps the block in flight out of the validity
    window."""
    S = ring.max_seq
    ring.head.copy_(torch.remainder(ring.head - n + S, S))
    return ring


# ---------------------------------------------------------------------------
# Device-side acceptance
# ---------------------------------------------------------------------------

def greedy_verify(logits: torch.Tensor, draft: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, K+1, V) from a scoring pass over [last, d_1..d_K]; draft
    (B, K) the drafted tokens.  Returns (accepted count a (B,) int32 in [0,
    K], bonus token (B,): argmax(logits[:, a]), the first token the target
    disagrees on, or the free K+1-th token when everything matched)."""
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)          # (B, K+1)
    matches = (tgt[:, :-1] == draft).to(torch.int32)
    a = torch.cumprod(matches, dim=1).sum(dim=1).to(torch.int32)
    bonus = tgt.gather(1, a[:, None].to(torch.int64))[:, 0]
    return a, bonus


def filter_logits(logits: torch.Tensor, top_k, top_p) -> torch.Tensor:
    """Per-slot top-k / nucleus filtering of SCALED logits (B, T, V):
    everything outside the kept set is masked to ``_NEG``.  The keep set is
    the candidate pool of ``sample_tokens`` (k clamped to the pool,
    ``top_k <= 0`` / ``top_p >= 1`` disable), scattered back over the
    vocabulary by the pool's indices: a value threshold would keep every
    token tied with the k-th value.  The same filter applied to the target
    and the draft law keeps the rejection rule lossless with respect to the
    filtered target law."""
    B, T, V = logits.shape
    C = min(_CANDIDATES, V)
    flat = logits.reshape(B * T, V)
    tk = top_k.repeat_interleave(T)
    tp = top_p.repeat_interleave(T)
    vals, idx = torch.topk(flat, C, dim=-1)                     # desc
    k_off = tk <= 0
    k = torch.where(k_off | (tk > C), C, tk)
    keep = torch.arange(C, device=flat.device)[None] < k[:, None]
    p_off = tp >= 1
    p = torch.where((tp <= 0) | p_off, 1.0, tp)
    probs = torch.softmax(torch.where(keep, vals, _NEG), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = keep & ((csum - probs) < p[:, None])                 # argmax stays
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    mask.scatter_(1, idx, keep)
    out = torch.where(mask, flat, _NEG)
    out = torch.where((k_off & p_off)[:, None], flat, out)
    return out.reshape(B, T, V)


def sample_verify(logits_p: torch.Tensor, logits_q: torch.Tensor,
                  draft: torch.Tensor, generator, temperature: torch.Tensor,
                  top_k=None, top_p=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lossless rejection-sampling acceptance.

    logits_p (B, K+1, V): target logits over [last, d_1..d_K]; logits_q (B,
    K, V): draft logits that SAMPLED d_1..d_K; draft (B, K); temperature
    (B,) > 0; draws from ``generator`` (on the logits' device).  Returns (a,
    bonus) with the bonus drawn from the residual ``norm(max(p_a - q_a,
    0))`` (from ``p_K`` when all K were accepted): the output follows the
    target-only sampling law.  With ``top_k`` / ``top_p`` the same per-slot
    filter applies to both laws, on the temperature-scaled logits."""
    B, K = draft.shape
    dev = logits_p.device
    t = torch.clamp(temperature, min=1e-6)[:, None, None]
    sp, sq = logits_p / t, logits_q / t
    if top_k is not None or top_p is not None:
        tk = top_k if top_k is not None else torch.zeros(
            (B,), dtype=torch.int32, device=dev)
        tp = top_p if top_p is not None else torch.ones(
            (B,), dtype=torch.float32, device=dev)
        sp, sq = filter_logits(sp, tk, tp), filter_logits(sq, tk, tp)
    p = torch.softmax(sp, dim=-1)                               # (B, K+1, V)
    q = torch.softmax(sq, dim=-1)                               # (B, K, V)

    d = draft.to(torch.int64)[..., None]
    pd = p[:, :K].gather(-1, d)[..., 0]
    qd = q.gather(-1, d)[..., 0]
    u = torch.rand((B, K), generator=generator, device=dev)
    accept = (u * qd < pd).to(torch.int32)                      # u < p / q
    a = torch.cumprod(accept, dim=1).sum(dim=1).to(torch.int32)

    # residual at the first rejected position (q padded with 0 at K, so the
    # all-accepted case resamples from p_K itself)
    qz = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    ai = a.to(torch.int64)[:, None, None].expand(B, 1, p.shape[-1])
    residual = torch.clamp(p.gather(1, ai)[:, 0] - qz.gather(1, ai)[:, 0],
                           min=0.0)
    residual = residual / torch.clamp(residual.sum(-1, keepdim=True),
                                      min=1e-30)
    bonus = _categorical(torch.log(residual + 1e-30), generator)
    return a, bonus.to(torch.int32)


# ---------------------------------------------------------------------------
# Draft chunk (logits and the tokens those logits sampled)
# ---------------------------------------------------------------------------

@torch.no_grad()
def draft_chunk(params: Dict, ring: RingKVCache, tokens: torch.Tensor,
                positions: torch.Tensor, generator,
                temperature: torch.Tensor, n_steps: int, cfg: ServeConfig):
    """K draft steps on the ring returning (drafted (B, K), logits (B, K,
    V), ring): the decode loop's own (sample, distribution) pairs, the
    pairs the rejection rule needs.  Each step is 7 K3 launches a layer at
    M = B and one K6 ring write."""
    (logits, drafted), ring, _, _ = _steps_impl(
        params, ring, tokens, positions, generator, temperature, n_steps,
        cfg, want_logits=True)
    return drafted.t(), logits.permute(1, 0, 2), ring


@torch.no_grad()
def prefill_chunked_paged(params: Dict, paged, prompt, slot: int,
                          cfg: ServeConfig, chunk: int = 256,
                          start: int = 0):
    """Long-prompt prefill in ``chunk``-token blocks scored against the
    pages written so far (:func:`score_tokens_paged`), which bounds the
    attention's live memory at chunk x prompt.  ``start`` resumes from
    tokens already cached (compute-level prefix reuse).  Returns
    (last-token logits (V,), paged)."""
    prompt = [int(t) for t in prompt]
    n = len(prompt)
    if not 0 <= start < n:
        raise ValueError(
            f"start={start} must leave at least one token to score "
            f"(prompt length {n}); a fully cached prompt should rescore "
            f"its last token (start=len(prompt)-1)")
    dev = paged.pool.device

    def dev_i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    slot_t = dev_i32([slot])
    logits_last = None
    done = start
    while done < n:
        take = min(chunk, n - done)
        logits, paged = score_tokens_paged(
            params, paged, dev_i32([prompt[done:done + take]]),
            dev_i32([done]), cfg, valid_t=dev_i32([take]), slots=slot_t)
        logits_last = logits[0, take - 1]
        done += take
    return logits_last, paged


@torch.no_grad()
def prefill_scored_paged(params: Dict, paged, suffix: torch.Tensor,
                         slots: torch.Tensor, cache_lens: torch.Tensor,
                         suffix_lens: torch.Tensor, generator,
                         temperature: torch.Tensor, tokens: torch.Tensor,
                         positions: torch.Tensor, cfg: ServeConfig,
                         top_k=None, top_p=None):
    """Admission that computes ONLY the uncached suffix.

    Request n resumes from ``cache_lens[n]`` tokens already in its mapped
    pages (shared prefix pages); ``suffix`` (N, T), right-padded, holds the
    rest of its prompt, scored against the cached pages with
    :func:`score_tokens_paged`.  A cold request is ``cache_lens == 0``, so
    cold and warm admissions share one numerics contract (prompt attention
    reads the QUANTIZED cache, as decode does).  Samples each request's
    first token at its last valid suffix position and patches the engine's
    device token / position carry with a one-hot ``where`` (rows with
    ``slots >= n_slots`` patch nothing; no out-of-range index reaches the
    device).  Returns (first (N,), paged, tokens, positions)."""
    logits, paged = score_tokens_paged(params, paged, suffix, cache_lens,
                                       cfg, valid_t=suffix_lens, slots=slots)
    idx = torch.clamp(suffix_lens.to(torch.int64) - 1, 0, suffix.shape[1] - 1)
    last = logits.gather(1, idx[:, None, None].expand(
        -1, 1, logits.shape[-1]))[:, 0]
    first = sample_tokens(last, generator, temperature, top_k, top_p)
    lengths = cache_lens + suffix_lens
    tokens = _scatter_slots(tokens, slots, first)
    positions = _scatter_slots(positions, slots, lengths)
    return first, paged, tokens, positions


# ---------------------------------------------------------------------------
# Batched speculation round (continuous batching, paged caches)
# ---------------------------------------------------------------------------

def _spec_round_impl(params: Dict, paged, draft_params: Dict, dpaged,
                     pend: torch.Tensor, pend_n: torch.Tensor,
                     tpos: torch.Tensor, dpos: torch.Tensor, generator,
                     temperature: torch.Tensor, k_spec: int,
                     cfg: ServeConfig, dcfg: ServeConfig,
                     any_sampled: bool = True, top_k=None, top_p=None):
    """One speculation round for ALL slots.

    Per slot: catch the draft cache up on the tokens it has not consumed
    (``pend`` (B, 2) with ``pend_n`` (B,) in {1, 2}; the LAST pending token
    is the one drafting starts from), draft ``k_spec`` tokens, verify all
    slots' blocks in one :func:`score_tokens_paged` pass and accept per
    slot (greedy at temperature 0, rejection sampling otherwise).  Each
    slot advances by its OWN accepted count.  ``any_sampled=False`` (an
    all-greedy batch) skips the sampled acceptance and the draft's draws.

    The draft steps feed forward the tokens they return (the filtered
    draws when ``top_k`` / ``top_p`` are set), so the draft cache holds the
    drafted tokens.

    Returns (drafted (B, K), a (B,), bonus (B,), pend', pend_n', tpos',
    dpos', paged, dpaged)."""
    K = k_spec
    # 1) draft catch-up: consume all pending tokens but the last
    _, dpaged = score_tokens_paged(draft_params, dpaged, pend, dpos, dcfg,
                                   valid_t=pend_n - 1)
    dpos = dpos + pend_n - 1
    last = pend.gather(1, (pend_n - 1).to(torch.int64)[:, None])[:, 0]

    # 2) draft K tokens (the logits and the tokens they sampled)
    (dlogits, drafted), dpaged, _, _ = _steps_impl_paged(
        draft_params, dpaged, last, dpos, generator, temperature, K, dcfg,
        want_logits=True, top_k=top_k, top_p=top_p,
        greedy_only=not any_sampled)
    drafted = drafted.t()                                       # (B, K)
    dlogits = dlogits.permute(1, 0, 2)                          # (B, K, V)
    dpos = dpos + K            # rows for last, d_1..d_{K-1}

    # 3) verify [last, d_1..d_K] against the target in one pass
    vtoks = torch.cat([last[:, None], drafted], dim=1)
    logits, paged = score_tokens_paged(params, paged, vtoks, tpos, cfg)

    # 4) accept per slot
    a, bonus = greedy_verify(logits, drafted)
    if any_sampled:
        as_, bs = sample_verify(logits, dlogits, drafted, generator,
                                torch.clamp(temperature, min=1e-6),
                                top_k=top_k, top_p=top_p)
        greedy = temperature <= 0
        a = torch.where(greedy, a, as_)
        bonus = torch.where(greedy, bonus, bs)

    # 5) advance: the draft keeps min(a + 1, K) of its K new rows; when
    # a == K it never saw d_K, which becomes pending for the next round
    tpos = tpos + a + 1
    dpos = dpos - K + torch.clamp(a + 1, max=K)
    full = (a == K)[:, None]
    pend = torch.where(full, torch.stack([drafted[:, K - 1], bonus], dim=1),
                       torch.stack([bonus, bonus], dim=1))
    pend_n = torch.where(a == K, 2, 1).to(torch.int32)
    return drafted, a, bonus, pend, pend_n, tpos, dpos, paged, dpaged


@torch.no_grad()
def spec_round(params: Dict, paged, draft_params: Dict, dpaged,
               pend: torch.Tensor, pend_n: torch.Tensor, tpos: torch.Tensor,
               dpos: torch.Tensor, generator, temperature: torch.Tensor,
               k_spec: int, cfg: ServeConfig, dcfg: ServeConfig,
               any_sampled: bool = True, filtering: bool = False,
               top_k=None, top_p=None):
    """One speculation round (:func:`_spec_round_impl`).  ``filtering`` is
    a hint like ``any_sampled``: False skips the top-k / top-p masks."""
    if not filtering:
        top_k = top_p = None
    return _spec_round_impl(params, paged, draft_params, dpaged, pend,
                            pend_n, tpos, dpos, generator, temperature,
                            k_spec, cfg, dcfg, any_sampled, top_k, top_p)


@torch.no_grad()
def spec_rounds(params: Dict, paged, draft_params: Dict, dpaged,
                pend: torch.Tensor, pend_n: torch.Tensor, tpos: torch.Tensor,
                dpos: torch.Tensor, generator, temperature: torch.Tensor,
                k_spec: int, n_rounds: int, cfg: ServeConfig,
                dcfg: ServeConfig, any_sampled: bool = True,
                filtering: bool = False, top_k=None, top_p=None):
    """``n_rounds`` chained speculation rounds in one dispatch: a Python
    loop whose positions, pending tokens and counts stay device tensors, so
    no round waits for the host.

    Returns (drafted (R, B, K), a (R, B), bonus (R, B), pend, pend_n, tpos,
    dpos, paged, dpaged)."""
    if not filtering:
        top_k = top_p = None
    outs = []
    for _ in range(n_rounds):
        (drafted, a, bonus, pend, pend_n, tpos, dpos, paged,
         dpaged) = _spec_round_impl(
            params, paged, draft_params, dpaged, pend, pend_n, tpos, dpos,
            generator, temperature, k_spec, cfg, dcfg, any_sampled, top_k,
            top_p)
        outs.append((drafted, a, bonus))
    drafted, a, bonus = (torch.stack(o) for o in zip(*outs))
    return drafted, a, bonus, pend, pend_n, tpos, dpos, paged, dpaged


# ---------------------------------------------------------------------------
# Host-side speculative decode loop (single sequence, ring caches)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0    # tokens of draft / verify ROUNDS only (the
                        # prefill-sampled first token is not counted)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    @property
    def tokens_per_round(self) -> float:
        return self.emitted / max(self.rounds, 1)


@torch.no_grad()
def speculative_decode(params: Dict, draft_params: Dict, prompt, n_new: int,
                       cfg: ServeConfig, dcfg: ServeConfig, k_spec: int = 4,
                       max_seq: Optional[int] = None,
                       temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[List[int], SpecStats]:
    """Generate ``n_new`` tokens from ``prompt`` with draft / verify rounds
    on ring caches on the parameters' device (greedy at ``temperature ==
    0``, the plain decode loop's tokens; rejection sampling otherwise, with
    draws from ``generator``).  The host reads two scalars a round (the
    accepted count and the bonus token) and rolls both rings back.
    Returns (tokens, stats)."""
    prompt = [int(t) for t in prompt]
    mcfg, dmcfg = cfg.model, dcfg.model
    S = max_seq or mcfg.max_seq_len
    K = int(k_spec)
    if cfg.ring_flush not in (0, None) or dcfg.ring_flush not in (0, None):
        raise ValueError("speculative decode drives the plain ring path "
                         "(ring_flush 0)")
    if len(prompt) + n_new + K + 2 > S:
        raise ValueError(
            f"prompt({len(prompt)}) + n_new({n_new}) + verify reserve "
            f"({K + 2}) exceeds the ring window max_seq={S}; shorten the "
            f"request or grow max_seq (a silent short return would be "
            f"indistinguishable from completion)")
    dev = params["embed"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    temp1 = torch.full((1,), float(temperature), dtype=torch.float32,
                       device=dev)

    def dev_i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    ring = RingKVCache.create(mcfg.n_layers, 1, S,
                              local_heads(params, mcfg)[1], mcfg.head_dim,
                              cfg.kv_fmt, device=dev)
    dring = RingKVCache.create(dmcfg.n_layers, 1, S,
                               local_heads(draft_params, dmcfg)[1],
                               dmcfg.head_dim, dcfg.kv_fmt, device=dev)
    ptoks = dev_i32(prompt)
    logits0, ring = prefill(params, ring, ptoks, 0, len(prompt), cfg)
    _, dring = prefill(draft_params, dring, ptoks, 0, len(prompt), dcfg)
    if temperature == 0.0:
        first = int(torch.argmax(logits0))
    else:
        first = int(_categorical(logits0[None] / max(temperature, 1e-6),
                                 generator)[0])

    ctx = prompt + [first]       # the target ring holds ctx[:-1]
    dpos = len(prompt)           # the draft ring holds ctx[:dpos]
    out: List[int] = [first]
    stats = SpecStats()
    while len(out) < n_new:
        # catch the draft ring up to ctx[:-1] (0 or 1 pending tokens)
        n_pending = len(ctx) - 1 - dpos
        if n_pending > 0:
            _, dring = score_tokens(draft_params, dring,
                                    dev_i32([ctx[dpos:-1]]), dev_i32([dpos]),
                                    dcfg)
            dpos += n_pending
        drafted, dlogits, dring = draft_chunk(
            draft_params, dring, dev_i32([ctx[-1]]), dev_i32([dpos]),
            generator, temp1, K, dcfg)
        # the draft wrote K rows (ctx[-1], d_1..d_{K-1})
        vtoks = torch.cat([dev_i32([[ctx[-1]]]), drafted], dim=1)
        logits, ring = score_tokens(params, ring, vtoks,
                                    dev_i32([len(ctx) - 1]), cfg)
        if temperature == 0.0:
            a, bonus = greedy_verify(logits, drafted)
        else:
            a, bonus = sample_verify(logits, dlogits, drafted, generator,
                                     temp1)
        a_i, bonus_i = int(a[0]), int(bonus[0])

        ring = rollback(ring, K - a_i)
        dkeep = min(a_i + 1, K)              # rows for ctx[-1], d_1..d_a
        dring = rollback(dring, K - dkeep)
        dpos += dkeep

        accepted = [int(t) for t in drafted[0, :a_i].tolist()] + [bonus_i]
        ctx.extend(accepted)
        out.extend(accepted)
        stats.rounds += 1
        stats.drafted += K
        stats.accepted += a_i
        stats.emitted += len(accepted)
        if len(ctx) >= S - (K + 2):
            break                            # the ring window is exhausted
    return out[:n_new], stats

