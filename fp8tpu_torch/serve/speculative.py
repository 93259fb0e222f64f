"""Speculative decoding for the serving stack: so far only the block write
into the paged pool, which the paged decode chunk's deferred pool update
uses.  Draft-and-verify speculation itself (``score_tokens``,
``score_tokens_paged``, ``rollback``, ``greedy_verify``, ``sample_verify``,
``filter_logits``, ``draft_chunk``, ``prefill_chunked_paged``,
``prefill_scored_paged``, ``spec_round``, ``spec_rounds``,
``speculative_decode``, ``SpecStats``) is not ported yet; each of those
names raises NotImplementedError."""

from __future__ import annotations

import torch

_LATER = ("{name} is not ported yet: draft-and-verify speculation "
          "(serve/speculative.py) comes with the speculation slice of the "
          "port, after the paged pool")


def _paged_write_block(paged, fk8, fks, fv8, fvs, starts, valid_t,
                       table=None, row_valid=None):
    """Scatter a (B, T) block of fresh k/v into the page pool in place: row
    b's token t lands at logical position ``starts[b] + t``; tokens with
    ``t >= valid_t[b]``, out-of-window positions and unmapped pages DROP (to
    the pool's scratch page).  fk8/fv8: (L, B, T, KV, D); fks/fvs: (L, B,
    T, KV).  ``table`` (B, MP) overrides the pool's own page table; rows
    with ``row_valid[b] == False`` drop entirely."""
    from .model import _paged_scatter
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


def _later(name: str):
    def raiser(*_args, **_kwargs):
        raise NotImplementedError(_LATER.format(name=name))
    raiser.__name__ = name
    return raiser


for _name in ("score_tokens", "score_tokens_paged", "rollback",
              "greedy_verify", "filter_logits", "sample_verify",
              "draft_chunk", "prefill_chunked_paged", "prefill_scored_paged",
              "spec_round", "spec_rounds", "SpecStats", "speculative_decode"):
    globals()[_name] = _later(_name)
del _name
