"""Continuous-batching serving engine (ring cache or paged pool).

Single-host scheduler around the chunked serving decoder: a fixed pool of
batch slots, each with its own sequence position; new requests prefill
into free slots while decode continues for the rest.

* **Fixed decode chunks + device-side parking.**  The chunk length is a
  power of two sized to the LONGEST remaining budget (capped at
  ``chunk_size``).  A slot that retires (budget / EOS) mid-chunk is
  *parked*: the device keeps decoding it (batch shapes are static) and the
  host discards its surplus tokens at reconciliation.  Ring garbage is
  overwritten by the next prefill's window.
* **Batched admission.**  All admissible queued requests prefill in ONE
  ``prefill_batch`` call: prompts pad to a shared length bucket, the
  admission count pads to a power-of-two bucket, first tokens sample on
  the device with per-request parameters, and the engine's device
  token/position carry is patched in the same call.
* **Pipelined dispatch.**  Decode chunks chain through a device-resident
  (tokens, positions, cache) carry (``decode_chunk``), so issuing chunk k+1
  never waits for chunk k's readback.  Each chunk's tokens are copied to
  pinned host memory behind an event; the host reconciles (EOS / budget
  retirement) up to ``depth`` chunks behind the dispatch frontier, and
  per-slot generation counters discard tokens a parked slot produced after
  its logical retirement.

* **Paged pool** (``use_paged=True``).  Each slot holds up to ``max_seq``
  tokens exactly, in pages allocated at admission for the prompt and the
  whole budget and reclaimed at retirement; a request stays queued while
  the pool cannot satisfy it.  The page table lives on the host and is
  uploaded, when it changed, before an admission and before a dispatch.
  With ``prefix_cache=True`` the pages wholly inside a prompt are
  content-addressed by their full token history: a later prompt with the
  same prefix maps the SAME physical pages (refcounted, never rewritten),
  and cached pages without a holder stay resident until the pool runs dry,
  then evict least recently used first.

  ``prefix_compute_reuse=True`` also skips recomputing the cached prefix:
  admissions score only the uncached suffix against the shared pages
  (``speculative.prefill_scored_paged``; the suffix starts on a page
  boundary), cold requests the whole prompt the same way.
* **Batched speculation** (``draft_params=``, paged only; ignored on the
  ring, as in the JAX package).  A draft model's pool holds one table row
  per slot; admission prefills the draft too.  A dispatch chains
  ``spec_rounds_per_dispatch`` rounds (``speculative.spec_rounds``): draft
  ``k_spec`` tokens for every slot, verify them in one multi-token pass,
  advance each slot by its accepted count, all on the device.  The window
  reserves ``rounds * (k_spec + 1)`` positions for the last dispatch's
  writes; ``spec_rounds`` / ``spec_drafted`` / ``spec_accepted`` count.

``run(on_token=)`` streams, ``cancel`` retires a request early,
``finished_logprobs`` / ``finished_meta`` carry per-request side
information (speculation rounds and the admission's first token carry no
logprob); the threaded front end is
:class:`fp8tpu_torch.serve.EngineServer`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from fp8tpu_torch._device import resolve_device

from .kv_cache import PagedKVCache, RingKVCache
from .model import (ServeConfig, ShardedServeParams, _check_cfg,
                    _scatter_slots, decode_chunk, decode_chunk_paged,
                    local_heads, prefill_batch, prefill_batch_paged,
                    shard_serve_params)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> disabled
    top_p: float = 1.0           # >= 1 -> disabled
    eos_id: Optional[int] = None


@dataclasses.dataclass
class _SlotState:
    uid: int
    pos: int                     # next write position (host view)
    remaining: int
    temperature: float
    top_k: int
    top_p: float
    eos_id: Optional[int]
    tokens: List[int]            # generated tokens
    logprobs: List[float] = dataclasses.field(default_factory=list)
    t_first: float = 0.0         # wall time of the first sampled token


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return _pow2ceil(n)   # longer prompts: exact pow2, never truncate


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _Readback:
    """Device tensors on their way to the host.  On a CUDA device the copy
    goes to pinned memory on the issuing stream and an event marks its end,
    so :meth:`get` waits for this chunk only, not for chunks enqueued after
    it."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                     pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def _shard_of(params, cfg: ServeConfig, mesh) -> ShardedServeParams:
    """``params`` as this rank's shard over ``mesh``: a whole artifact is
    sharded, a shard is taken as it is."""
    if isinstance(params, ShardedServeParams):
        return params
    return shard_serve_params(params, cfg, mesh)


class ServingEngine:
    """Continuous batching over ``n_slots`` concurrent sequences.  Runs on
    ``device`` (the card unless the caller passes ``"cpu"``); ``params``
    must live there.

    ``mesh`` (a ``parallel.Mesh`` with its process groups): tensor-parallel
    serving over the mesh's model group.  ``params`` (and ``draft_params``)
    are the whole artifact, which every rank passes and shards
    (``serve.model.shard_serve_params``), or this rank's shard; the caches
    hold the rank's KV heads.  Every rank runs this same host scheduler
    over the same requests: each branch it takes reads only values that
    are equal on every rank (the gathered logits' samples, drawn with the
    same seed), so every rank returns the same outputs.  The data axis
    replicates, as the serving rules name none."""

    def __init__(self, params: Dict, cfg: ServeConfig, n_slots: int = 8,
                 max_seq: Optional[int] = None, seed: int = 0,
                 chunk_size: int = 32, use_paged: bool = False,
                 page_size: int = 64, n_pages: Optional[int] = None,
                 depth: int = 2, prefix_cache: bool = False,
                 prefix_compute_reuse: bool = False,
                 draft_params: Optional[Dict] = None,
                 draft_cfg: Optional[ServeConfig] = None,
                 k_spec: int = 4, spec_rounds_per_dispatch: int = 1,
                 device="cuda", mesh=None):
        _check_cfg(cfg)
        self.device = resolve_device(device)
        m = cfg.model
        if mesh is not None:
            params = _shard_of(params, cfg, mesh)
            if draft_params is not None:
                if draft_cfg is None:
                    raise ValueError("draft_params needs draft_cfg")
                draft_params = _shard_of(draft_params, draft_cfg, mesh)
        self.mesh = mesh
        self.params = params
        # the KV heads this rank caches (its own under a mesh that splits
        # whole KV heads)
        kv_heads = local_heads(params, m)[1]
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq or m.max_seq_len
        # Upper bound on steps decoded per dispatch.
        self.chunk_size = max(1, chunk_size)
        # Chunks the host may lag behind the dispatch frontier before it
        # must reconcile results.
        self.depth = max(0, depth)
        # Ring (throughput, per-slot sliding window of max_seq) or paged
        # pool (long context: each slot holds up to max_seq tokens exactly,
        # memory allocated page-wise, reclaimed on retirement).
        self.use_paged = use_paged
        if use_paged:
            max_pages = -(-self.max_seq // page_size)
            if n_pages is None:
                n_pages = n_slots * max_pages
            self.cache = PagedKVCache.create(
                n_pages, page_size, m.n_layers, n_slots, max_pages,
                kv_heads, m.head_dim, cfg.kv_fmt, device=self.device)
            self.free_pages: List[int] = list(range(n_pages))
            self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
            # The page table lives on the host: admissions and retirements
            # edit it with no device work, and one small upload per
            # admission / dispatch carries the changes.
            self._table = np.full((n_slots, max_pages), -1, np.int32)
            self._table_dirty = False
            # Shared-prefix page cache: pages wholly inside a prompt are
            # content-addressed by their full token history; a later
            # request with the same prefix maps the SAME physical pages.
            # Admission never writes shared pages (write_starts masks the
            # positions they cover); the win is pool capacity.  Reclamation
            # is refcounted; cached pages with no holder stay resident and
            # evict LRU when the pool runs dry.
            self.prefix_cache = prefix_cache
            self._page_ref = np.zeros(n_pages, np.int64)
            self._prefix_index: "OrderedDict[tuple, int]" = OrderedDict()
            self._page_prefix: Dict[int, tuple] = {}
            # admission counters: private pages allocated, shared pages
            # mapped, and the most slots that held one page at once
            self.page_stats = {"allocated": 0, "shared": 0, "max_ref": 0}
            # Compute-level reuse: admissions score only the uncached
            # suffix against the shared pages; cold requests take the same
            # path with a cached length of 0.
            self.prefix_reuse = prefix_cache and prefix_compute_reuse
            self.prefix_tokens_reused = 0
        else:
            self.prefix_cache = self.prefix_reuse = False
            self.cache = RingKVCache.create(
                m.n_layers, n_slots, self.max_seq, kv_heads, m.head_dim,
                cfg.kv_fmt, device=self.device)
        # Batched speculation (paged only): pages address by logical
        # position, so each slot advances by its own accepted count.
        self.spec = use_paged and draft_params is not None
        if self.spec:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            _check_cfg(draft_cfg)
            dm = draft_cfg.model
            max_pages = -(-self.max_seq // page_size)
            self.draft_params, self.draft_cfg = draft_params, draft_cfg
            self.k_spec = max(1, k_spec)
            # rounds chained per dispatch: the dispatch's host cost spread
            # over R * (K + 1) potential tokens
            self.spec_rpd = max(1, spec_rounds_per_dispatch)
            # the draft pool statically owns one table row per slot
            self.dcache = PagedKVCache.create(
                n_slots * max_pages, page_size, dm.n_layers, n_slots,
                max_pages, local_heads(draft_params, dm)[1], dm.head_dim,
                draft_cfg.kv_fmt,
                device=self.device)
            self.dcache.page_table = torch.arange(
                n_slots * max_pages, dtype=torch.int32,
                device=self.device).reshape(n_slots, max_pages)
            self._pend = torch.zeros((n_slots, 2), dtype=torch.int32,
                                     device=self.device)
            self._pend_n = torch.ones((n_slots,), dtype=torch.int32,
                                      device=self.device)
            self._dpos = torch.zeros((n_slots,), dtype=torch.int32,
                                     device=self.device)
            self.spec_rounds = self.spec_drafted = self.spec_accepted = 0
        self.slots: List[Optional[_SlotState]] = [None] * n_slots
        self.queue: List[Request] = []
        self._on_token = None
        # request lifecycle metrics: submit->first-token and
        # submit->retire wall times per uid
        self._submit_t: Dict[int, float] = {}
        self.finished_meta: Dict[int, Dict[str, float]] = {}
        # per-uid log P(token) under the model distribution (the admission
        # first token carries no logprob and leaves the list shorter than
        # the tokens)
        self.finished_logprobs: Dict[int, List[float]] = {}
        self.finished: Dict[int, List[int]] = {}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # Device-resident decode carry (chained across dispatches).
        self._tokens_dev = torch.zeros((n_slots,), dtype=torch.int32,
                                       device=self.device)
        self._pos_dev = torch.zeros((n_slots,), dtype=torch.int32,
                                    device=self.device)
        # Per-slot admission generation: reconciliation drops tokens whose
        # dispatch-time generation no longer matches (slot was refilled).
        self._gen = [0] * n_slots
        # Decode steps dispatched but not yet reconciled, per slot.
        self._pending = [0] * n_slots
        self._inflight: deque = deque()

    # -- public API ------------------------------------------------------
    def _reserve(self) -> int:
        """Positions the last speculation dispatch may write past the
        budget: rounds * (k_spec + 1); 0 without speculation."""
        return self.spec_rpd * (self.k_spec + 1) if self.spec else 0

    def submit(self, req: Request):
        # top-k / top-p requests are served in spec mode too: the same
        # per-slot filter applies to the target and the draft law
        reserve = self._reserve()
        if req.max_new_tokens > self.max_seq - 2 - reserve:
            # a larger budget would leave _trim_prompt with a non-positive
            # keep length (prompt[-0:] keeps EVERYTHING, breaking the
            # prompt + budget <= max_seq window invariant)
            raise ValueError(
                f"request {req.uid}: max_new_tokens={req.max_new_tokens} "
                f"does not fit max_seq={self.max_seq}"
                + (f" with the rounds*(k_spec+1)={reserve} verify reserve"
                   if reserve else "")
                + f"; the engine can serve at most "
                  f"{self.max_seq - 2 - reserve} new tokens per request")
        if self.use_paged:
            prompt = self._trim_prompt(req)
            need_tokens = min(len(prompt) + req.max_new_tokens + 1,
                              self.max_seq)
            need = -(-need_tokens // self.cache.page_size)
            if need > self.cache.n_pages:
                raise ValueError(
                    f"request {req.uid} needs {need} pages but the pool "
                    f"only has {self.cache.n_pages}; lower max_new_tokens "
                    f"or grow n_pages")
        self._submit_t[req.uid] = time.time()
        self.queue.append(req)

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid: dequeue it, or retire its live slot
        (already-generated tokens land in ``finished``).  Tokens from
        in-flight dispatches for a cancelled slot are discarded by the
        normal parked-slot reconciliation.  Returns True if found."""
        for k, r in enumerate(self.queue):
            if r.uid == uid:
                del self.queue[k]
                self.finished[uid] = []
                self.finished_logprobs[uid] = []
                t0 = self._submit_t.pop(uid, time.time())
                self.finished_meta[uid] = {
                    "ttft_s": 0.0, "latency_s": round(time.time() - t0, 6),
                    "n_tokens": 0}
                return True
        for i in range(self.n_slots):
            st = self.slots[i]
            if st is not None and st.uid == uid:
                self._retire(i)
                return True
        return False

    def run(self, requests: Optional[List[Request]] = None,
            max_steps: int = 10 ** 6,
            on_token=None) -> Dict[int, List[int]]:
        """Drive the scheduler to completion.  ``on_token(uid, token)``
        streams every accepted token (including each request's first
        sampled token) in generation order as the host reconciles it:
        tokens arrive up to ``depth`` dispatches behind the frontier."""
        self._on_token = on_token
        for r in requests or ():
            self.submit(r)
        dispatched = 0
        while True:
            self._admit()
            if dispatched < max_steps and self._dispatch():
                dispatched += 1
            # Reconcile once the backlog exceeds the pipeline depth, or
            # when there is nothing left to dispatch (all in flight).
            while self._inflight and (len(self._inflight) > self.depth
                                      or not self._dispatchable()):
                self._process(self._inflight.popleft())
            if dispatched >= max_steps:
                while self._inflight:
                    self._process(self._inflight.popleft())
                break
            if not (self.queue or self._inflight
                    or any(s is not None for s in self.slots)):
                break
        out, self.finished = self.finished, {}
        return out

    def step(self):
        """Synchronous scheduler iteration (admit -> one chunk ->
        reconcile): the simple, fully reconciled variant of ``run``."""
        self._admit()
        if self._dispatch():
            self._process(self._inflight.popleft())

    # -- scheduler -------------------------------------------------------
    def _trim_prompt(self, req: Request) -> List[int]:
        # spec mode reserves the last dispatch's R * (K + 1) writes
        keep = max(1, self.max_seq - req.max_new_tokens - 1 - self._reserve())
        prompt = req.prompt[-keep:]
        return prompt if prompt else [0]   # empty: decode from BOS-like 0

    def _rem_est(self, i: int) -> int:
        st = self.slots[i]
        return 0 if st is None else st.remaining - self._pending[i]

    def _dispatchable(self) -> bool:
        return any(self._rem_est(i) > 0 for i in range(self.n_slots))

    def _pick_chunk(self) -> int:
        """Power-of-two chunk covering the LONGEST remaining budget (capped
        at chunk_size).  Slots finishing earlier are parked on the device;
        their surplus tokens are discarded at reconciliation.  On the ring
        with ring_flush = W > 1, chunks round up to a multiple of W (the
        head only advances by W: ring_flush=6 gives 6, 12, 24, ...)."""
        tgt = max((self._rem_est(i) for i in range(self.n_slots)), default=0)
        if tgt <= 0:
            return 0
        chunk = min(_pow2ceil(tgt), _pow2ceil(self.chunk_size))
        w = self.cfg.ring_flush
        if w and w > 1 and not self.use_paged:
            chunk = -(-max(chunk, w) // w) * w
        return chunk

    def _retire(self, i: int):
        st = self.slots[i]
        self.finished[st.uid] = st.tokens
        self.finished_logprobs[st.uid] = st.logprobs
        t0 = self._submit_t.pop(st.uid, st.t_first)
        self.finished_meta[st.uid] = {
            "ttft_s": round(st.t_first - t0, 6),
            "latency_s": round(time.time() - t0, 6),
            "n_tokens": len(st.tokens),
        }
        self.slots[i] = None
        self._pending[i] = 0
        if self.use_paged:
            if self.prefix_cache:
                for p in self._slot_pages[i]:
                    self._page_ref[p] -= 1
                    if self._page_ref[p] == 0 \
                            and p not in self._page_prefix:
                        self.free_pages.append(p)
                    # refcount-0 cached pages stay resident (evictable)
            else:
                self.free_pages.extend(self._slot_pages[i])
            self._slot_pages[i] = []
            self._table[i] = -1
            self._table_dirty = True

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` private pages: the free list first, then LRU
        eviction of cached refcount-0 prefix pages.  None if short, checked
        BEFORE evicting, so a failed allocation never destroys warm cache
        entries as a side effect."""
        evictable = 0
        if self.prefix_cache:
            evictable = sum(1 for p in self._prefix_index.values()
                            if self._page_ref[p] == 0)
        if len(self.free_pages) + evictable < n:
            return None
        pages = []
        while len(pages) < n and self.free_pages:
            pages.append(self.free_pages.pop())
        if len(pages) < n:
            for key in list(self._prefix_index):
                if len(pages) >= n:
                    break
                p = self._prefix_index[key]
                if self._page_ref[p] == 0:
                    del self._prefix_index[key]
                    del self._page_prefix[p]
                    pages.append(p)
        return pages

    def _shared_prefix_pages(self, prompt: List[int]) -> List[int]:
        """Longest chain of cached pages covering the prompt's full pages
        (positions the slot never rewrites: generation starts at
        len(prompt), beyond every fully covered page)."""
        if not self.prefix_cache:
            return []
        psz = self.cache.page_size
        shared = []
        for k in range(1, len(prompt) // psz + 1):
            key = tuple(prompt[:k * psz])
            page = self._prefix_index.get(key)
            if page is None:
                break
            self._prefix_index.move_to_end(key)
            shared.append(page)
        return shared

    def _register_prefix_pages(self, i: int, prompt: List[int]):
        """Content-address this slot's fully covered prompt pages (their
        bytes are final once the prefill wrote them)."""
        psz = self.cache.page_size
        for k in range(1, len(prompt) // psz + 1):
            key = tuple(prompt[:k * psz])
            page = self._slot_pages[i][k - 1]
            if key not in self._prefix_index:
                self._prefix_index[key] = page
                self._page_prefix[page] = key

    def _sync_table(self):
        """Upload the host page table if it changed, into a FRESH device
        tensor: with ``depth`` chunks in flight, launches already queued go
        on reading the table they were given (what the JAX package's
        functional update gives), so a retirement can never unmap pages
        under a running chunk."""
        if self.use_paged and self._table_dirty:
            self.cache.page_table = self._to_dev(self._table.copy(),
                                                 torch.int32)
            self._table_dirty = False

    def _to_dev(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype
                               ).to(self.device, non_blocking=True)

    def _sampling_arrays(self):
        temps = self._to_dev([s.temperature if s else 0.0
                              for s in self.slots], torch.float32)
        # Only engage the top-k/top-p filter when some active request asked
        # for it; filtering is per slot inside sample_tokens, so co-batched
        # unfiltered slots still draw from the full vocabulary.
        tks = [s.top_k if s else 0 for s in self.slots]
        tps = [s.top_p if s else 1.0 for s in self.slots]
        filtering = any(k > 0 for k in tks) or any(p < 1.0 for p in tps)
        top_k = self._to_dev(tks, torch.int32) if filtering else None
        top_p = self._to_dev(tps, torch.float32) if filtering else None
        return temps, top_k, top_p

    def _dispatch(self) -> bool:
        if self.spec:
            return self._dispatch_spec()
        chunk = self._pick_chunk()
        if chunk == 0:
            return False
        temps, top_k, top_p = self._sampling_arrays()
        # static all-greedy hint: skips the per-step categorical draw
        greedy_only = (top_k is None and top_p is None and not any(
            s is not None and s.temperature > 0 for s in self.slots))
        self._sync_table()
        decode = decode_chunk_paged if self.use_paged else decode_chunk
        toks, lps, self.cache, self._tokens_dev, self._pos_dev = decode(
            self.params, self.cache, self._tokens_dev, self._pos_dev,
            self.generator, temps, chunk, self.cfg, top_k=top_k, top_p=top_p,
            greedy_only=greedy_only)
        gens = []
        for i in range(self.n_slots):
            if self.slots[i] is not None:
                self._pending[i] += chunk
                gens.append(self._gen[i])
            else:
                gens.append(-1)
        self._inflight.append((_Readback(toks, lps), chunk, gens))
        return True

    def _dispatch_spec(self) -> bool:
        if not self._dispatchable():
            return False
        from .speculative import spec_rounds

        temps, top_k, top_p = self._sampling_arrays()
        self._sync_table()
        (drafted, a, bonus, self._pend, self._pend_n, self._pos_dev,
         self._dpos, self.cache, self.dcache) = spec_rounds(
            self.params, self.cache, self.draft_params, self.dcache,
            self._pend, self._pend_n, self._pos_dev, self._dpos,
            self.generator, temps, self.k_spec, self.spec_rpd, self.cfg,
            self.draft_cfg,
            any_sampled=any(s is not None and s.temperature > 0
                            for s in self.slots),
            filtering=top_k is not None or top_p is not None,
            top_k=top_k, top_p=top_p)
        gens = []
        for i in range(self.n_slots):
            if self.slots[i] is not None:
                # conservative: a dispatch emits at most R * (K + 1) tokens
                self._pending[i] += self._reserve()
                gens.append(self._gen[i])
            else:
                gens.append(-1)
        self._inflight.append(("spec", _Readback(drafted, a, bonus), gens))
        return True

    def _process(self, entry):
        """Reconcile one chunk's results: consume tokens per slot up to
        budget/EOS, retire finished slots.  Tokens from a generation that
        no longer matches (slot refilled since dispatch) are dropped."""
        if entry[0] == "spec":
            return self._process_spec(entry)
        readback, chunk, gens = entry
        toks, lps = readback.get()                  # (B, chunk) each
        for i in range(self.n_slots):
            st = self.slots[i]
            if st is None or gens[i] < 0 or gens[i] != self._gen[i]:
                continue
            self._pending[i] -= chunk
            for j in range(chunk):
                tok = int(toks[i, j])
                st.tokens.append(tok)
                st.logprobs.append(float(lps[i, j]))
                if self._on_token is not None:
                    self._on_token(st.uid, tok)
                st.pos += 1
                st.remaining -= 1
                if (st.remaining <= 0 or st.pos >= self.max_seq - 1
                        or (st.eos_id is not None and tok == st.eos_id)):
                    self._retire(i)
                    break

    def _process_spec(self, entry):
        """Reconcile one speculation dispatch (R chained rounds): each live
        slot emits, a round, its accepted drafts and the bonus token (1 to
        K + 1 tokens); a slot retiring mid-dispatch drops the remaining
        rounds' tokens (plain decode's within-chunk EOS break)."""
        _, readback, gens = entry
        drafted, a, bonus = readback.get()          # (R, B, K), (R, B) x 2
        R = drafted.shape[0]
        self.spec_rounds += R
        for i in range(self.n_slots):
            st = self.slots[i]
            if st is None or gens[i] < 0 or gens[i] != self._gen[i]:
                continue
            self._pending[i] -= self._reserve()
            for r in range(R):
                n_acc = int(a[r, i])
                self.spec_drafted += self.k_spec
                self.spec_accepted += n_acc
                emitted = [int(t) for t in drafted[r, i, :n_acc]]
                emitted.append(int(bonus[r, i]))
                retired = False
                for tok in emitted:
                    st.tokens.append(tok)
                    if self._on_token is not None:
                        self._on_token(st.uid, tok)
                    st.pos += 1
                    st.remaining -= 1
                    if (st.remaining <= 0 or st.pos >= self.max_seq - 1
                            or (st.eos_id is not None
                                and tok == st.eos_id)):
                        self._retire(i)
                        retired = True
                        break
                if retired:
                    break

    def _admit(self):
        """Admit every admissible queued request in ONE batched prefill
        (one host readback for the whole batch's first tokens)."""
        batch = []                            # (slot, req, prompt, cover)
        for i in range(self.n_slots):
            if not self.queue:
                break
            if self.slots[i] is not None:
                continue
            req = self.queue[0]
            prompt = self._trim_prompt(req)
            cover = 0
            if self.use_paged:
                # Map enough pages for prompt + generation budget up front;
                # stay queued (FIFO) if the pool can't satisfy it.  With
                # prefix_cache, cached pages covering the prompt's full
                # pages are mapped shared; only the rest allocates.
                need_tokens = min(len(prompt) + req.max_new_tokens + 1,
                                  self.max_seq)
                psz = self.cache.page_size
                need = -(-need_tokens // psz)
                shared = self._shared_prefix_pages(prompt)[:need]
                if self.prefix_reuse:
                    # the scored suffix must start ON a page boundary with
                    # at least one token left to score, so a fully covered
                    # prompt gives its last page back
                    shared = shared[:(len(prompt) - 1) // psz]
                # Pin shared pages BEFORE allocating: _alloc_pages evicts
                # refcount-0 cached pages, which must not include pages
                # just selected for this very admission.
                for p in shared:
                    self._page_ref[p] += 1
                priv = self._alloc_pages(need - len(shared))
                if priv is None:
                    for p in shared:
                        self._page_ref[p] -= 1
                    break
                pages = shared + priv
                if self.prefix_cache:
                    for p in priv:
                        self._page_ref[p] += 1
                self.page_stats["allocated"] += len(priv)
                self.page_stats["shared"] += len(shared)
                self.page_stats["max_ref"] = max(
                    self.page_stats["max_ref"],
                    max((int(self._page_ref[p]) for p in shared), default=0))
                self._slot_pages[i] = pages
                self._table[i] = -1
                self._table[i, :need] = pages
                self._table_dirty = True
                # positions covered by SHARED pages are never rewritten
                cover = len(shared) * psz
            self.queue.pop(0)
            batch.append((i, req, prompt, cover))
        if not batch:
            return
        sp = min(_bucket(max(len(p) for _, _, p, _ in batch)), self.max_seq)
        n = _pow2ceil(len(batch))
        prompts = np.zeros((n, sp), np.int32)
        slots = np.full((n,), self.n_slots, np.int32)   # pad rows drop
        lengths = np.zeros((n,), np.int32)
        temps = np.zeros((n,), np.float32)
        tks = np.zeros((n,), np.int32)
        tps = np.ones((n,), np.float32)
        wstarts = np.zeros((n,), np.int32)
        for j, (i, req, prompt, cover) in enumerate(batch):
            prompts[j, :len(prompt)] = prompt
            slots[j] = i
            lengths[j] = len(prompt)
            temps[j] = req.temperature
            tks[j] = req.top_k
            tps[j] = req.top_p
            wstarts[j] = cover
        self._sync_table()
        prompts_d = self._to_dev(prompts, torch.int32)
        slots_d = self._to_dev(slots, torch.int32)
        lengths_d = self._to_dev(lengths, torch.int32)
        temps_d = self._to_dev(temps, torch.float32)
        args = (self.params, self.cache, prompts_d, slots_d, lengths_d,
                self.generator, temps_d, self._to_dev(tks, torch.int32),
                self._to_dev(tps, torch.float32),
                self._tokens_dev, self._pos_dev, self.cfg)
        if self.prefix_reuse:
            first = self._admit_scored(batch, n, sp, slots_d, temps_d, tks,
                                       tps)
        elif self.use_paged:
            first, self.cache, self._tokens_dev, self._pos_dev = \
                prefill_batch_paged(
                    *args, write_starts=self._to_dev(wstarts, torch.int32)
                    if self.prefix_cache else None)
        else:
            first, self.cache, self._tokens_dev, self._pos_dev = \
                prefill_batch(*args)
        if self.spec:
            # prefill the draft pool too, and seed each admitted slot's
            # pending tokens with its first sampled token
            zeros = torch.zeros((self.n_slots,), dtype=torch.int32,
                                device=self.device)
            _, self.dcache, _, self._dpos = prefill_batch_paged(
                self.draft_params, self.dcache, prompts_d, slots_d,
                lengths_d, self.generator, temps_d, None, None, zeros,
                self._dpos, self.draft_cfg)
            self._pend = torch.stack(
                [_scatter_slots(self._pend[:, j], slots_d, first)
                 for j in range(2)], dim=1)
            self._pend_n = _scatter_slots(self._pend_n, slots_d,
                                          torch.ones_like(first))
        firsts = first.cpu().numpy()            # ONE readback per batch
        if self.prefix_cache:
            for i, _, prompt, _ in batch:
                self._register_prefix_pages(i, prompt)
        for j, (i, req, prompt, _) in enumerate(batch):
            tok = int(firsts[j])
            self._gen[i] += 1
            self._pending[i] = 0
            self.slots[i] = _SlotState(
                uid=req.uid, pos=len(prompt), remaining=req.max_new_tokens,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, eos_id=req.eos_id, tokens=[tok],
                t_first=time.time())
            if self._on_token is not None:
                self._on_token(req.uid, tok)
            # First sampled token counts toward the budget.
            self.slots[i].remaining -= 1
            if (self.slots[i].remaining <= 0
                    or (req.eos_id is not None and tok == req.eos_id)):
                self._retire(i)

    def _admit_scored(self, batch, n, sp, slots_d, temps_d, tks, tps):
        """Scored-suffix admission: each request's uncached suffix (its
        prompt past the pages it shares) scored against those pages in one
        ``prefill_scored_paged`` call.  Returns the first tokens (n,)."""
        from .speculative import prefill_scored_paged

        ssp = min(_bucket(max(len(p) - cl for _, _, p, cl in batch)), sp)
        suffix = np.zeros((n, ssp), np.int32)
        clens = np.zeros((n,), np.int32)
        slens = np.zeros((n,), np.int32)
        for j, (_, _, prompt, cl) in enumerate(batch):
            suffix[j, :len(prompt) - cl] = prompt[cl:]
            clens[j] = cl
            slens[j] = len(prompt) - cl
            self.prefix_tokens_reused += cl
        filt = any(t > 0 for t in tks[:len(batch)]) \
            or any(p < 1.0 for p in tps[:len(batch)])
        first, self.cache, self._tokens_dev, self._pos_dev = \
            prefill_scored_paged(
                self.params, self.cache, self._to_dev(suffix, torch.int32),
                slots_d, self._to_dev(clens, torch.int32),
                self._to_dev(slens, torch.int32), self.generator, temps_d,
                self._tokens_dev, self._pos_dev, self.cfg,
                top_k=self._to_dev(tks, torch.int32) if filt else None,
                top_p=self._to_dev(tps, torch.float32) if filt else None)
        return first
