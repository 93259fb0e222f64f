"""Continuous-batching serving engine (ring cache).

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

Not ported yet, each raising NotImplementedError: the paged pool
(``use_paged=True``, with its page allocator and prefix cache) and batched
speculation (``draft_params=``).  ``run(on_token=)`` streams, ``cancel``
retires a request early, ``finished_logprobs`` / ``finished_meta`` carry
per-request side information; the threaded front end is
:class:`fp8tpu_torch.serve.EngineServer`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from fp8tpu_torch._device import resolve_device

from .kv_cache import RingKVCache
from .model import ServeConfig, _LATER, _check_cfg, decode_chunk, prefill_batch


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


class ServingEngine:
    """Continuous batching over ``n_slots`` concurrent sequences.  Runs on
    ``device`` (the card unless the caller passes ``"cpu"``); ``params``
    must live there."""

    def __init__(self, params: Dict, cfg: ServeConfig, n_slots: int = 8,
                 max_seq: Optional[int] = None, seed: int = 0,
                 chunk_size: int = 32, use_paged: bool = False,
                 depth: int = 2, prefix_cache: bool = False,
                 draft_params: Optional[Dict] = None, device="cuda"):
        if use_paged or prefix_cache:
            raise NotImplementedError(_LATER["paged"])
        if draft_params is not None:
            raise NotImplementedError(
                "batched speculation (draft_params=, serve/speculative.py) "
                "is not ported yet; it comes after the paged pool")
        _check_cfg(cfg, params)
        self.device = resolve_device(device)
        m = cfg.model
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq or m.max_seq_len
        # Upper bound on steps decoded per dispatch.
        self.chunk_size = max(1, chunk_size)
        # Chunks the host may lag behind the dispatch frontier before it
        # must reconcile results.
        self.depth = max(0, depth)
        self.use_paged = False
        self.cache = RingKVCache.create(m.n_layers, n_slots, self.max_seq,
                                        m.n_kv_heads, m.head_dim, cfg.kv_fmt,
                                        device=self.device)
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
    def submit(self, req: Request):
        if req.max_new_tokens > self.max_seq - 2:
            # a larger budget would leave _trim_prompt with a non-positive
            # keep length (prompt[-0:] keeps EVERYTHING, breaking the
            # prompt + budget <= max_seq window invariant)
            raise ValueError(
                f"request {req.uid}: max_new_tokens={req.max_new_tokens} "
                f"does not fit max_seq={self.max_seq}; the engine can serve "
                f"at most {self.max_seq - 2} new tokens per request")
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
        keep = max(1, self.max_seq - req.max_new_tokens - 1)
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
        their surplus tokens are discarded at reconciliation."""
        tgt = max((self._rem_est(i) for i in range(self.n_slots)), default=0)
        if tgt <= 0:
            return 0
        return min(_pow2ceil(tgt), _pow2ceil(self.chunk_size))

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
        chunk = self._pick_chunk()
        if chunk == 0:
            return False
        temps, top_k, top_p = self._sampling_arrays()
        # static all-greedy hint: skips the per-step categorical draw
        greedy_only = (top_k is None and top_p is None and not any(
            s is not None and s.temperature > 0 for s in self.slots))
        toks, lps, self.cache, self._tokens_dev, self._pos_dev = \
            decode_chunk(self.params, self.cache, self._tokens_dev,
                         self._pos_dev, self.generator, temps, chunk,
                         self.cfg, top_k=top_k, top_p=top_p,
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

    def _process(self, entry):
        """Reconcile one chunk's results: consume tokens per slot up to
        budget/EOS, retire finished slots.  Tokens from a generation that
        no longer matches (slot refilled since dispatch) are dropped."""
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

    def _admit(self):
        """Admit every admissible queued request in ONE batched prefill
        (one host readback for the whole batch's first tokens)."""
        batch = []                                   # (slot, req, prompt)
        for i in range(self.n_slots):
            if not self.queue:
                break
            if self.slots[i] is not None:
                continue
            req = self.queue.pop(0)
            batch.append((i, req, self._trim_prompt(req)))
        if not batch:
            return
        sp = min(_bucket(max(len(p) for _, _, p in batch)), self.max_seq)
        n = _pow2ceil(len(batch))
        prompts = np.zeros((n, sp), np.int32)
        slots = np.full((n,), self.n_slots, np.int32)   # pad rows drop
        lengths = np.zeros((n,), np.int32)
        temps = np.zeros((n,), np.float32)
        tks = np.zeros((n,), np.int32)
        tps = np.ones((n,), np.float32)
        for j, (i, req, prompt) in enumerate(batch):
            prompts[j, :len(prompt)] = prompt
            slots[j] = i
            lengths[j] = len(prompt)
            temps[j] = req.temperature
            tks[j] = req.top_k
            tps[j] = req.top_p
        first, self.cache, self._tokens_dev, self._pos_dev = prefill_batch(
            self.params, self.cache, self._to_dev(prompts, torch.int32),
            self._to_dev(slots, torch.int32),
            self._to_dev(lengths, torch.int32), self.generator,
            self._to_dev(temps, torch.float32),
            self._to_dev(tks, torch.int32), self._to_dev(tps, torch.float32),
            self._tokens_dev, self._pos_dev, self.cfg)
        firsts = first.cpu().numpy()            # ONE readback per batch
        for j, (i, req, prompt) in enumerate(batch):
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
