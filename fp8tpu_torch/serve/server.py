"""Async serving front-end: a scheduler thread around ServingEngine.

`ServingEngine.run()` is batch-synchronous (give it requests, get all
results).  Production serving needs requests arriving WHILE decode runs;
this wrapper owns the engine on one scheduler thread (the engine is not
thread-safe — single ownership is the concurrency model) and exposes:

  server = EngineServer(engine); server.start()
  fut = server.submit(Request(...), on_token=cb)   # thread-safe
  tokens = fut.result()
  server.stop()

The scheduler loop mirrors ``run()``'s admit → dispatch → reconcile
cadence; between work it parks on a condition variable, so an idle
server costs nothing.  CUDA work is launched from the scheduler thread only.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

from .engine import Request, ServingEngine


class EngineServer:
    """Single-scheduler-thread async wrapper around :class:`ServingEngine`."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self._cv = threading.Condition()
        self._incoming: List[Request] = []
        self._cancels: List[int] = []
        self._futures: Dict[int, Future] = {}
        self._callbacks: Dict[int, Callable[[int], None]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._info: Dict[int, Dict] = {}
        self._info_cap = 4096
        # tokens stream through the engine's callback on the scheduler
        # thread; per-uid callbacks must be fast (queue hand-off etc.)
        engine._on_token = self._emit

    # -- public (any thread) ---------------------------------------------

    def start(self) -> "EngineServer":
        assert self._thread is None, "already started"
        self._thread = threading.Thread(
            target=self._loop, name="fp8tpu-torch-engine", daemon=True)
        self._thread.start()
        return self

    def submit(self, req: Request,
               on_token: Optional[Callable[[int], None]] = None) -> Future:
        """Enqueue a request; returns a Future resolving to its token
        list.  ``on_token(token)`` streams tokens as they reconcile."""
        fut: Future = Future()
        with self._cv:
            if self._stop:
                raise RuntimeError("server stopped")
            if req.uid in self._futures:
                raise ValueError(f"uid {req.uid} already in flight")
            self._futures[req.uid] = fut
            if on_token is not None:
                self._callbacks[req.uid] = on_token
            self._incoming.append(req)
            self._cv.notify()
        return fut

    def cancel(self, uid: int) -> None:
        """Request cancellation; the future resolves with the partial
        token list."""
        with self._cv:
            self._cancels.append(uid)
            self._cv.notify()

    def stop(self, timeout: float = 60.0) -> None:
        """Finish in-flight work, then stop the scheduler thread."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- scheduler thread ---------------------------------------------------

    def _emit(self, uid: int, token: int) -> None:
        cb = self._callbacks.get(uid)
        if cb is not None:
            try:
                cb(token)
            except Exception:
                # a client's streaming callback must never take down
                # the scheduler; drop the stream, keep the future
                self._callbacks.pop(uid, None)

    def _drain_inbox(self) -> None:
        with self._cv:
            incoming, self._incoming = self._incoming, []
            cancels, self._cancels = self._cancels, []
        for req in incoming:
            try:
                self.engine.submit(req)
            except ValueError as e:      # invalid budget etc.
                fut = self._futures.pop(req.uid, None)
                self._callbacks.pop(req.uid, None)
                if fut is not None and not fut.done():
                    fut.set_exception(e)
        for uid in cancels:
            self.engine.cancel(uid)

    def pop_info(self, uid: int) -> Dict:
        """Take (and remove) a finished request's side info:
        {"logprobs": [...], "meta": {...}}.  The server DRAINS the
        engine's finished_logprobs/finished_meta maps (a long-running
        process would otherwise grow them without bound); callers that
        want them must pop after the future resolves."""
        with self._cv:
            return self._info.pop(uid, {})

    def _resolve_finished(self) -> None:
        if not self.engine.finished:
            return
        done, self.engine.finished = self.engine.finished, {}
        for uid, tokens in done.items():
            self._callbacks.pop(uid, None)
            with self._cv:
                self._info[uid] = {
                    "logprobs": self.engine.finished_logprobs.pop(uid,
                                                                  []),
                    "meta": self.engine.finished_meta.pop(uid, {}),
                }
                # bounded retention: callers that never pop must not
                # leak — drop the oldest entries past the cap
                while len(self._info) > self._info_cap:
                    self._info.pop(next(iter(self._info)))
            fut = self._futures.pop(uid, None)
            if fut is not None and not fut.done():
                fut.set_result(tokens)

    def _fail_all(self, exc: BaseException) -> None:
        with self._cv:
            futures, self._futures = self._futures, {}
            self._callbacks.clear()
            self._stop = True
        for fut in futures.values():
            if not fut.done():
                fut.set_exception(exc)

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as e:          # never die silently: every
            self._fail_all(e)               # waiter sees the error

    def _loop_inner(self) -> None:
        eng = self.engine
        while True:
            self._drain_inbox()
            eng._admit()
            worked = eng._dispatch()
            # reconcile past the pipeline depth (or fully when idle)
            while eng._inflight and (len(eng._inflight) > eng.depth
                                     or not eng._dispatchable()):
                eng._process(eng._inflight.popleft())
            self._resolve_finished()
            busy = (worked or eng.queue or eng._inflight
                    or any(s is not None for s in eng.slots))
            with self._cv:
                if self._stop and not (busy or self._incoming
                                       or self._cancels):
                    # fail any leftover futures (shouldn't happen)
                    for uid, fut in self._futures.items():
                        if not fut.done():
                            fut.set_exception(
                                RuntimeError("server stopped"))
                    return
                if not busy and not self._incoming and not self._cancels:
                    self._cv.wait(timeout=0.05)
