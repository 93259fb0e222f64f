"""Minimal HTTP serving endpoint over the FP8 engine (stdlib only), the
port of the JAX package's ``examples/serve_http.py``.

POST /generate  {"prompt": [ints], "max_new_tokens": 32,
                 "temperature": 0.0, "stream": false}
  -> {"uid": n, "tokens": [...], "logprobs": [...], "meta": {...}}
  -> with "stream": true, newline-delimited JSON token events followed
     by the final summary line.
GET  /health    -> {"ok": true}
GET  /stats     -> engine counters (slots, queue depth, spec / prefix
                   counters when enabled)

ServingEngine + EngineServer (one scheduler thread) + http.server
(threaded handlers), on the card unless ``--device cpu``; with
``--paged`` decode attention walks the pages on K4, as in serve_llm:

    python -m fp8tpu_torch.examples.serve_http --port 8471 [--paged]
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
from typing import Callable, Dict, Optional

from fp8tpu_torch.examples._common import add_device_flag
from fp8tpu_torch.examples.serve_llm import serve_config, serve_params
from fp8tpu_torch.models.transformer import DecoderConfig
from fp8tpu_torch.serve import EngineServer, Request, ServingEngine


def build_server(args, variables: Optional[Dict] = None):
    """(a started EngineServer, its engine) for the script's flags."""
    cfg = DecoderConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(4, args.d_model // 64), d_ff=args.d_model * 3,
        max_seq_len=args.max_seq)
    device = getattr(args, "device", "cuda")
    params = serve_params(cfg, args.weight_fmt, device, 0, variables)
    scfg = serve_config(cfg, args)
    engine = ServingEngine(params, scfg, n_slots=args.slots,
                           max_seq=args.max_seq, use_paged=args.paged,
                           prefix_cache=args.paged, device=device)
    return EngineServer(engine).start(), engine


def make_handler(srv, engine, uid_counter):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"ok": True})
            if self.path == "/stats":
                stats = {
                    "slots_busy": sum(s is not None for s in engine.slots),
                    "n_slots": engine.n_slots,
                    "queued": len(engine.queue),
                }
                if getattr(engine, "spec", False):
                    stats["spec_rounds"] = engine.spec_rounds
                    stats["spec_acceptance"] = (
                        engine.spec_accepted
                        / max(engine.spec_drafted, 1))
                if getattr(engine, "prefix_cache", False):
                    stats["prefix_tokens_reused"] = getattr(
                        engine, "prefix_tokens_reused", 0)
                return self._json(200, stats)
            self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt = [int(t) for t in body["prompt"]]
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            uid = next(uid_counter)
            req = Request(uid=uid, prompt=prompt,
                          max_new_tokens=int(
                              body.get("max_new_tokens", 32)),
                          temperature=float(body.get("temperature", 0.0)),
                          eos_id=body.get("eos_id"))
            if body.get("stream"):
                toks: "queue.Queue" = queue.Queue()
                try:
                    fut = srv.submit(req, on_token=toks.put)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.end_headers()
                while True:
                    if fut.done() and toks.empty():
                        break
                    try:
                        tok = toks.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    self.wfile.write(
                        json.dumps({"token": tok}).encode() + b"\n")
                    self.wfile.flush()
                try:
                    tokens = fut.result()
                except ValueError as e:
                    self.wfile.write(
                        json.dumps({"error": str(e)}).encode() + b"\n")
                    return
                info = srv.pop_info(uid)
                self.wfile.write(json.dumps(
                    {"uid": uid, "tokens": tokens,
                     "meta": info.get("meta", {})}
                ).encode() + b"\n")
                return
            try:
                fut = srv.submit(req)
                tokens = fut.result()
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            info = srv.pop_info(uid)
            self._json(200, {
                "uid": uid,
                "tokens": tokens,
                "logprobs": info.get("logprobs", []),
                "meta": info.get("meta", {}),
            })

    return Handler


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=8471)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--weight-fmt", default="int8")
    ap.add_argument("--kv-fmt", default="int8")
    ap.add_argument("--paged", action="store_true")
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None, variables: Optional[Dict] = None,
         until: Optional[Callable[[int], object]] = None) -> Dict:
    """Serve until interrupted.  With ``until``, a callable of the port
    run in a thread once the server listens, serve until it returns, then
    shut down and return its result with the printed lines."""
    from http.server import ThreadingHTTPServer
    from itertools import count

    args = parse(argv)
    srv, engine = build_server(args, variables)
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port),
                                make_handler(srv, engine, count()))
    line = (f"fp8tpu serving on http://127.0.0.1:{args.port} "
            f"(weights {args.weight_fmt}, kv {args.kv_fmt}, "
            f"{'paged' if args.paged else 'ring'})")
    print(line, flush=True)
    result = {"lines": [line], "engine": engine}
    if until is not None:
        def drive():
            try:
                result["until"] = until(args.port)
            except BaseException as e:  # raised again on main's thread
                result["error"] = e
            finally:
                httpd.shutdown()
        threading.Thread(target=drive, daemon=True).start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        srv.stop()
    if "error" in result:
        raise result.pop("error")
    return result


if __name__ == "__main__":
    main()
