"""Minimal REST text-generation server: the continuous-batching engine, or
the serialized single-shot path.

The port's counterpart of ``galvatron_tpu/server.py``:

  POST or PUT /api   {"prompts": ["..."], "tokens_to_generate": 32,
                      "temperature": 0.0, "top_k": 0, "top_p": 0.0}
                     → {"text": [...completions...], "tokens": [[...ids...]]}
  GET /healthz       → status, uptime, request counters, model summary and
                       the engine's ``stats()`` under "serving" (the
                       serialized path: the pending-work gate under "gate")
  GET /readyz        → 200 {"ready": true} while accepting traffic, 503
                       while starting, draining, or after the engine died
  POST /drain        → graceful drain: admission closes, queued requests
                       are shed, in-flight requests finish under
                       ``drain_timeout_s``; replies with the engine's
                       post-drain audit (``leaked``), then the server stops

With ``engine=None`` (``cli serve --num_slots 0``) each request runs
``generation.generate_np`` under one global lock, its pending work bounded
by ``max_pending`` (excess → 503). Unlike the reference, ``/drain`` replies
after the drain, with the audit, so a caller reads ``leaked`` from the
reply. ``/metrics``, ``/profile``, SLOs, trace ids and fault injection are
not ported yet (ROADMAP.md §1.4, "Serving extras").
"""

from __future__ import annotations

import json
import select
import signal
import socket
import threading
import time
from concurrent.futures import FIRST_EXCEPTION
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import torch

from galvatron_tpu_torch.device import resolve_device
from galvatron_tpu_torch.serving import resilience as rz
from galvatron_tpu_torch.serving.scheduler import QueueFull, RequestExpired
from galvatron_tpu_torch.utils.metrics import Counters


class _Gate:
    """Bounded pending-work gate for the serialized path, with visible
    saturation (capacity / in_use / rejected land in /healthz)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._sem = threading.BoundedSemaphore(capacity)
        self._lock = threading.Lock()
        self.in_use = 0  # guarded-by: self._lock
        self.rejected = 0  # guarded-by: self._lock

    def acquire(self) -> bool:
        ok = self._sem.acquire(blocking=False)
        with self._lock:
            if ok:
                self.in_use += 1
            else:
                self.rejected += 1
        return ok

    def release(self) -> None:
        with self._lock:
            self.in_use -= 1
        self._sem.release()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "in_use": self.in_use,
                "saturated": self.in_use >= self.capacity,
                "rejected": self.rejected,
            }


class ServiceBusy(RuntimeError):
    """Mapped to HTTP 503 (queue full / TTL expired / drain / engine
    restart); ``detail`` lands in the JSON body, ``retry_after_s`` in a
    ``Retry-After`` header."""

    def __init__(self, msg: str, detail: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.detail = detail
        self.retry_after_s = retry_after_s


class ClientDisconnected(RuntimeError):
    """The client vanished mid-generation; its requests were cancelled."""


class GenerationService:
    """HTTP-facing service over one :class:`~galvatron_tpu_torch.serving.
    engine.Engine`, or with ``engine=None`` the serialized path over
    ``params`` (draws from a generator seeded with ``seed``). ``device``
    defaults to the engine's; without a card and without an explicit CPU
    request, construction raises."""

    def __init__(self, cfg, tokenizer, engine, max_new_default: int = 64,
                 device=None, params=None, seed: int = 0):
        self.device = resolve_device(device if device is not None
                                     else getattr(engine, "device", None))
        if engine is None and params is None:
            raise ValueError("the serialized path (engine=None) needs params")
        self.cfg = cfg
        self.tok = tokenizer
        self.engine = engine
        self.params = params
        self.generator = (torch.Generator(device=self.device).manual_seed(seed)
                          if engine is None else None)
        self.lock = threading.Lock()  # one serialized generation at a time
        self.gate: Optional[_Gate] = None  # set by run_server (serialized path)
        self.max_new_default = max_new_default
        self.started_at = time.time()
        self.counters = Counters("succeeded", "failed", "rejected", "cancelled")
        self.draining = False
        self.drain_timeout_s = 30.0
        self.drain_audit: dict = {}
        self._drain_lock = threading.Lock()
        self._drained = threading.Event()
        # startup readiness gate: cli serve sets it and clears it once one
        # real generation has gone through the engine
        self.starting = False
        self.httpd: Optional[ThreadingHTTPServer] = None

    @property
    def ready(self) -> bool:
        if self.starting or self.draining:
            return False
        return self.engine is None or self.engine.alive

    def begin_drain(self) -> dict:
        """Graceful drain, blocking until drained or the deadline; returns
        the engine's post-drain audit. A second caller waits for the first."""
        with self._drain_lock:
            first = not self.draining
            self.draining = True
        if not first:
            self._drained.wait(timeout=self.drain_timeout_s + 10.0)
            return self.drain_audit
        if self.engine is not None:
            self.engine.begin_drain()
            self.drain_audit = self.engine.drain(self.drain_timeout_s)
        else:
            # serialized path: handlers stop admitting (``draining``); wait
            # for the in-flight generations to release the gate
            deadline = time.monotonic() + self.drain_timeout_s
            while time.monotonic() < deadline:
                if self.gate is None or self.gate.snapshot()["in_use"] == 0:
                    break
                time.sleep(0.02)
            g = self.gate.snapshot() if self.gate is not None else {}
            self.drain_audit = {"leaked": bool(g.get("in_use")), **g}
        self._drained.set()
        return self.drain_audit

    def health(self) -> dict:
        c = self.cfg
        req = self.counters.snapshot()
        out = {
            "status": "draining" if self.draining else "starting" if self.starting else "ok",
            "ready": self.ready,
            "uptime_s": round(time.time() - self.started_at, 3),
            "requests_served": req["succeeded"],
            "requests": req,
            "model": {
                "vocab_size": c.vocab_size,
                "hidden_size": c.hidden_size,
                "num_layers": c.num_layers,
                "num_heads": c.num_heads,
                "num_kv_heads": c.kv_heads,
                "max_seq_len": c.max_seq_len,
            },
        }
        if self.gate is not None:
            out["gate"] = self.gate.snapshot()
        if self.engine is not None:
            out["serving"] = self.engine.stats()
        return out

    def _validate(self, body: dict):
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        prompts = body.get("prompts")
        if not isinstance(prompts, list) or not prompts or not all(
            isinstance(p, str) for p in prompts
        ):
            raise ValueError("'prompts' must be a non-empty list of strings")
        n_new = int(body.get("tokens_to_generate", self.max_new_default))
        if n_new < 0 or n_new > self.cfg.max_seq_len:
            raise ValueError(f"tokens_to_generate out of range [0, {self.cfg.max_seq_len}]")
        return prompts, n_new

    def generate(self, body: dict,
                 disconnect_check: Optional[Callable[[], bool]] = None) -> dict:
        prompts, n_new = self._validate(body)
        tok_prompts = [self.tok.encode(p) for p in prompts]
        if self.engine is not None:
            outs, truncated = self._generate_engine(body, tok_prompts, n_new, disconnect_check)
        else:
            outs = self._generate_serialized(body, tok_prompts, n_new)
            truncated = [None] * len(outs)
        texts = [self.tok.decode(o[len(tp):]) for o, tp in zip(outs, tok_prompts)]
        resp = {"text": texts, "tokens": outs}
        if any(truncated):
            resp["truncated"] = truncated
        return resp

    def _generate_engine(self, body: dict, tok_prompts, n_new: int,
                         disconnect_check: Optional[Callable[[], bool]] = None):
        """One engine request per prompt, futures resolved as slots retire;
        ``disconnect_check`` polls the client socket meanwhile, and a
        vanished client cancels its requests."""
        ttl = body.get("ttl_s")
        reqs = []
        try:
            for tp in tok_prompts:
                reqs.append(self.engine.submit_request(
                    tp, n_new,
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 0.0)),
                    ttl_s=float(ttl) if ttl is not None else None,
                ))
            deadline = time.monotonic() + self.engine.result_timeout_s
            pending = {r.future for r in reqs}
            while pending:
                done, pending = futures_wait(pending, timeout=0.05,
                                             return_when=FIRST_EXCEPTION)
                if done and any(f.exception() is not None for f in done):
                    break  # propagate via .result() below
                if not pending:
                    break
                if disconnect_check is not None and disconnect_check():
                    for r in reqs:
                        r.cancel("disconnect")
                    self.counters.inc("cancelled")
                    raise ClientDisconnected("client vanished mid-generation; requests cancelled")
                if time.monotonic() > deadline:
                    raise FuturesTimeout()
            outs = [r.future.result(timeout=self.engine.result_timeout_s) for r in reqs]
            truncated = [r.finish_reason if r.finish_reason == "deadline" else None
                         for r in reqs]
            return outs, truncated
        except QueueFull as e:
            raise ServiceBusy(str(e), detail="queue_full",
                              retry_after_s=self.engine.busy_retry_after_s) from e
        except (RequestExpired, rz.DeadlineExceeded) as e:
            raise ServiceBusy(str(e), detail="expired") from e
        except rz.RequestShed as e:
            raise ServiceBusy(str(e), detail="shed") from e
        except rz.EngineDraining as e:
            raise ServiceBusy(str(e), detail="draining", retry_after_s=e.retry_after_s) from e
        except rz.EngineRestarted as e:
            raise ServiceBusy(str(e), detail="engine_restarted",
                              retry_after_s=e.retry_after_s) from e
        except rz.EngineClosed as e:
            raise ServiceBusy(str(e), detail="engine_closed") from e
        except FuturesTimeout as e:
            raise RuntimeError(
                f"generation timed out after {self.engine.result_timeout_s}s"
            ) from e
        finally:
            # failed or abandoned siblings must not burn card time
            for r in reqs:
                r.cancel("abandoned")
                r.future.cancel()


    def _generate_serialized(self, body: dict, tok_prompts, n_new: int):
        """Single-shot path: a full prefill + decode per request under the
        global lock."""
        from galvatron_tpu_torch.models import generation

        with self.lock:
            return generation.generate_np(
                self.params, self.cfg, tok_prompts, generator=self.generator,
                max_new_tokens=n_new,
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 0.0)),
                eos_id=self.tok.eos_id, pad_id=self.tok.pad_id,
            )


def _make_handler(service: GenerationService, request_timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        timeout = request_timeout_s

        def _reply(self, code: int, payload: dict, headers: Optional[dict] = None):
            data = json.dumps(payload).encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)
            except OSError:  # the client went away: drop the connection
                self.close_connection = True

        def _client_disconnected(self) -> bool:
            """The body was read in full, so a readable socket with zero
            bytes is the client's FIN; a reset raises."""
            try:
                r, _, _ = select.select([self.connection], [], [], 0)
                if not r:
                    return False
                return self.connection.recv(1, socket.MSG_PEEK) == b""
            except OSError:
                return True

        def _handle(self):
            route = self.path.partition("?")[0].rstrip("/")
            if route == "/drain":
                audit = service.begin_drain()
                self._reply(200, {"status": "drained", "leaked": audit.get("leaked"),
                                  "audit": audit})
                if service.httpd is not None:
                    # shutdown() waits for serve_forever, which runs on
                    # another thread: stop it from a third one
                    threading.Thread(target=service.httpd.shutdown, daemon=True).start()
                return
            if route != "/api":
                return self._reply(404, {"error": "use /api or /drain"})
            if service.draining:
                service.counters.inc("rejected")
                return self._reply(
                    503, {"error": "server draining", "detail": "draining"},
                    headers={"Retry-After": str(max(1, int(service.drain_timeout_s)))},
                )
            # bounded pending work on the serialized path (a thread parked on
            # the generation lock is not covered by the socket timeout); the
            # engine's bounded queue is its admission control instead
            gate = service.gate
            if gate is not None and not gate.acquire():
                service.counters.inc("rejected")
                return self._reply(503, {"error": "server busy: too many pending requests"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                resp = service.generate(body, disconnect_check=self._client_disconnected)
                service.counters.inc("succeeded")
                return self._reply(200, resp)
            except ClientDisconnected:
                self.close_connection = True
            except ServiceBusy as e:
                service.counters.inc("rejected")
                payload = {"error": str(e)}
                if e.detail:
                    payload["detail"] = e.detail
                headers = None
                if e.retry_after_s is not None:
                    headers = {"Retry-After": str(max(1, int(e.retry_after_s)))}
                return self._reply(503, payload, headers)
            except TimeoutError:
                # stalled client mid-body: nobody to reply to
                self.close_connection = True
            except ValueError as e:
                service.counters.inc("failed")
                return self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface to the client
                service.counters.inc("failed")
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                if gate is not None:
                    gate.release()

        do_POST = _handle
        do_PUT = _handle

        def do_GET(self):
            route = self.path.partition("?")[0].rstrip("/")
            if route == "/healthz":
                return self._reply(200, service.health())
            if route == "/readyz":
                if service.ready:
                    return self._reply(200, {"ready": True})
                return self._reply(503, {
                    "ready": False,
                    "status": ("draining" if service.draining
                               else "starting" if service.starting else "engine_dead"),
                })
            return self._reply(404, {"error": "use /api, /drain (POST) or /healthz, /readyz (GET)"})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def drain_and_stop(service: GenerationService) -> dict:
    """SIGTERM's shutdown sequence: drain, then stop ``serve_forever``."""
    audit = service.begin_drain()
    if service.httpd is not None:
        service.httpd.shutdown()
    return audit


def run_server(service: GenerationService, port: int = 5000, host: str = "127.0.0.1",
               ready_event: Optional[threading.Event] = None,
               request_timeout_s: float = 120.0, max_pending: int = 8,
               drain_timeout_s: float = 30.0) -> None:
    """Serve until drained. ``port=0`` binds an ephemeral port (read it from
    ``service.httpd.server_address``). SIGTERM drains when this runs on the
    main thread. On the serialized path ``max_pending`` bounds the queued
    /api work (excess → 503)."""
    if service.engine is None:
        service.gate = _Gate(max_pending)
    service.drain_timeout_s = float(drain_timeout_s)
    httpd = ThreadingHTTPServer((host, port), _make_handler(service, request_timeout_s))
    httpd.daemon_threads = True
    service.httpd = httpd
    try:
        signal.signal(
            signal.SIGTERM,
            lambda signum, frame: threading.Thread(
                target=drain_and_stop, args=(service,), daemon=True
            ).start(),
        )
    except ValueError:
        pass  # not the main thread
    if ready_event is not None:
        ready_event.set()
    print(f"generation server listening on http://{host}:{httpd.server_address[1]}/api",
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    if service.draining:
        print(f"server drained: leaked={service.drain_audit.get('leaked')} "
              f"audit={json.dumps(service.drain_audit)}", flush=True)
