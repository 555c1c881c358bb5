"""Continuous-batching generation engine on the slot or the paged KV
backend.

The port's counterpart of ``galvatron_tpu/serving/engine.py``. One loop
thread owns the device cache and runs, per iteration: admission of queued
requests into free slots (chunked prefill into the request's slot, or
through its block table after attaching any cached prefix), host-side
sampling from every active slot's last logits, retirement on eos / budget /
deadline / cancel, and ONE decode forward over all slots.

``kv_num_blocks=0`` (the default) keeps the contiguous slot cache
([[kv_slots]]): prefill through ``generation.forward_with_cache`` into one
slot's rows, decode through ``forward_with_cache_slots``, whose one-query
attention is plain PyTorch (``decode_attention``), as in the reference.
``kv_num_blocks != 0`` selects the paged backend ([[paged_kv]]): block
tables, copy-on-write prefix sharing, block-headroom admission, and decode
attention through the hand-written paged-decode kernel on the card
(``ops.flash_attention``).

PyTorch runs eagerly, so there is no jit program set to pin; the loop runs
under ``torch.inference_mode()``. Sampling stays on the host with each
request's own temperature/top_k/top_p; greedy host sampling is an argmax,
so the engine's greedy output is the reference's token for token.

``serve_quant``, speculative decoding, AOT warm start, tracing and fault
injection are not ported yet (ROADMAP.md §1.4 'Serving extras').
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from galvatron_tpu_torch.device import resolve_device
from galvatron_tpu_torch.models import generation, modeling
from galvatron_tpu_torch.models.modeling import ModelConfig
from galvatron_tpu_torch.models.generation import KVCache
from galvatron_tpu_torch.ops import flash_attention
from galvatron_tpu_torch.serving import resilience as rz
from galvatron_tpu_torch.serving.kv_slots import SlotKVCache
from galvatron_tpu_torch.serving.paged_kv import PagedKVCache
from galvatron_tpu_torch.serving.scheduler import Request, Scheduler
from galvatron_tpu_torch.utils.metrics import Counters, Histogram, QuantileWindow

#: decode-iteration latency bucket bounds (seconds)
_DECODE_STEP_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


def _sample_host(rng: np.random.Generator, logits: np.ndarray,
                 temperature: float, top_k: int, top_p: float) -> int:
    """temperature <= 0 → greedy argmax; else a draw from
    ``generation.host_probs``."""
    logits = np.asarray(logits, np.float64)
    if temperature <= 0:
        return int(np.argmax(logits))
    p = generation.host_probs(logits, temperature, top_k, top_p)
    return int(rng.choice(len(p), p=p))


class Engine:
    """Continuous-batching engine: ``submit()`` → Future, the loop thread
    does the rest. Handler threads call ``submit``/``stats``; ONE loop
    thread owns the device cache, the slot table and every forward.

    ``device``: ``None`` means ``cuda`` and raises without a card; tests
    pass ``device="cpu"``. ``params`` must already live on that device, in
    the layout of ``modeling.cast_params``."""

    def __init__(self, params, cfg: ModelConfig, *, device=None,
                 num_slots: int = 4, prefill_chunk: int = 32,
                 max_queue: int = 64, request_ttl_s: Optional[float] = 30.0,
                 max_seq_len: Optional[int] = None, eos_id: int = -1,
                 pad_id: int = 0, seed: int = 0,
                 result_timeout_s: float = 600.0, start_loop: bool = True,
                 deadline_policy: str = "partial",
                 max_engine_restarts: int = 3,
                 restart_backoff_s: float = 0.05,
                 drain_timeout_s: float = 30.0,
                 kv_block_size: int = 16,
                 kv_num_blocks: int = 0,
                 prefix_cache: bool = True):
        self.device = resolve_device(device)
        if deadline_policy not in ("partial", "fail"):
            raise ValueError(
                f"deadline_policy must be 'partial' or 'fail', got {deadline_policy!r}"
            )
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        modeling.check_supported(cfg)
        generation.check_generative(cfg, "serving")
        if params["embed"]["tok"].device != self.device:
            raise ValueError(
                f"params live on {params['embed']['tok'].device}, engine device is {self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.eos_id = int(eos_id)
        self.pad_id = int(pad_id)
        self.seed = int(seed)
        self.result_timeout_s = float(result_timeout_s)
        # kv_num_blocks != 0 selects the paged backend (-1 sizes the pool to
        # the slot cache's bytes); 0 keeps the contiguous slot cache. Both
        # expose the same allocator surface to the engine
        self.paged = int(kv_num_blocks) != 0
        if self.paged:
            self.slots = PagedKVCache(
                cfg, num_slots, self.device, block_size=kv_block_size,
                num_blocks=kv_num_blocks, max_seq_len=max_seq_len,
                prefix_cache=prefix_cache,
            )
        else:
            self.slots = SlotKVCache(cfg, num_slots, self.device, max_seq_len)
        # a chunk longer than the slot would slice past the cache end
        self.prefill_chunk = min(int(prefill_chunk), self.slots.max_seq_len)
        self.scheduler = Scheduler(max_queue=max_queue, default_ttl_s=request_ttl_s)
        self.deadline_policy = deadline_policy
        self.drain_timeout_s = float(drain_timeout_s)
        self.supervisor = rz.EngineSupervisor(
            max_restarts=max_engine_restarts, backoff_s=restart_backoff_s,
        )
        # steps: loop iterations with active slots; decode_steps: the decode
        # forwards among them (an iteration whose rows all retire runs none)
        self.counters = Counters(
            "steps", "decode_steps", "prefill_chunks", "prefill_tokens",
            "tokens_generated", "engine_restarts",
        )
        self.ttft = QuantileWindow(512)
        self.ttft_hist = Histogram()
        self.latency_hist = Histogram()
        self.decode_step_hist = Histogram(_DECODE_STEP_BUCKETS)
        self._last_logits = np.zeros((self.slots.num_slots, cfg.vocab_size), np.float32)
        self._by_slot: Dict[int, Request] = {}
        self._rng: Dict[int, np.random.Generator] = {}
        self._busy_s = 0.0
        self._last_step_tps = 0.0
        self._cond = threading.Condition()
        self._stop = False  # guarded-by: self._cond
        self._draining = False
        self._closed = False
        self._working = False  # loop thread inside one admit+step iteration
        self._thread = threading.Thread(target=self._loop, name="serving-engine", daemon=True)
        if start_loop:
            self._thread.start()

    # -- client side ----------------------------------------------------------

    def submit(self, tokens: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               ttl_s: Optional[float] = None) -> Future:
        """Enqueue one request; the Future resolves to the full token list
        (prompt + completion, eos excluded). Raises ``QueueFull`` on
        backpressure."""
        return self.submit_request(
            tokens, max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, ttl_s=ttl_s,
        ).future

    def submit_request(self, tokens: Sequence[int], max_new_tokens: int,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0,
                       ttl_s: Optional[float] = None) -> Request:
        """Like :meth:`submit` but returns the :class:`Request` (lifecycle
        state, ``finish_reason``, ``cancel()``). Refuses immediately when the
        engine is draining or closed."""
        if self._closed:
            raise rz.EngineClosed(
                "engine is closed"
                + (" (crash-restart budget exhausted)" if self.supervisor.gave_up else "")
            )
        if self._draining:
            raise rz.EngineDraining(
                "server is draining: not accepting new requests",
                retry_after_s=self.drain_timeout_s,
            )
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("empty prompt")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if not self.slots.fits(len(tokens), max_new_tokens):
            raise ValueError(
                f"prompt ({len(tokens)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine's slot capacity {self.slots.max_seq_len}"
            )
        req = Request(
            tokens=tokens, max_new_tokens=max_new_tokens,
            temperature=float(temperature), top_k=int(top_k), top_p=float(top_p),
        )
        if max_new_tokens == 0:
            self.scheduler.counters.inc("submitted")
            rz.advance(req, rz.COMPLETED, self.scheduler.counters, reason="zero_budget")
            req.finish_reason = "length"
            req.future.set_result(list(tokens))
            return req
        self.scheduler.submit(req, ttl_s=ttl_s)
        with self._cond:
            self._cond.notify()
        if self._closed:
            # close() raced the enqueue: nothing will pop the queue again
            exc = rz.EngineClosed("engine shut down")
            self.scheduler.drain(exc)
            raise exc
        return req

    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
                 **kw) -> List[List[int]]:
        """Submit all prompts at once so they overlap, then gather in order."""
        futures = [self.submit(p, max_new_tokens, **kw) for p in prompts]
        return [f.result(timeout=self.result_timeout_s) for f in futures]

    def stats(self) -> dict:
        sc = self.scheduler.counters.snapshot()
        ec = self.counters.snapshot()
        ttft = self.ttft.summary()
        tokens = ec["tokens_generated"]
        busy = self._busy_s
        steps = ec["steps"]
        extra = {}
        if self.paged:
            extra = self.slots.block_stats()
            extra["blocks_held"] = {
                str(req.rid): self.slots.blocks_held(slot)
                for slot, req in list(self._by_slot.items())
            }
        return {
            "kv_backend": "paged" if self.paged else "slot",
            "device": str(self.device),
            "max_seq_len_effective": self.slots.max_seq_len,
            **extra,
            "queue_depth": self.scheduler.depth,
            "queue_capacity": self.scheduler.max_queue,
            "queue_saturated": self.scheduler.saturated,
            "active_slots": self.slots.active_count,
            "num_slots": self.slots.num_slots,
            "occupancy": round(self.slots.occupancy, 4),
            "steps": steps,
            "decode_steps": ec["decode_steps"],
            # process-wide count of the paged-decode kernel's launches: on
            # the card it equals num_layers x decode_steps of a paged engine
            # (0 for a slot engine) when no other caller launches the kernel
            "paged_decode_launches": flash_attention.paged_decode_attention.launches,
            "prefill_chunks": ec["prefill_chunks"],
            "prefill_tokens": ec["prefill_tokens"],
            "tokens_generated": tokens,
            "tokens_per_s": round(tokens / busy, 3) if busy > 0 else 0.0,
            "tokens_per_s_last_step": round(self._last_step_tps, 3),
            "ttft_p50_s": ttft["p50"],
            "ttft_p95_s": ttft["p95"],
            "ttft_p99_s": self.ttft.quantile(0.99),
            "ttft_hist": self.ttft_hist.snapshot(),
            "latency_hist": self.latency_hist.snapshot(),
            "decode_step_hist": self.decode_step_hist.snapshot(),
            "accepted_tokens_per_step": round(tokens / steps, 4) if steps else 0.0,
            "submitted": sc["submitted"],
            "admitted": sc["admitted"],
            "completed": sc["completed"],
            "failed": sc["failed"],
            "rejected_queue_full": sc["rejected_queue_full"],
            "expired": sc["expired"],
            "expired_decode": sc["expired_decode"],
            "cancelled": sc["cancelled"],
            "cancelled_disconnect": sc["cancelled_disconnect"],
            "shed": sc["shed"],
            "engine_restarts": ec["engine_restarts"],
            "draining": self._draining,
            "alive": self.alive,
        }

    @property
    def alive(self) -> bool:
        """False once the engine is closed or gave up restarting."""
        return not self._closed and not self.supervisor.gave_up

    @property
    def busy_retry_after_s(self) -> float:
        """Retry-After hint for admission backpressure."""
        ttl = self.scheduler.default_ttl_s
        return max(1.0, min(ttl if ttl else 5.0, 5.0))

    def step_once(self) -> None:
        """One scheduler+decode iteration, synchronously (tests and
        ``start_loop=False`` callers)."""
        with torch.inference_mode():
            self._admit()
            if self._by_slot:
                self._step()

    def begin_drain(self) -> None:
        """Close admission without blocking: queued requests are shed,
        in-flight slots keep decoding. Idempotent."""
        with self._cond:
            if self._draining:
                return
            self._draining = True
            self._cond.notify_all()
        self.scheduler.shed_all()

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful shutdown: shed the queue, let in-flight slots finish
        under a bounded deadline, stop the loop and close. Returns
        :meth:`audit`."""
        timeout_s = self.drain_timeout_s if timeout_s is None else float(timeout_s)
        self.begin_drain()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            # the allocator is the in-flight authority: a request mid-prefill
            # holds a slot before it reaches _by_slot
            if (self.slots.active_count == 0 and self.scheduler.empty()
                    and not self._working):
                break
            if not self._thread.is_alive():
                break
            time.sleep(0.01)
        self.close(join_timeout_s=max(2.0, timeout_s))
        return self.audit()

    def audit(self) -> dict:
        """Post-drain invariant check: every slot back on the free list, no
        request bookkeeping left, and on the paged backend every block FREE
        or CACHED."""
        a = self.slots.audit()
        leaked = (not a["ok"] or a["active"] != 0 or a["free"] != a["num_slots"]
                  or bool(self._by_slot))
        out = {
            "slots_ok": a["ok"],
            "active_slots": a["active"],
            "free_slots": a["free"],
            "num_slots": a["num_slots"],
            "tracked_requests": len(self._by_slot),
            "queue_depth": self.scheduler.depth,
        }
        if self.paged:
            out.update({k: a[k] for k in ("blocks_ok", "blocks_total", "blocks_free",
                                          "blocks_cached", "blocks_active")})
            leaked = leaked or not a["blocks_ok"] or a["blocks_active"] != 0
        out["leaked"] = bool(leaked)
        out["engine_restarts"] = self.counters.get("engine_restarts")
        return out

    def close(self, join_timeout_s: float = 30.0) -> None:
        self._closed = True
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread.is_alive() and threading.current_thread() is not self._thread:
            self._thread.join(timeout=join_timeout_s)
        self._fail_all(rz.EngineClosed("engine shut down"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- engine loop (one thread owns the cache, the slots and the forwards) --

    def _loop(self) -> None:
        with torch.inference_mode():
            while True:
                with self._cond:
                    while (not self._stop and self.scheduler.empty()
                           and not self._by_slot):
                        # short timeout: TTLs must expire even with no wakeups
                        self._cond.wait(timeout=0.05)
                    if self._stop:
                        break
                try:
                    self._working = True
                    try:
                        self._admit()
                        if self._by_slot:
                            self._step()
                    finally:
                        self._working = False
                except Exception as e:  # noqa: BLE001 — the engine must not die silently
                    # fail the in-flight work, keep queued requests with TTL
                    # budget, reset the cache and keep looping; give-up closes
                    try:
                        recovered = self.supervisor.on_crash(self, e)
                    except Exception as e2:  # noqa: BLE001 — recovery failed
                        self.supervisor.gave_up = True
                        recovered = False
                        e = e2
                    if not recovered:
                        self._closed = True
                        self._fail_all(rz.EngineClosed(
                            f"engine gave up after {self.supervisor.restarts_total} "
                            f"restart(s): {type(e).__name__}: {e}"
                        ))
                        break

    def _admit(self) -> None:
        """Admit queued requests into free slots (chunked prefill). On the
        paged backend admission also gates on BLOCK headroom: the head
        request stays queued until free + evictable blocks cover its
        worst-case footprint, so decode never allocates."""
        self.scheduler.expire()
        while self.slots.free_slots > 0:
            head = self.scheduler.peek()
            if head is None:
                return
            if self.paged and not (head.cancel_requested or head.future.cancelled()) \
                    and not self.slots.can_admit(head.tokens, head.max_new_tokens,
                                                 chunk=self.prefill_chunk):
                return
            req = self.scheduler.pop()
            if req is None:
                return
            if req.cancel_requested or req.future.cancelled():
                rz.advance(req, rz.CANCELLED, self.scheduler.counters,
                           reason=req.cancel_reason or "abandoned")
                if not req.future.done():
                    req.future.set_exception(rz.RequestCancelled(
                        f"request {req.rid} cancelled while queued "
                        f"({req.cancel_reason or 'abandoned'})"
                    ))
                continue
            try:
                self._prefill_impl(req)
            except Exception as e:  # noqa: BLE001 — fail the one request
                if req.slot is not None:
                    self._by_slot.pop(req.slot, None)
                    self._rng.pop(req.slot, None)
                    self.slots.free(req.slot)
                    req.slot = None
                if isinstance(e, rz.DeadlineExceeded):
                    rz.advance(req, rz.EXPIRED, self.scheduler.counters, where="prefill")
                else:
                    rz.advance(req, rz.FAILED, self.scheduler.counters,
                               reason=type(e).__name__)
                if not req.future.done():
                    req.future.set_exception(e)

    def _prefill_chunk(self, buf: np.ndarray, slot: int, start: int) -> torch.Tensor:
        """One (1, C) chunk at position ``start``: into the slot's rows of
        the contiguous cache, or through its table row in the pool. Tail
        padding writes garbage past the prompt that causal masking hides
        until a decode step overwrites it. Returns the (C, V) logits."""
        tokens = torch.from_numpy(buf.astype(np.int64)).to(self.device)
        if self.paged:
            table = torch.from_numpy(self.slots.tables[slot:slot + 1].copy()).to(self.device)
            offset = torch.tensor([start], dtype=torch.int32, device=self.device)
            logits, _ = generation.forward_with_cache_paged(
                self.params, tokens, self.cfg, self.slots.pool, table, offset
            )
        else:
            cache = self.slots.cache
            row = KVCache(cache.k[:, slot:slot + 1], cache.v[:, slot:slot + 1])
            logits, _ = generation.forward_with_cache(self.params, tokens, self.cfg, row, start)
        return logits[0]

    def _decode_step(self, tokens: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """One decode forward over ALL slots; inactive rows carry (0, 0), so
        their write lands at position 0 of their own free slot (overwritten
        by the next prefill before any query reads it) or, paged, in the
        null block through an all-null table row. Returns the (B, V)
        next-position logits on the host."""
        tok = torch.from_numpy(tokens.astype(np.int64)).to(self.device)[:, None]
        offs = torch.from_numpy(offsets.copy()).to(self.device)
        if self.paged:
            tables = torch.from_numpy(self.slots.tables.copy()).to(self.device)
            logits, _ = generation.forward_with_cache_paged(
                self.params, tok, self.cfg, self.slots.pool, tables, offs
            )
        else:
            logits, _ = generation.forward_with_cache_slots(
                self.params, tok, self.cfg, self.slots.cache, offs
            )
        self.counters.inc("decode_steps")
        return logits[:, 0].float().cpu().numpy()

    def _prefill_impl(self, req: Request) -> None:
        t0 = time.perf_counter()
        slot = self.slots.alloc()
        if slot is None:
            raise RuntimeError("admission found no free slot")
        req.slot = slot
        rz.advance(req, rz.PREFILLING, slot=slot)
        toks = np.asarray(req.tokens, np.int32)
        c = self.prefill_chunk
        smax = self.slots.max_seq_len
        matched = 0
        if self.paged:
            # attach the longest cached prefix read-only and reserve the
            # request's worst-case block footprint up front
            matched = self.slots.attach_prefix(slot, req.tokens)
            self.slots.reserve(slot, len(toks) + req.max_new_tokens)
        starts = list(range(matched, len(toks), c))
        if starts and starts[-1] + c > smax:
            # the fixed-size window must not cross the slot end: slide the
            # last window left (re-prefilling the overlap recomputes
            # identical k/v)
            starts[-1] = smax - c
        last_row = None
        for start in starts:
            if req.deadline is not None and time.time() > req.deadline:
                raise rz.DeadlineExceeded(
                    f"request {req.rid} deadline passed during prefill "
                    f"({start}/{len(toks)} tokens in)"
                )
            chunk = toks[start:start + c]
            n = len(chunk)
            buf = np.full((1, c), self.pad_id, np.int32)
            buf[0, :n] = chunk
            if self.paged:
                # the slid-left window may dip below the attached prefix:
                # COW any shared/registered block the write covers
                self.slots.ensure_writable(slot, start, min(start + c, smax))
            last_row = (self._prefill_chunk(buf, slot, start), n - 1)
            self.counters.inc("prefill_chunks")
            self.counters.inc("prefill_tokens", n)
        logits, idx = last_row
        self._last_logits[slot] = logits[idx].float().cpu().numpy()
        self.slots.lengths[slot] = len(toks)
        if self.paged:
            # publish the prompt's full blocks while the request decodes
            self.slots.register_prefix(slot, req.tokens)
        self._by_slot[slot] = req
        self._rng[slot] = np.random.default_rng((self.seed, req.rid))
        rz.advance(req, rz.DECODING, slot=slot)
        self._busy_s += time.perf_counter() - t0

    def _step(self) -> None:
        """One decode iteration: sample for every active slot from its last
        logits, retire eos/budget/cancelled/over-deadline rows, then ONE
        shared forward for the survivors."""
        t0 = time.perf_counter()
        tokens = np.zeros((self.slots.num_slots,), np.int32)
        offsets = np.zeros((self.slots.num_slots,), np.int32)
        sampled = 0
        appended = 0
        retired: List[int] = []
        cancelled: List[int] = []
        expired: List[int] = []
        for slot in self.slots.active_slots():
            req = self._by_slot[slot]
            now = time.time()
            if req.cancel_requested or req.future.cancelled():
                cancelled.append(slot)
                continue
            if req.deadline is not None and now > req.deadline:
                expired.append(slot)
                continue
            tok = _sample_host(self._rng[slot], self._last_logits[slot],
                               req.temperature, req.top_k, req.top_p)
            sampled += 1
            if req.first_token_at is None:
                req.first_token_at = now
                self.ttft.add(now - req.submitted_at)
                self.ttft_hist.observe(now - req.submitted_at)
            if self.eos_id >= 0 and tok == self.eos_id:
                req.finish_reason = "eos"
                retired.append(slot)
                continue
            req.generated.append(tok)
            appended += 1
            if len(req.generated) >= req.max_new_tokens:
                req.finish_reason = "length"
                retired.append(slot)
                continue
            tokens[slot] = tok
            offsets[slot] = self.slots.lengths[slot]
            self.slots.lengths[slot] += 1
        for slot in retired:
            self._retire(slot)
        for slot in cancelled:
            self._retire_cancelled(slot)
        for slot in expired:
            self._retire_deadline(slot)
        still = self.slots.active_slots()
        if still:
            if self.paged:
                for slot in still:
                    # a no-op today (decode writes past every shared block),
                    # kept as the cheap COW invariant the reference keeps
                    off = int(offsets[slot])
                    self.slots.ensure_writable(slot, off, off + 1)
            logits = self._decode_step(tokens, offsets)
            for slot in still:
                self._last_logits[slot] = logits[slot]
        self.counters.inc("steps")
        self.counters.inc("tokens_generated", appended)
        dt = time.perf_counter() - t0
        self._busy_s += dt
        if still:
            self.decode_step_hist.observe(dt)
        if dt > 0:
            self._last_step_tps = sampled / dt

    def _release_slot(self, slot: int) -> Request:
        req = self._by_slot.pop(slot)
        self._rng.pop(slot, None)
        self.slots.free(slot)
        return req

    def _retire(self, slot: int) -> None:
        req = self._release_slot(slot)
        self.latency_hist.observe(time.time() - req.submitted_at)
        rz.advance(req, rz.COMPLETED, self.scheduler.counters, reason=req.finish_reason)
        if not req.future.done():
            req.future.set_result(list(req.tokens) + req.generated)

    def _retire_cancelled(self, slot: int) -> None:
        req = self._release_slot(slot)
        reason = req.cancel_reason or "cancelled"
        rz.advance(req, rz.CANCELLED, self.scheduler.counters, reason=reason)
        if not req.future.done():
            req.future.set_exception(rz.RequestCancelled(
                f"request {req.rid} cancelled mid-decode ({reason})"
            ))

    def _retire_deadline(self, slot: int) -> None:
        """Over-deadline DECODING request: the slot frees either way;
        ``deadline_policy`` decides partial text or failure."""
        req = self._release_slot(slot)
        req.finish_reason = "deadline"
        rz.advance(req, rz.EXPIRED, self.scheduler.counters, where="decode")
        if req.future.done():
            return
        if self.deadline_policy == "partial":
            req.future.set_result(list(req.tokens) + req.generated)
        else:
            req.future.set_exception(rz.DeadlineExceeded(
                f"request {req.rid} exceeded its deadline after "
                f"{len(req.generated)}/{req.max_new_tokens} tokens"
            ))

    def _fail_all(self, exc: Exception) -> None:
        for slot in list(self._by_slot):
            req = self._release_slot(slot)
            rz.advance(req, rz.FAILED, self.scheduler.counters, reason=type(exc).__name__)
            if not req.future.done():
                req.future.set_exception(exc)
        self.slots.reset()
        self.scheduler.drain(exc)

    def _crash_cleanup(self, exc: BaseException,
                       retry_after_s: Optional[float] = None) -> None:
        """Crash recovery (called by the supervisor): fail the in-flight
        requests fast, reset the cache, keep queued requests that still have
        TTL budget."""
        wrapped = rz.EngineRestarted(
            f"engine restarted mid-request ({type(exc).__name__}: {exc}); "
            "please resubmit",
            retry_after_s=retry_after_s,
        )
        for slot in list(self._by_slot):
            req = self._release_slot(slot)
            rz.advance(req, rz.FAILED, self.scheduler.counters, reason="engine_crash")
            if not req.future.done():
                req.future.set_exception(wrapped)
        self.slots.reset()
        self._last_logits[:] = 0.0
        self.scheduler.expire()
