"""The PyTorch port's serving stack on the CPU against the JAX package:
greedy engine output equals JAX ``generate_np`` token for token at fp32 on
the paged backend (prefix sharing and the slide-left copy-on-write window
included) and the default slot backend, the block allocator replays the
reference's decisions op for op, drains leak nothing, and the HTTP server
and ``cli serve`` (slot, paged and the serialized ``--num_slots 0`` path)
answer end to end."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.models import generation as jgen
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.serving.paged_kv import PagedKVCache as JaxPagedKVCache
from galvatron_tpu_torch import bridge, cli
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.models.tokenizer import ByteTokenizer
from galvatron_tpu_torch.server import GenerationService, run_server
from galvatron_tpu_torch.serving import Engine
from galvatron_tpu_torch.serving.paged_kv import PagedKVCache
import _torch_threads  # noqa: F401

SHAPE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             ffn_dim=128, max_seq_len=64)
JCFG = jm.ModelConfig(dtype=jnp.float32, **SHAPE)
TCFG = tm.ModelConfig(dtype=torch.float32, **SHAPE)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(0), JCFG))


def _engine(jparams, cfg=TCFG, **kw):
    params = bridge.params_from_jax(jparams, cfg, "cpu")
    kw.setdefault("kv_num_blocks", -1)
    kw.setdefault("kv_block_size", 8)
    return Engine(params, cfg, device="cpu", **kw)


def test_engine_greedy_matches_generate_np(jparams):
    """Three prompts, two sharing a 24-token prefix: the second attaches the
    first's registered blocks instead of re-prefilling them."""
    rng = np.random.RandomState(3)
    base = rng.randint(1, 97, (24,)).tolist()
    prompts = [rng.randint(1, 97, (9,)).tolist(), base + [7], base + [11, 13]]
    ref = jgen.generate_np(jparams, JCFG, prompts, max_new_tokens=6)
    with _engine(jparams, num_slots=2, prefill_chunk=8) as eng:
        out = eng.generate(prompts, max_new_tokens=6)
        st = eng.stats()
        audit = eng.audit()
    assert out == ref
    assert st["kv_backend"] == "paged"
    assert st["prefix_cache_hits"] >= 3  # 24 shared tokens = 3 full blocks
    assert st["decode_steps"] > 0 and st["paged_decode_launches"] == 0  # CPU: plain version
    assert not audit["leaked"] and audit["blocks_active"] == 0, audit


def test_engine_parity_through_slide_left_cow(jparams):
    """A near-capacity prompt whose last prefill window slides left into the
    shared prefix: the window's blocks are copied first (cow_copies) and the
    output still equals the reference."""
    rng = np.random.RandomState(5)
    base = rng.randint(1, 97, (56,)).tolist()  # 7 full blocks
    prompts = [base + [7], base + [11]]
    ref = jgen.generate_np(jparams, JCFG, prompts, max_new_tokens=4)
    with _engine(jparams, num_slots=2, prefill_chunk=16) as eng:
        out = eng.generate(prompts, max_new_tokens=4)
        st = eng.stats()
        audit = eng.audit()
    assert out == ref
    assert st["prefix_cache_hits"] >= 7
    assert st["cow_copies"] >= 1, st
    assert not audit["leaked"], audit


def test_drain_leaves_no_block_behind(jparams):
    eng = _engine(jparams, num_slots=2, prefill_chunk=8)
    futs = [eng.submit(list(range(1, 20)), 5), eng.submit(list(range(3, 11)), 3)]
    for f in futs:
        f.result(timeout=60)
    live = eng.audit()
    assert not live["leaked"] and live["blocks_cached"] > 0, live  # prompts stay cached
    drained = eng.drain(timeout_s=5.0)
    assert not drained["leaked"], drained
    with pytest.raises(Exception, match="draining|closed"):
        eng.submit([1, 2, 3], 2)


def test_slot_backend_is_not_ported(jparams):
    """``kv_num_blocks=0``, the default, is the contiguous slot backend:
    greedy output equal to JAX ``generate_np`` and no paged-decode launch
    (its one-query attention is plain PyTorch on every device)."""
    prompts = [[5, 6, 7], list(range(1, 20)), [9] * 11]
    ref = jgen.generate_np(jparams, JCFG, prompts, max_new_tokens=5)
    params = bridge.params_from_jax(jparams, TCFG, "cpu")
    with Engine(params, TCFG, device="cpu", num_slots=2, prefill_chunk=8) as eng:
        assert eng.generate(prompts, max_new_tokens=5) == ref
        st = eng.stats()
    assert st["kv_backend"] == "slot" and st["paged_decode_launches"] == 0


def test_block_allocator_replays_the_reference(jparams):
    """The host allocator is the reference's: the same random sequence of
    alloc / attach+reserve+register / append / fork / free gives the same
    tables, lengths, refcounts, counters and audits, and COW copies move
    the same pool contents."""
    cfg_j = JCFG.replace(num_layers=1)
    cfg_t = TCFG.replace(num_layers=1)
    jc = JaxPagedKVCache(cfg_j, 3, block_size=4, num_blocks=14, max_seq_len=24)
    tc = PagedKVCache(cfg_t, 3, "cpu", block_size=4, num_blocks=14, max_seq_len=24)
    rng = np.random.RandomState(11)
    init = rng.randn(*tc.pool.k.shape).astype(np.float32)
    tc.pool.k.copy_(torch.from_numpy(init))
    tc.pool.v.copy_(torch.from_numpy(-init))
    jc.pool = jgen.KVCache(jnp.asarray(init), jnp.asarray(-init))
    shared = rng.randint(1, 97, (12,)).tolist()
    for step in range(120):
        active = tc.active_slots()
        assert active == jc.active_slots()
        op = rng.randint(4)
        if op == 0 and tc.free_slots:
            toks = shared[: rng.randint(4, 13)] + rng.randint(1, 97, (rng.randint(0, 4),)).tolist()
            if not tc.can_admit(toks, 2):
                assert not jc.can_admit(toks, 2)
                continue
            s = tc.alloc()
            assert jc.alloc() == s
            assert tc.attach_prefix(s, toks) == jc.attach_prefix(s, toks)
            tc.reserve(s, len(toks))
            jc.reserve(s, len(toks))
            tc.lengths[s] = jc.lengths[s] = len(toks)
            assert tc.register_prefix(s, toks) == jc.register_prefix(s, toks)
        elif op == 1 and active:
            s = active[rng.randint(len(active))]
            st = tc.block_stats()
            if tc.lengths[s] < tc.max_seq_len and st["kv_blocks_free"] + st["kv_blocks_cached"] >= 2:
                tc.append(s)
                jc.append(s)
        elif op == 2 and active and tc.free_slots:
            s = active[rng.randint(len(active))]
            assert tc.fork(s) == jc.fork(s)
        elif op == 3 and active:
            s = active[rng.randint(len(active))]
            tc.free(s)
            jc.free(s)
        np.testing.assert_array_equal(tc.tables, jc.tables, err_msg=f"step {step}")
        np.testing.assert_array_equal(tc.lengths, jc.lengths)
        np.testing.assert_array_equal(tc._refcount, jc._refcount)
        assert tc.block_stats() == jc.block_stats()
        assert tc.audit() == jc.audit()
    np.testing.assert_array_equal(tc.pool.k.numpy(), np.asarray(jc.pool.k))
    assert tc.cow_copies > 0 and tc.prefix_hits > 0


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def _http(url, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip_matches_generate_np():
    """POST /api on an ephemeral port returns the reference's greedy tokens;
    /readyz and /healthz answer; POST /drain reports no leak and stops the
    server."""
    tok = ByteTokenizer()
    shape = dict(SHAPE, vocab_size=tok.vocab_size)
    jcfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    tcfg = tm.ModelConfig(dtype=torch.float32, **shape)
    jp = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(1), jcfg))
    prompts = ["hello paged world", "hello paged"]
    ref = jgen.generate_np(jp, jcfg, [tok.encode(p) for p in prompts], max_new_tokens=8,
                           eos_id=tok.eos_id, pad_id=tok.pad_id)
    eng = _engine(jp, tcfg, num_slots=2, prefill_chunk=8, eos_id=tok.eos_id,
                  pad_id=tok.pad_id)
    service = GenerationService(tcfg, tok, eng)
    ready = threading.Event()
    th = threading.Thread(target=run_server, args=(service,),
                          kwargs=dict(port=0, ready_event=ready), daemon=True)
    th.start()
    assert ready.wait(10)
    base = f"http://127.0.0.1:{service.httpd.server_address[1]}"
    assert _http(base + "/readyz") == (200, {"ready": True})
    code, resp = _http(base + "/api", {"prompts": prompts, "tokens_to_generate": 8})
    assert code == 200, resp
    assert resp["tokens"] == ref
    code, health = _http(base + "/healthz")
    assert code == 200 and health["serving"]["completed"] == 2
    code, drained = _http(base + "/drain", {})
    assert code == 200 and drained["leaked"] is False, drained
    th.join(10)
    assert not th.is_alive()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_cli_serve(flags):
    """``cli serve`` on a free port in a thread; returns (base URL, thread,
    the list its return code lands in) once /readyz is 200."""
    port = _free_port()
    rc = []
    argv = ["serve", *flags, "--port", str(port)]
    th = threading.Thread(target=lambda: rc.append(cli.main(argv)), daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 60
    while True:
        try:
            if _http(base + "/readyz")[0] == 200:
                break
        except OSError:
            pass
        assert time.time() < deadline, "server never became ready"
        time.sleep(0.1)
    return base, th, rc


TINY_FLAGS = ["--device", "cpu", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "2",
              "--ffn_dim", "64", "--seq_length", "64"]


def _tiny_seed0_params():
    """The weights ``cli serve`` draws without ``--load`` at TINY_FLAGS
    (seed 0, the preset's bf16 and vocabulary)."""
    tok = ByteTokenizer()
    cfg = tm.PRESETS["llama-0.3b"].replace(num_layers=1, hidden_size=32, num_heads=2,
                                           ffn_dim=64, max_seq_len=64)
    return tok, cfg, tm.cast_params(tm.init_model_params(cfg, 0, "cpu"), cfg)


@pytest.mark.parametrize("backend", [[], ["--num_slots", "0"]], ids=["slot", "serialized"])
def test_cli_serve_default_and_serialized_match_generate_np(backend):
    """``cli serve --device cpu`` at the default ``--kv_num_blocks 0`` (the
    slot engine) and at ``--num_slots 0`` (``generate_np`` under the global
    lock, no engine): /api returns the greedy tokens of ``generate_np`` on
    the same weights; /healthz shows the slot engine or the pending-work
    gate; /drain reports no leak and main returns 0."""
    from galvatron_tpu_torch.models import generation as tgen

    base, th, rc = _start_cli_serve(TINY_FLAGS + ["--prefill_chunk", "8", *backend])
    tok, cfg, params = _tiny_seed0_params()
    prompts = ["hello slots", "a second, longer prompt"]
    code, resp = _http(base + "/api", {"prompts": prompts, "tokens_to_generate": 6})
    assert code == 200, resp
    assert resp["tokens"] == tgen.generate_np(params, cfg, [tok.encode(p) for p in prompts],
                                              max_new_tokens=6, eos_id=tok.eos_id,
                                              pad_id=tok.pad_id)
    code, health = _http(base + "/healthz")
    if backend:
        assert "serving" not in health and health["gate"]["in_use"] == 0, health
    else:
        assert health["serving"]["kv_backend"] == "slot", health
    code, drained = _http(base + "/drain", {})
    assert code == 200 and drained["leaked"] is False, drained
    th.join(15)
    assert rc == [0]


def test_serialized_path_gates_pending_work():
    """``engine=None``: with one pending request allowed, a second request
    arriving while the first waits on the generation lock gets 503."""
    tok, cfg, params = _tiny_seed0_params()
    service = GenerationService(cfg, tok, None, device="cpu", params=params)
    ready = threading.Event()
    th = threading.Thread(target=run_server, args=(service,),
                          kwargs=dict(port=0, ready_event=ready, max_pending=1), daemon=True)
    th.start()
    assert ready.wait(10)
    base = f"http://127.0.0.1:{service.httpd.server_address[1]}"
    body = {"prompts": ["x"], "tokens_to_generate": 2}
    first = []
    with service.lock:  # the first request parks on the generation lock
        t = threading.Thread(target=lambda: first.append(_http(base + "/api", body)))
        t.start()
        while service.gate.snapshot()["in_use"] == 0:
            time.sleep(0.01)
        code, resp = _http(base + "/api", body)
        assert code == 503 and "too many pending" in resp["error"], resp
    t.join(30)
    assert first[0][0] == 200 and service.gate.snapshot()["rejected"] == 1
    code, drained = _http(base + "/drain", {})
    assert code == 200 and drained["leaked"] is False
    th.join(10)


def test_cli_serve_on_cpu_end_to_end():
    """``cli serve --device cpu`` at a tiny bf16 size: /readyz turns 200
    after the warm-up, concurrent requests get their full token budgets,
    /drain exits cleanly and main returns 0."""
    base, th, rc = _start_cli_serve(TINY_FLAGS + [
        "--kv_num_blocks", "-1", "--kv_block_size", "8", "--prefill_chunk", "8",
        "--num_slots", "2"])
    outs = [None] * 3

    def post(i):
        outs[i] = _http(base + "/api", {"prompts": ["x" * (5 + 9 * i)], "tokens_to_generate": 6})

    posters = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for p in posters:
        p.start()
    for p in posters:
        p.join(60)
    for i, (code, resp) in enumerate(outs):
        assert code == 200, resp
        assert len(resp["tokens"][0]) <= 1 + 5 + 9 * i + 6
    code, drained = _http(base + "/drain", {})
    assert code == 200 and drained["leaked"] is False
    th.join(15)
    assert rc == [0]


# ---------------------------------------------------------------------------
# lifecycle, crash supervision, deadlines
# ---------------------------------------------------------------------------


def test_scheduler_lifecycle_and_backpressure():
    from galvatron_tpu_torch.serving import QueueFull, Request, RequestExpired, Scheduler
    from galvatron_tpu_torch.serving import resilience as rz

    sched = Scheduler(max_queue=2, default_ttl_s=10.0)
    a, b = Request(tokens=[1], max_new_tokens=1), Request(tokens=[2], max_new_tokens=1)
    sched.submit(a)
    sched.submit(b, ttl_s=0.0)
    with pytest.raises(QueueFull):
        sched.submit(Request(tokens=[3], max_new_tokens=1))
    dropped = sched.expire(now=b.submitted_at + 1.0)
    assert dropped == [b] and isinstance(b.future.exception(), RequestExpired)
    assert sched.pop() is a and sched.empty()
    rz.advance(a, rz.PREFILLING)
    with pytest.raises(rz.IllegalTransition):
        rz.advance(a, rz.COMPLETED)
    snap = sched.counters.snapshot()
    assert (snap["submitted"], snap["rejected_queue_full"], snap["expired"],
            snap["admitted"]) == (2, 1, 1, 1)


def _crashing(eng, times):
    """Make the next ``times`` decode forwards raise."""
    real = eng._decode_step
    left = [times]

    def step(*a):
        if left[0] > 0:
            left[0] -= 1
            raise RuntimeError("injected decode failure")
        return real(*a)

    eng._decode_step = step


def test_engine_crash_fails_in_flight_and_keeps_serving(jparams):
    from galvatron_tpu_torch.serving import EngineRestarted

    eng = _engine(jparams, num_slots=2, prefill_chunk=8, restart_backoff_s=0.0,
                  start_loop=False)
    _crashing(eng, 1)
    first = eng.submit([5, 6, 7], 4)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step_once()  # admits, then the decode forward raises
    # what the loop thread does with the exception
    assert eng.supervisor.on_crash(eng, RuntimeError("injected")) is True
    assert isinstance(first.exception(), EngineRestarted)
    second = eng.submit([5, 6, 7], 4)
    while not second.done():
        eng.step_once()
    assert len(second.result()) == 7
    assert eng.stats()["engine_restarts"] == 1
    assert not eng.audit()["leaked"]


def test_engine_loop_gives_up_after_its_restart_budget(jparams):
    from galvatron_tpu_torch.serving import EngineClosed, EngineRestarted

    eng = _engine(jparams, num_slots=1, prefill_chunk=8, max_engine_restarts=0)
    _crashing(eng, 10)
    fut = eng.submit([1, 2, 3], 3)
    with pytest.raises((EngineRestarted, EngineClosed)):
        fut.result(timeout=30)
    eng._thread.join(10)
    assert not eng.alive and eng.supervisor.gave_up
    with pytest.raises(EngineClosed):
        eng.submit([1, 2], 2)


@pytest.mark.parametrize("policy", ["partial", "fail"])
def test_deadline_stops_a_decoding_request(jparams, policy):
    from galvatron_tpu_torch.serving import DeadlineExceeded

    eng = _engine(jparams, num_slots=1, prefill_chunk=8, deadline_policy=policy,
                  start_loop=False)
    req = eng.submit_request([1, 2, 3], 20, ttl_s=30.0)
    eng.step_once()
    eng.step_once()
    req.deadline = time.time() - 1.0  # the client's deadline passes mid-decode
    eng.step_once()
    if policy == "partial":
        out = req.future.result(timeout=1)
        assert req.finish_reason == "deadline" and 3 < len(out) < 23
    else:
        assert isinstance(req.future.exception(timeout=1), DeadlineExceeded)
    assert eng.stats()["expired_decode"] == 1 and not eng.audit()["leaked"]
