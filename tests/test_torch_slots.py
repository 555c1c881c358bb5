"""The port's slot KV backend (``serving/kv_slots.py`` and the engine's slot
branches, the default ``kv_num_blocks=0``) against the JAX package at fp32
on the CPU: the allocator, greedy engine output equal to JAX
``generate_np`` token for token and to the paged engine's, shared decode
iterations, slot reuse, eos retirement, the oversized-request refusal, the
prefill window at a slot's end, crash recovery and a leak-free drain. The
cases of the reference's ``tests/test_serving.py`` (slot backend) and
``tests/test_paged_kv.py`` (slot against paged)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.models import generation as jgen
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.serving.kv_slots import SlotKVCache as JaxSlotKVCache
from galvatron_tpu_torch import bridge
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.serving import Engine, SlotKVCache
import _torch_threads  # noqa: F401

SHAPE = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             ffn_dim=128, max_seq_len=64)
JCFG = jm.ModelConfig(dtype=jnp.float32, **SHAPE)
TCFG = tm.ModelConfig(dtype=torch.float32, **SHAPE)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(0), JCFG))


@pytest.fixture(scope="module")
def tparams(jparams):
    return bridge.params_from_jax(jparams, TCFG, "cpu")


def _prompts(n, lo=3, hi=14, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, (rng.randint(lo, hi),)).tolist() for _ in range(n)]


def _engine(tparams, **kw):
    return Engine(tparams, TCFG, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------


def test_slot_alloc_free_reset_replays_the_reference():
    """The same alloc / free / reset sequence gives the reference's slots,
    lengths, views and audits; the cache is (L, slots, max_len, kv, hd) on
    the device and a reset leaves it as a fresh one (zeros)."""
    ts, js = SlotKVCache(TCFG, 3, "cpu", 32), JaxSlotKVCache(JCFG, 3, 32)
    assert tuple(ts.cache.k.shape) == tuple(js.cache.k.shape) == (2, 3, 32, 2, 16)
    for op in ("alloc", "alloc", "len7", "free0", "alloc", "alloc", "alloc", "alloc"):
        for c in (ts, js):
            if op == "len7":
                c.lengths[0] = 7
            elif op == "free0":
                c.free(0)
        if op == "alloc":
            assert ts.alloc() == js.alloc()
        np.testing.assert_array_equal(ts.lengths, js.lengths)
        assert (ts.free_slots, ts.active_count, ts.active_slots(), ts.occupancy, ts.audit()) \
            == (js.free_slots, js.active_count, js.active_slots(), js.occupancy, js.audit())
    for c in (ts, js):
        with pytest.raises(ValueError, match="not active"):
            c.free(5)
    ts.cache.k.fill_(1.0)
    ts.reset()
    js.reset()
    assert ts.free_slots == js.free_slots == 3 and ts.audit() == js.audit()
    assert not ts.cache.k.any() and ts.alloc() == js.alloc()
    for c in (ts, js):
        assert c.fits(10, 22) and not c.fits(10, 23) and not c.fits(0, 1)


def test_slot_refusals_and_clamp():
    with pytest.raises(ValueError, match="num_slots must be >= 1"):
        SlotKVCache(TCFG, 0, "cpu")
    with pytest.warns(RuntimeWarning, match="clamping"):
        assert SlotKVCache(TCFG, 2, "cpu", 10_000).max_seq_len == TCFG.max_seq_len


# ---------------------------------------------------------------------------
# the engine on the slot backend
# ---------------------------------------------------------------------------


def test_slot_engine_matches_generate_np_and_the_paged_engine(jparams, tparams):
    """Five requests through two slots (reuse) equal JAX ``generate_np``
    token for token, and the paged engine on the same prompts (the slot
    backend is a memory layout, not a model change)."""
    prompts = _prompts(5)
    ref = jgen.generate_np(jparams, JCFG, prompts, max_new_tokens=6)
    with _engine(tparams, num_slots=2, prefill_chunk=4) as eng:
        out = eng.generate(prompts, max_new_tokens=6)
        st = eng.stats()
        audit = eng.audit()
    assert out == ref
    assert st["kv_backend"] == "slot" and "kv_blocks_total" not in st
    assert st["completed"] == 5 and st["active_slots"] == 0 and st["num_slots"] == 2
    assert st["paged_decode_launches"] == 0
    assert not audit["leaked"] and "blocks_ok" not in audit, audit
    with _engine(tparams, num_slots=2, prefill_chunk=4, kv_num_blocks=-1,
                 kv_block_size=8) as eng:
        assert eng.generate(prompts, max_new_tokens=6) == out


def test_slot_and_paged_engines_agree_on_a_shared_prefix(tparams):
    """Two requests sharing a 24-token prefix (the paged engine attaches the
    first's blocks; the slot engine prefills both) give the same tokens."""
    rng = np.random.RandomState(3)
    base = rng.randint(1, 97, (24,)).tolist()
    prompts = _prompts(2, seed=4) + [base + [7], base + [11, 13]]
    outs = []
    for kw in (dict(), dict(kv_num_blocks=-1, kv_block_size=8)):
        with _engine(tparams, num_slots=2, prefill_chunk=8, **kw) as eng:
            outs.append(eng.generate(prompts, max_new_tokens=6))
    assert outs[0] == outs[1]


def test_slot_engine_shares_decode_iterations(tparams):
    """Four requests admitted together decode in lockstep: fewer iterations
    than generated tokens."""
    prompts = _prompts(4, lo=4, hi=8, seed=1)
    eng = _engine(tparams, num_slots=4, prefill_chunk=8, start_loop=False)
    futs = [eng.submit(p, 8) for p in prompts]
    steps = 0
    while not all(f.done() for f in futs):
        eng.step_once()
        steps += 1
        assert steps < 100
    total = sum(len(f.result(timeout=1)) - len(p) for f, p in zip(futs, prompts))
    assert total == 32 and steps < total and eng.stats()["steps"] == steps
    eng.close()


def test_slot_reuse_across_requests(jparams, tparams):
    """One slot serves three queued requests in FIFO order; the stale k/v
    of each retired request is never attended by the next."""
    prompts = _prompts(3, seed=2)
    eng = _engine(tparams, num_slots=1, prefill_chunk=8, start_loop=False)
    futs = [eng.submit(p, 3) for p in prompts]
    eng.step_once()
    assert eng._by_slot[0].tokens == prompts[0]
    for _ in range(40):
        if all(f.done() for f in futs):
            break
        eng.step_once()
    assert eng.stats()["completed"] == 3 and eng.slots.free_slots == 1
    assert [f.result(timeout=1) for f in futs] == jgen.generate_np(
        jparams, JCFG, prompts, max_new_tokens=3)
    eng.close()


def test_slot_eos_retires_row(jparams, tparams):
    p = _prompts(1, seed=5)[0]
    eos = jgen.generate_np(jparams, JCFG, [p], max_new_tokens=1)[0][-1]
    with _engine(tparams, num_slots=1, eos_id=eos) as eng:
        assert eng.generate([p], max_new_tokens=8)[0] == p  # eos first → empty completion


def test_slot_oversized_request_refused(tparams):
    with _engine(tparams, num_slots=1, max_seq_len=16) as eng:
        with pytest.raises(ValueError, match="slot capacity 16"):
            eng.submit(list(range(1, 10)), 8)  # 9 + 8 > 16
        assert len(eng.generate([[1, 2, 3]], max_new_tokens=2)[0]) == 5


def test_slot_prefill_window_at_slot_end(jparams, tparams):
    """Slot length 51, chunk 32: the 35-token prompt's second window [32, 64)
    would cross the slot's end and slides to [19, 51); the rewrite of the
    overlap is idempotent, so the output equals the reference."""
    prompts = [np.random.RandomState(9).randint(1, 97, (35,)).tolist(), [5, 6, 7]]
    ref = jgen.generate_np(jparams, JCFG, prompts, max_new_tokens=6)
    with _engine(tparams, num_slots=2, prefill_chunk=32, max_seq_len=51) as eng:
        assert eng.generate(prompts, max_new_tokens=6) == ref


def test_slot_engine_crash_recovers_and_drain_leaks_nothing(jparams, tparams):
    """A decode forward that raises fails the in-flight request, zeroes the
    cache and keeps serving; a drain then reports no leak."""
    from galvatron_tpu_torch.serving import EngineRestarted

    eng = _engine(tparams, num_slots=2, prefill_chunk=8, restart_backoff_s=0.0,
                  start_loop=False)
    real, left = eng._decode_step, [1]

    def step(*a):
        if left[0]:
            left[0] -= 1
            raise RuntimeError("injected decode failure")
        return real(*a)

    eng._decode_step = step
    first = eng.submit([5, 6, 7], 4)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step_once()
    assert eng.supervisor.on_crash(eng, RuntimeError("injected")) is True
    assert isinstance(first.exception(), EngineRestarted) and not eng.slots.cache.k.any()
    second = eng.submit([5, 6, 7], 4)
    while not second.done():
        eng.step_once()
    assert second.result() == jgen.generate_np(jparams, JCFG, [[5, 6, 7]], max_new_tokens=4)[0]
    drained = eng.drain(timeout_s=5.0)
    assert not drained["leaked"] and drained["free_slots"] == 2, drained
