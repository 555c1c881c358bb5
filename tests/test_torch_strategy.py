"""The port's strategy codec (``galvatron_tpu_torch/core/strategy.py``, a copy
of the JAX package's stdlib-only module) against the JAX one: the checked-in
plans and the reference's searched-config schema load to the same objects,
JSON round-trips, validation, ``form_strategy``, ``balanced_division``,
``plan_hash`` and the zero2 / ddp distinction, case by case as
``tests/test_strategy.py`` drives them."""

import dataclasses
import json
from pathlib import Path

import pytest

from galvatron_tpu.core import strategy as js
from galvatron_tpu_torch.core import strategy as ts
import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PLANS = sorted((ROOT / "configs" / "strategies").glob("*.json"))

# the reference's searched-output schema (as tests/test_strategy.py carries it)
REF_SCHEMA = {
    "pp_deg": 4,
    "tp_sizes_enc": ",".join(["1"] * 20),
    "tp_consecutive_flags": ",".join(["1"] * 20),
    "dp_types_enc": ",".join(["0"] * 20),
    "checkpoint": ",".join(["0"] * 20),
    "global_bsz": 64,
    "chunks": 16,
    "pp_division": "5,5,5,5",
    "pipeline_type": "pipedream_flush",
    "default_dp_type": "zero2",
}


def _same(tcfg, jcfg):
    """Field by field: every layer strategy and every model-wide choice."""
    assert tcfg.to_json_dict() == jcfg.to_json_dict()
    assert [dataclasses.asdict(s) for s in tcfg.layer_strategies] == \
        [dataclasses.asdict(s) for s in jcfg.layer_strategies]
    for f in dataclasses.fields(jcfg):
        if f.name != "layer_strategies":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_plans_are_checked_in():
    assert [p.name for p in PLANS] == ["gpt-1.5b_16dev_24gb.json", "llama-0.3b_8dev_16gb.json",
                                       "llama-7b_8dev_32gb.json"]


@pytest.mark.parametrize("path", PLANS, ids=lambda p: p.stem)
def test_checked_in_plan_loads_to_the_jax_objects(path, tmp_path):
    tcfg, jcfg = ts.HybridParallelConfig.load(str(path)), js.HybridParallelConfig.load(str(path))
    _same(tcfg, jcfg)
    assert ts.plan_hash(tcfg) == js.plan_hash(jcfg)
    assert ts.plan_hash(json.loads(path.read_text())) == js.plan_hash(jcfg)
    out = tmp_path / "plan.json"
    tcfg.save(str(out))
    _same(ts.HybridParallelConfig.load(str(out)), jcfg)
    world = json.loads(path.read_text())["num_devices"]
    tcfg.validate(world)
    jcfg.validate(world)


def test_reference_searched_schema_loads_to_the_jax_objects():
    tcfg = ts.HybridParallelConfig.from_json_dict(REF_SCHEMA)
    _same(tcfg, js.HybridParallelConfig.from_json_dict(REF_SCHEMA))
    assert all(s.dp_type == "zero2" for s in tcfg.layer_strategies)
    assert tcfg.pp_division == [5, 5, 5, 5] and tcfg.chunks == 16
    tcfg.validate(8)


def _roundtrip_cases(m):
    strategies = [
        m.LayerStrategy(tp=1, dp_type="zero3", ckpt=True),
        m.LayerStrategy(tp=2, tp_consec=False, dp_type="ddp"),
        m.LayerStrategy(tp=4, dp_type="zero2", sp=True, tp_overlap=True),
        m.LayerStrategy(tp=2, cp=2),
        m.LayerStrategy(ckpt="selective", cp_impl="a2a"),
    ]
    return {
        "mixed": m.HybridParallelConfig(
            pp=2, layer_strategies=strategies[:4], chunks=4, pipeline_type="pipedream_flush",
            vocab_tp=2, default_dp_type="zero2", grad_overlap=True),
        "selective": m.HybridParallelConfig(pp=1, layer_strategies=strategies[4:] * 2,
                                            vocab_sp=True, embed_dp_type="zero3",
                                            mixed_precision="fp32", mlp_recompute="gate"),
        "zero2_vs_ddp": m.HybridParallelConfig(
            pp=1, layer_strategies=[m.LayerStrategy(dp_type="zero2"),
                                    m.LayerStrategy(dp_type="ddp")]),
        "uniform": m.HybridParallelConfig.uniform(6, tp=4, sp=True, dp_type="zero3", ckpt=2,
                                                  chunks=2, vocab_tp=2),
    }


@pytest.mark.parametrize("case", list(_roundtrip_cases(js)))
def test_json_roundtrip_matches_jax(case):
    tcfg, jcfg = _roundtrip_cases(ts)[case], _roundtrip_cases(js)[case]
    _same(tcfg, jcfg)
    back = ts.HybridParallelConfig.from_json_dict(tcfg.to_json_dict())
    _same(back, js.HybridParallelConfig.from_json_dict(jcfg.to_json_dict()))
    assert ts.plan_hash(tcfg) == js.plan_hash(jcfg)
    if case == "zero2_vs_ddp":
        assert [s.dp_type for s in back.layer_strategies] == ["zero2", "ddp"]


@pytest.mark.parametrize("kwargs", [
    dict(tp=3), dict(dp_type="zero9"), dict(cp=3), dict(ep=6), dict(cp=2, ep=2),
    dict(cp=2, ckpt="selective"), dict(cp_impl="x"), dict(ckpt="sometimes"),
])
def test_layer_strategy_validation_matches_jax(kwargs):
    for m in (js, ts):
        with pytest.raises(ValueError):
            m.LayerStrategy(**kwargs)


@pytest.mark.parametrize("ckpt,want", [(True, "full"), (1, "full"), (2, "selective"),
                                       (False, False), (0, False), ("none", False)])
def test_ckpt_normalisation_matches_jax(ckpt, want):
    assert ts.LayerStrategy(ckpt=ckpt).ckpt == js.LayerStrategy(ckpt=ckpt).ckpt == want


@pytest.mark.parametrize("world,plan", [
    (4, dict(pp=2, tp=4)), (8, dict(pp=2, tp=4)), (6, dict()), (8, dict(pp=3)),
    (8, dict(vocab_tp=16)), (8, dict(tp=8, ep=2)),
])
def test_validate_matches_jax(world, plan):
    outcomes = []
    for m in (js, ts):
        hp = m.HybridParallelConfig.uniform(4, **{k: v for k, v in plan.items() if k != "ep"})
        if "ep" in plan:
            hp.layer_strategies = [s.with_(ep=plan["ep"]) for s in hp.layer_strategies]
        try:
            hp.validate(world)
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("layers,pp", [(10, 4), (8, 4), (7, 2), (48, 5), (3, 3)])
def test_balanced_division_matches_jax(layers, pp):
    assert ts.balanced_division(layers, pp) == js.balanced_division(layers, pp)


@pytest.mark.parametrize("kwargs,pp,dp", [
    (dict(tp=2, dp_type="zero3", ckpt=True), 2, 2), (dict(tp=4, tp_consec=False), 1, 2),
    (dict(tp=2, ckpt="selective"), 1, 1), (dict(tp=2, sp=True, dp_type="zero2"), 1, 4),
    (dict(cp=2, cp_impl="a2a", tp_overlap=True), 1, 4),
])
def test_form_strategy_matches_jax(kwargs, pp, dp):
    assert ts.form_strategy(ts.LayerStrategy(**kwargs), pp, dp) == \
        js.form_strategy(js.LayerStrategy(**kwargs), pp, dp)
