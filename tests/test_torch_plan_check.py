"""The port's plan checker and ``cli search`` / ``cli check-plan`` against the
JAX package's, on the CPU.

- Every bad plan of ``tests/test_analysis.py``'s negative table, built once
  from each package's strategy and model modules, must give the same
  diagnostic codes in both checkers.
- The three commands of ``configs/strategies/README.md`` (``search
  --analytic_costs 1``) must emit the same JSON from the port's ``cli``
  (``--device cpu``: the CPU attention default, as the JAX package's CPU run
  resolves it) as from the JAX package's, and both must equal the
  checked-in file on every key the file has.
- ``cli check-plan configs/strategies/*.json --strict 1`` returns 0 in the
  port; emitted plans pass it; the embedded model shape is the same in both
  packages for every shared preset.
- The meta-device sharding pass (the port's twin of the JAX ``AbstractMesh``
  pass) finds the pieces that do not tile a fused projection.
"""

import json
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = sorted((ROOT / "configs" / "strategies").glob("*.json"))


def _pkg(name):
    import importlib

    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, st=mod("core.strategy"), mod=mod("models.modeling"),
        pc=mod("analysis.plan_check"), cli=mod("cli"),
    )


JAX, PORT = _pkg("galvatron_tpu"), _pkg("galvatron_tpu_torch")


def codes(diags):
    return sorted({d.code for d in diags})


def _cfg(m, **kw):
    return m.mod.ModelConfig(**dict(dict(num_layers=4, num_heads=8, hidden_size=64,
                                         vocab_size=1024, max_seq_len=64), **kw))


def _uniform_dict(m, **kw):
    return m.st.HybridParallelConfig.uniform(kw.pop("num_layers", 4), **kw).to_json_dict()


# tests/test_analysis.py's negative table, as functions of the package m:
# (check_plan kwargs, the expected code)
def _gta001(m):
    d = _uniform_dict(m)
    d["mlp_recompue"] = "policy"
    return dict(plan=d, model_config=_cfg(m), world_size=8), "GTA001"


def _gta002(m):
    d = _uniform_dict(m)
    d["tp_sizes_enc"] = "3,3,3,3"
    return dict(plan=d, world_size=8), "GTA002"


def _gta002_length(m):
    d = _uniform_dict(m)
    d["sp_flags"] = "1,0"
    return dict(plan=d, world_size=8), "GTA002"


def _gta003(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4), world_size=6), "GTA003"


def _gta004(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4, tp=16), world_size=8), "GTA004"


def _gta005(m):
    hp = m.st.HybridParallelConfig.uniform(4, pp=2, chunks=2)
    hp.pp_division = [3, 2]
    return dict(plan=hp, world_size=8), "GTA005"


def _gta006(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(6), model_config=_cfg(m),
                world_size=8), "GTA006"


def _gta007(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4, tp=4),
                model_config=_cfg(m, num_heads=6, hidden_size=96), world_size=8), "GTA007"


def _gta008(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4, vocab_tp=2),
                model_config=_cfg(m, vocab_size=1001), world_size=8), "GTA008"


def _gta009(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4, chunks=4), world_size=8,
                global_bsz=6), "GTA009"


def _gta009_dp(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4), world_size=8, global_bsz=4), "GTA009"


def _gta010(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4, tp=8, sp=True),
                model_config=_cfg(m, max_seq_len=100), world_size=8), "GTA010"


def _gta011(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(24, pp=2, vpp=2, chunks=3),
                world_size=8), "GTA011"


def _gta012(m):
    hp = m.st.HybridParallelConfig.uniform(4, pp=2, tp=2, sp=False, chunks=2,
                                           pipeline_type="pipedream_flush", vocab_tp=2)
    return dict(plan=hp, model_config=_cfg(m), world_size=8), "GTA012"


def _gta013(m):
    L = m.st.LayerStrategy
    hp = m.st.HybridParallelConfig(pp=2, layer_strategies=[L(tp=1)] * 2 + [L(tp=2)] * 2,
                                   chunks=2)
    return dict(plan=hp, world_size=8), "GTA013"


def _gta014(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4, ep=2), model_config=_cfg(m),
                world_size=8), "GTA014"


def _gta015(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(4), model_config=_cfg(m),
                world_size=8, global_bsz=8, memory_budget_mb=0.5), "GTA015"


def _gta015_recorded(m):
    d = _uniform_dict(m)
    d["memory_mb"] = 99999.0
    return dict(plan=d, world_size=8, memory_budget_mb=1024.0), "GTA015"


def _gta016(m):
    return dict(plan=m.st.HybridParallelConfig.uniform(2, tp=8),
                model_config=_cfg(m, num_layers=2, ffn_dim=100), world_size=8), "GTA016"


def _gta018(m):
    L = m.st.LayerStrategy
    hp = m.st.HybridParallelConfig(layer_strategies=[L(tp=2, tp_overlap=True),
                                                     L(tp=1, tp_overlap=True)])
    return dict(plan=hp, world_size=8), "GTA018"


CASES = [_gta001, _gta002, _gta002_length, _gta003, _gta004, _gta005, _gta006, _gta007,
         _gta008, _gta009, _gta009_dp, _gta010, _gta011, _gta012, _gta013, _gta014, _gta015,
         _gta015_recorded, _gta016, _gta018]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[1:])
def test_bad_plans_get_the_same_codes(case):
    (jkw, want), (tkw, _) = case(JAX), case(PORT)
    jd, td = JAX.pc.check_plan(**jkw), PORT.pc.check_plan(**tkw)
    assert codes(jd) == [want], JAX.pc.format_report(jd)
    assert codes(td) == codes(jd), PORT.pc.format_report(td)
    assert all(d.hint for d in td)


def test_the_meta_pass_finds_pieces_that_do_not_tile():
    """ffn 102 at tp 4: the fused [w1 | w3] halves (102 each) do not split
    over 4 ranks (the port's TP piece holds matching columns of both), an
    ERROR; w2's 102-row dim stays whole, the JAX pass's warning."""
    cfg = _cfg(PORT, num_layers=2, num_heads=4, ffn_dim=102)
    diags = PORT.pc.check_plan(PORT.st.HybridParallelConfig.uniform(2, tp=4),
                               model_config=cfg, world_size=8)
    assert codes(diags) == ["GTA016"]
    by_field = {d.field: d.severity for d in diags}
    assert by_field == {"mlp/w13": "error", "mlp/w2": "warn"}, PORT.pc.format_report(diags)


def test_clean_plan_checks_fast_without_a_device():
    cfg = PORT.mod.PRESETS["llama-7b"]
    hp = PORT.st.HybridParallelConfig.uniform(cfg.total_layers, pp=2, tp=2, sp=True, chunks=4,
                                              pipeline_type="pipedream_flush",
                                              dp_type="zero3")
    t0 = time.monotonic()
    diags = PORT.pc.check_plan(hp, model_config=cfg, world_size=8, global_bsz=8)
    assert diags == [] and time.monotonic() - t0 < 5.0


def test_decode_failures_and_file_provenance(tmp_path):
    d = _uniform_dict(PORT)
    d["checkpoint"] = 0
    diags = PORT.pc.check_plan(d, world_size=8)
    assert codes(diags) == ["GTA002"] and diags[0].field == "checkpoint"
    p = tmp_path / "plan.json"
    p.write_text("{not json")
    diags = PORT.pc.check_plan(str(p))
    assert codes(diags) == ["GTA002"] and diags[0].source == str(p)
    with pytest.raises(PORT.pc.PlanError, match="GTA004"):
        PORT.pc.ensure_valid(PORT.st.HybridParallelConfig.uniform(4, tp=16), world_size=8)


@pytest.mark.parametrize("name", sorted(set(JAX.mod.PRESETS) & set(PORT.mod.PRESETS)))
def test_model_shape_dict_equal_for_every_shared_preset(name):
    j = JAX.pc.model_shape_dict(JAX.mod.PRESETS[name])
    t = PORT.pc.model_shape_dict(PORT.mod.PRESETS[name])
    assert j == t
    assert PORT.pc.model_shape_dict(PORT.pc.apply_model_shape(PORT.mod.ModelConfig(), t)) == t


def test_check_plan_cli_passes_the_checked_in_configs(capsys):
    assert PORT.cli.main(["check-plan", *map(str, STRATEGIES), "--strict", "1"]) == 0
    assert capsys.readouterr().out.count("plan OK") == len(STRATEGIES)


def test_check_plan_cli_exit_codes(tmp_path, capsys):
    """Errors exit 1, clean 0, --strict gates warnings, the JSON's own keys
    supply model and world, an explicit --model_size wins over them."""
    gd = PORT.st.HybridParallelConfig.uniform(4, tp=2).to_json_dict()
    gd.update(model_size="llama-0.3b", num_devices=8)
    gp = tmp_path / "good.json"
    gp.write_text(json.dumps(gd))
    assert PORT.cli.main(["check-plan", str(gp)]) == 1
    assert "GTA006" in capsys.readouterr().out
    assert PORT.cli.main(["check-plan", str(gp), "--num_layers", "4"]) == 0
    gd["mlp_recompue"] = "x"
    gp.write_text(json.dumps(gd))
    assert PORT.cli.main(["check-plan", str(gp), "--num_layers", "4"]) == 0
    assert PORT.cli.main(["check-plan", str(gp), "--num_layers", "4", "--strict", "1"]) == 1
    assert PORT.cli.main(["check-plan"]) == 2


def test_emitted_plan_describes_itself(tmp_path):
    """A search with shape overrides emits a plan that check-plan validates
    with no flags; a plan the checker rejects is never written."""
    from galvatron_tpu_torch.search.cost_model import ProfiledHardware
    from galvatron_tpu_torch.search.search_engine import SearchEngine, SearchSpace
    from galvatron_tpu_torch.search.theoretical import analytic_model_costs

    cfg = _cfg(PORT)
    eng = SearchEngine(analytic_model_costs(cfg), ProfiledHardware(), num_layers=4,
                       space=SearchSpace(world_size=8), memory_budget_mb=4096.0,
                       model_config=cfg, model_name="llama-0.3b")
    results = eng.search_topk([4, 8], k=6, max_chunks=4)
    assert len(results) >= 3
    for i, r in enumerate(results):
        out = tmp_path / f"p{i}.json"
        eng.save_result(r, str(out))
        saved = json.loads(out.read_text())
        assert saved["model_config"]["num_layers"] == 4
        assert set(saved) <= PORT.pc.KNOWN_KEYS
        assert PORT.pc.check_plan(str(out)) == []
        assert PORT.cli.main(["check-plan", str(out), "--strict", "1"]) == 0


TRAIN_TINY = ["--model_size", "llama-0.3b", "--num_layers", "4", "--hidden_size", "64",
              "--num_heads", "4", "--ffn_dim", "128", "--vocab_size", "128", "--seq_length",
              "32", "--global_train_batch_size", "8", "--mixed_precision", "fp32",
              "--attn_impl", "xla", "--train_iters", "1"]


@pytest.mark.parametrize("how", ["strategy file", "global flags"])
def test_both_trainers_refuse_an_invalid_plan_before_building_a_model(how, tmp_path,
                                                                      monkeypatch):
    """The plan check at start-up (the JAX trainer's two call sites): a
    strategy file with 2 layers for a 4-layer model (GTA006), and GLOBAL
    flags whose chunks do not divide the batch (GTA009). Both trainers
    raise ``PlanError`` with the same codes, and neither builds a runtime."""
    from galvatron_tpu.core import arguments as jargs
    from galvatron_tpu.core import trainer as jtrainer
    from galvatron_tpu_torch.core import arguments as targs
    from galvatron_tpu_torch.core import trainer as ttrainer

    def built(*a, **k):
        raise AssertionError("a runtime was built before the plan check")

    monkeypatch.setattr(jtrainer, "build_runtime", built)
    monkeypatch.setattr(ttrainer, "build_runtime", built)
    if how == "strategy file":
        plan = tmp_path / "plan.json"
        plan.write_text(json.dumps(PORT.st.HybridParallelConfig.uniform(2).to_json_dict()))
        extra = ["--galvatron_config_path", str(plan)]
        want = "GTA006"
    else:
        extra, want = ["--chunks", "3"], "GTA009"
    with pytest.raises(JAX.pc.PlanError) as je:
        jtrainer.train(jargs.initialize_galvatron("train", TRAIN_TINY + extra), verbose=False)
    with pytest.raises(PORT.pc.PlanError) as te:
        ttrainer.train(targs.initialize_galvatron("train", TRAIN_TINY + extra + ["--device",
                                                                                 "cpu"]))
    assert want in codes(je.value.diagnostics)
    assert codes(te.value.diagnostics) == codes(je.value.diagnostics)
    assert str(te.value).startswith("refusing to start")
