"""The multi-layer-type search on the T5-class encoder-decoder: the port's
copy emits the JAX package's plans, and each plan trains in the port like
the JAX package (one 8-rank gloo world against the single-device AdamW
trajectory at fp32 on the CPU; the shared code: ``tests/_encdec_common.py``).

The searches are ``tests/test_encdec.py``'s, on 8 devices: the synthetic
encoder / decoder layer types at pp 1 (at most tp 4), pp 2 and pp 2 with a
ragged E = 3 / D = 5 model, the measure-free profile of E = 2 / D = 4 at
pp 4 (its encoder divides [0, 1, 1, 0]), and the coupled 1F1B, which the
search must emit under a budget that only it fits when recompute is off.
Both packages' searches read one profile (the JAX package's, through its
JSON schema). Each plan holds the first batch's eval loss within 3e-5, the
loss of one train step (the JAX tests train each searched plan one step)
within 5e-5 and the gathered parameters within 1e-4 of the JAX package's.
"""

import pytest

import _encdec_common as C
import _torch_threads  # noqa: F401

SEARCH_NAMES = ("search_pp1", "search_pp2", "search_pp2_ragged", "search_pp4", "search_1f1b")


def _jax_plans():
    from galvatron_tpu.search import cost_model as jcm
    from galvatron_tpu.search import search_engine as jse

    return C.searched_plans(jcm, jse, C.jax_profile)


def _port_profile(tmp):
    """The JAX profile of a shape as the port reads it: its JSONs, through
    the port's loader."""
    from galvatron_tpu.utils.config_utils import save_profiled_model as jsave
    from galvatron_tpu_torch.utils.config_utils import load_profiled_model

    def profile(shape):
        comp, mem = str(tmp / "c.json"), str(tmp / "m.json")
        jsave(C.jax_profile(shape), comp, mem)
        return load_profiled_model(comp, mem)

    return profile


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from galvatron_tpu_torch.core import strategy as ts

    d = tmp_path_factory.mktemp("torch_encdec_search")
    table = C.search_cases({name: ts.HybridParallelConfig.from_json_dict(hp.to_json_dict())
                            for name, hp in _jax_plans().items()})
    refs, results, ranks, _ = C.run_world(d, table, steps=1)  # the JAX tests' one step
    return table, refs, results, ranks


@pytest.mark.parametrize("name", SEARCH_NAMES)
def test_searched_plan_trains_like_the_jax_package(world, name):
    table, refs, results, ranks = world
    assert tuple(table) == SEARCH_NAMES
    C.check_trains_like_jax(table, refs, results, ranks, name)


def test_the_port_search_emits_the_jax_plans(tmp_path):
    """The port's search (``search/search_engine.py``) emits each plan the
    JAX package's does, field for field, and the plans have the shapes the
    JAX tests expect: one strategy a layer, the pp 2 plan's encoder pair and
    decoder pair each shared across stages, a 2·pp division [enc ‖ dec]
    for the ragged model, [0, 1, 1, 0] for the encoder at pp 4, and the
    coupled 1F1B under the budget."""
    from galvatron_tpu_torch.search import cost_model as tcm
    from galvatron_tpu_torch.search import search_engine as tse

    jplans = _jax_plans()
    tplans = C.searched_plans(tcm, tse, _port_profile(tmp_path))
    assert tuple(jplans) == tuple(tplans) == SEARCH_NAMES
    for name in SEARCH_NAMES:
        assert tplans[name].to_json_dict() == jplans[name].to_json_dict(), name
    assert len(tplans["search_pp1"].layer_strategies) == 4
    pp2 = tplans["search_pp2"]
    ls = pp2.layer_strategies
    assert pp2.pp == 2 and pp2.chunks % 2 == 0 and ls[0] == ls[1] and ls[2] == ls[3]
    div = tplans["search_pp2_ragged"].pp_division
    assert len(div) == 4 and sum(div[:2]) == 3 and sum(div[2:]) == 5
    assert tplans["search_pp4"].pp_division[:4] == [0, 1, 1, 0]
    assert tplans["search_1f1b"].pipeline_type == "pipedream_flush"


def test_coupled_1f1b_is_priced_against_gpipe(tmp_path):
    """tests/test_encdec.py's pricing on the port's search: at equal (pp,
    bsz, chunks) the coupled 1F1B predicts less activation memory than
    GPipe (a bounded input stash against act x chunks) at a higher or equal
    time, charges its fp32 cotangent buffers, and under the budget of its
    own footprint (recompute off) GPipe does not fit."""
    from galvatron_tpu_torch.search import cost_model as tcm
    from galvatron_tpu_torch.search import search_engine as tse

    costs = _port_profile(tmp_path)(C.SHAPE)

    def engine(budget, allow_ckpt=True):
        return tse.SearchEngine(costs, tcm.ProfiledHardware(), num_layers=4,
                                space=tse.SearchSpace(world_size=4, pp_choices=[2], max_tp=2,
                                                      allow_ckpt=allow_ckpt),
                                memory_budget_mb=budget, mixed_precision="fp32",
                                mem_unit_mb=0.0625)

    r_g = engine(2000.0).evaluate(2, 64, 64, "gpipe")
    r_f = engine(2000.0).evaluate(2, 64, 64, "pipedream_flush")
    assert r_f.config.pipeline_type == "pipedream_flush"
    assert r_f.memory_mb < r_g.memory_mb and r_f.cost_ms >= r_g.cost_ms
    r_f2 = engine(2000.0, allow_ckpt=False).evaluate(2, 64, 64, "pipedream_flush")
    assert "coupled_1f1b_overhead_mb" in r_f2.details
    tight = engine(r_f2.memory_mb * 1.05, allow_ckpt=False)
    assert tight.evaluate(2, 64, 64, "gpipe") is None
    assert tight.search([64], max_chunks=64).config.pipeline_type == "pipedream_flush"


def test_every_rank_of_the_world_exited_cleanly(world):
    ranks = world[3]
    assert all(r.returncode == 0 and not r.killed for r in ranks), C.world_failure(ranks)
