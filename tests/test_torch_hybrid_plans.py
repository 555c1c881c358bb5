"""The checked-in ``llama-7b_8dev_32gb.json`` / ``llama-0.3b_8dev_16gb.json``
plans in the port against the JAX package, in an 8-rank gloo world of
their own (``tests/test_torch_hybrid.py`` holds the machinery, the
tolerances and the other plans; the two worlds run on different workers of
the suite): the 3-step losses within 2e-4 of the JAX single-device
trajectory, the gathered parameters within 1e-4, every rank's piece its cut
of the gathered tree bit for bit; the zero3 plan gathers its layers again
in the backward."""

import pytest

from test_torch_hybrid import PLANS, _check, _world_failure, run_world
import _torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("torch_hybrid_plans_world"), list(PLANS), False)


@pytest.mark.parametrize("name", list(PLANS))
def test_trains_like_the_jax_package(world, name):
    table, results, ranks = world
    assert name in results, _world_failure(ranks)
    _check(name, table, results)


def test_the_zero3_plan_gathers_its_layers_again_in_the_backward(world):
    _, results, ranks = world
    assert "llama-0.3b_8dev_16gb" in results, _world_failure(ranks)
    assert all(g["regathered"] > 0 for g in results["llama-0.3b_8dev_16gb"])


def test_every_rank_of_the_world_exited_cleanly(world):
    _, _, ranks = world
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)
