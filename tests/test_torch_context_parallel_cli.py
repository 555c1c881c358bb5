"""Context parallelism through ``cli train`` (the GLOBAL flags) and a
``cli search --enable_cp 1`` plan trained in a gloo world against the JAX
package's CLI; split from ``tests/test_torch_context_parallel.py`` (whose
helpers these use) so that the suite's workers can share the two files."""

import json

import numpy as np

from test_torch_context_parallel import LOSS_TOL, STEPS, TINY, _cli_losses
import _torch_threads  # noqa: F401


def test_cli_train_context_parallel_flags(tmp_path):
    """``--context_parallel_deg 2 --context_parallel_impl a2a`` on 4 ranks
    (cp 2 x dp 2) trains the losses of the same flags at world size 1."""
    argv = TINY + ["--seq_length", "32"]
    ref = _cli_losses(argv, 1, tmp_path, "w1")
    got = _cli_losses(argv + ["--context_parallel_deg", "2", "--context_parallel_impl", "a2a"],
                      4, tmp_path, "cp2")
    assert len(got) == STEPS
    np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_cli_search_cp_plan_trains(tmp_path):
    """``cli search --enable_cp 1`` picks cp 4 for a tiny model at s 1024
    under a 50 MB budget; ``cli train --galvatron_config_path`` trains that
    plan on 4 ranks to the losses of world size 1."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    seq = ["--seq_length", "1024"]
    plan = str(tmp_path / "plan.json")
    assert cli.main(["search", *TINY[:12], *seq, "--num_devices", "4", "--analytic_costs", "1",
                     "--memory_constraint_gb", "0.05", "--settle_bsz", "8", "--search_space",
                     "dp", "--enable_cp", "1", "--mixed_precision", "fp32", "--device", "cpu",
                     "--output_config_path", plan]) == 0
    hp = HybridParallelConfig.load(plan)
    assert any(s.cp > 1 for s in hp.layer_strategies), json.dumps(hp.to_json_dict())
    ref = _cli_losses(TINY + seq + ["--chunks", str(hp.chunks)], 1, tmp_path, "w1")
    got = _cli_losses(TINY + seq + ["--galvatron_config_path", plan], 4, tmp_path, "plan")
    np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=LOSS_TOL)
