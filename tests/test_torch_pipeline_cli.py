"""Pipelines through ``cli train`` on gloo ranks (pp = 2 against pp = 1,
rank 0's records only) and a lost message raising within the world's
timeout; split from ``tests/test_torch_pipeline.py`` (whose helpers these
use) so that the suite's workers can share the two files."""

import os
import re
import sys
import time

import numpy as np

from test_torch_pipeline import CLI, LOSS_TOL, LOST, ROOT, _cli_world, _ts, _world_failure
import _torch_threads  # noqa: F401


def test_cli_train_pp2_matches_pp1_with_rank0_records_only(tmp_path):
    """``cli train --pp_deg 2 --pipeline_type pipedream_flush`` on two ranks,
    and the same plan through ``--galvatron_config_path``: rank 0 (stage 0,
    which computes no loss) writes the last stage's losses, equal to the
    pp = 1 run's within 5e-5."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.utils.metrics import read_metrics

    ref_path = tmp_path / "pp1.jsonl"
    assert cli.main(["train", *CLI, "--metrics_path", str(ref_path)]) == 0
    ref = [r["loss"] for r in read_metrics(str(ref_path)) if r["event"] == "train_iter"]
    flags, ranks = _cli_world(tmp_path, ["--pp_deg", "2", "--pipeline_type",
                                         "pipedream_flush"], "flags")
    assert "pp=2 pp_division=2,2 pipeline=pipedream_flush" in ranks[0].output
    assert "strategies=2-1-1 " in ranks[0].output
    ts = _ts()
    plan = tmp_path / "plan.json"
    ts.HybridParallelConfig.uniform(4, pp=2, chunks=4, mixed_precision="fp32",
                                    pipeline_type="pipedream_flush").save(str(plan))
    from_plan, _ = _cli_world(tmp_path, ["--galvatron_config_path", str(plan)], "plan")
    assert len(ref) == len(flags) == len(from_plan) == 3
    np.testing.assert_allclose(flags, ref, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(from_plan, ref, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_a_lost_message_raises_within_the_world_timeout():
    """Stage 0 loses every message it sends: a receive on either stage
    raises at the world's timeout (``--dist_timeout_s 5``) instead of
    hanging, the launcher ends the other rank, and no step completes."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    t0 = time.monotonic()
    ranks = launch_local([sys.executable, "-c", LOST, *CLI, "--pp_deg", "2",
                          "--dist_timeout_s", "5"], 2, timeout_s=120, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert time.monotonic() - t0 < 100
    failed = [r for r in ranks if not r.killed]
    assert failed and all(r.returncode not in (0, None) for r in failed), _world_failure(ranks)
    # the receive that timed out; its peer may fail first on the closed pair
    assert any(re.search(r"Timed out", r.output) for r in ranks), _world_failure(ranks)
    assert "iter 0" not in ranks[0].output
