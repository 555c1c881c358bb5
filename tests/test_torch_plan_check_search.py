"""``cli search`` of the checked-in plans' README commands in both packages
(analytic costs): the same plan JSON, the checked-in one, and ``cli
check-plan --strict 1`` passes it. Split from
``tests/test_torch_plan_check.py`` (whose package handles it uses) so that
the suite's workers can share the three full searches and the rest."""

import json

import pytest

from test_torch_plan_check import JAX, PORT, ROOT
import _torch_threads  # noqa: F401


README_COMMANDS = {
    "llama-0.3b_8dev_16gb": ["--model_size", "llama-0.3b", "--num_devices", "8",
                             "--settle_bsz", "64", "--memory_constraint_gb", "16"],
    "gpt-1.5b_16dev_24gb": ["--model_size", "gpt-1.5b", "--num_devices", "16",
                            "--settle_bsz", "32", "--memory_constraint_gb", "24"],
    "llama-7b_8dev_32gb": ["--model_size", "llama-7b", "--num_devices", "8",
                           "--settle_bsz", "16", "--memory_constraint_gb", "32"],
}


@pytest.mark.parametrize("name", sorted(README_COMMANDS))
def test_checked_in_configs_are_searched_alike(name, tmp_path, capsys):
    argv = ["search", *README_COMMANDS[name], "--analytic_costs", "1"]
    jp, tp = tmp_path / "jax.json", tmp_path / "port.json"
    assert JAX.cli.main(argv + ["--output_config_path", str(jp)]) == 0
    assert PORT.cli.main(argv + ["--device", "cpu", "--output_config_path", str(tp)]) == 0
    assert "dp route: native" in capsys.readouterr().out
    j, t = json.loads(jp.read_text()), json.loads(tp.read_text())
    assert t == j
    checked_in = json.loads((ROOT / "configs" / "strategies" / f"{name}.json").read_text())
    assert {k: t[k] for k in checked_in} == checked_in
    assert PORT.cli.main(["check-plan", str(tp), "--strict", "1"]) == 0
