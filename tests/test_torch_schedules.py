"""The port's batch-size ramp-up and loss-scaler schedules against the JAX
package's (``tests/test_schedules.py``'s cases), the scaled value-and-grad
pattern, and the trainer's ramp-up integration: the same batch sizes and
consumed samples as the JAX trainer, and a resumed ramp-up run continuing
the sizes an uninterrupted one takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.core import schedules as js
from galvatron_tpu_torch.core import schedules as ts
import _torch_threads  # noqa: F401

RAMPS = [(8, 8, 64, 32), (4, 4, 32, 16), (2, 2, 0, 8), (16, 8, 100, 16), (1, 3, 10, 10)]


@pytest.mark.parametrize("start,inc,samples,target", RAMPS)
def test_rampup_sizes_match_jax(start, inc, samples, target):
    jr = js.BatchSizeRampup(start=start, increment=inc, rampup_samples=samples, target=target)
    tr = ts.BatchSizeRampup(start=start, increment=inc, rampup_samples=samples, target=target)
    assert tr.sizes() == jr.sizes()
    for consumed in list(range(0, 2 * samples + 3)) + [10_000]:
        assert tr(consumed) == jr(consumed), consumed


def test_rampup_reference_points_and_refusals():
    r = ts.BatchSizeRampup(start=8, increment=8, rampup_samples=64, target=32)
    assert [r(0), r(22), r(43), r(64), r(10_000)] == [8, 16, 24, 32, 32]
    assert r.sizes() == [8, 16, 24, 32]
    for bad in (dict(start=8, increment=5, rampup_samples=64, target=32),
                dict(start=0, increment=8, rampup_samples=64, target=32),
                dict(start=40, increment=8, rampup_samples=64, target=32)):
        with pytest.raises(ValueError):
            js.BatchSizeRampup(**bad)
        with pytest.raises(ValueError):
            ts.BatchSizeRampup(**bad)


def test_loss_scaler_growth_and_backoff_match_jax():
    jc = js.LossScalerConfig(initial_scale=16.0, growth_interval=2, min_scale=1.0)
    tc = ts.LossScalerConfig(initial_scale=16.0, growth_interval=2, min_scale=1.0)
    jst, tst = js.init_scaler_state(jc), ts.init_scaler_state(tc)
    want = [(16.0, 1), (32.0, 0), (16.0, 0)]
    for finite, (scale, good) in zip((True, True, False), want):
        jst = js.scaler_update(jst, jnp.asarray(finite), jc)
        tst = ts.scaler_update(tst, torch.tensor(finite), tc)
        assert (float(tst["scale"]), int(tst["good_steps"])) == (scale, good)
        assert (float(jst["scale"]), int(jst["good_steps"])) == (scale, good)
    # the floor: backoff never goes below min_scale
    tst = {"scale": torch.tensor(1.5), "good_steps": torch.tensor(0, dtype=torch.int32)}
    assert float(ts.scaler_update(tst, False, tc)["scale"]) == 1.0
    assert ts.LossScalerConfig() == ts.LossScalerConfig(2.0 ** 16, 2.0, 0.5, 1000, 1.0)


def test_scaled_value_and_grad_and_all_finite():
    def loss_fn(p, b):
        return torch.sum(p[0] * b)

    run = ts.scaled_value_and_grad(loss_fn, torch.tensor(4.0))
    w = torch.ones(2, requires_grad=True)
    loss, grads = run([w], torch.ones(2))
    np.testing.assert_allclose(grads[0].numpy(), [1.0, 1.0], rtol=1e-6)  # unscaled
    assert float(loss) == pytest.approx(2.0) and grads[0].dtype == torch.float32
    _, grads2 = run([w], torch.tensor([float("inf"), 1.0]))
    assert not bool(ts.all_finite(grads2))
    assert not bool(ts.all_finite([torch.tensor([float("nan")])]))
    assert bool(ts.all_finite([torch.ones(3), torch.zeros(())]))


TINY = ["--model_size", "llama-0.3b", "--num_layers", "2", "--hidden_size", "64",
        "--num_heads", "4", "--vocab_size", "128", "--seq_length", "16",
        "--global_train_batch_size", "16", "--rampup_batch_size", "8", "8", "16",
        "--lr_warmup_iters", "10", "--lr_decay_iters", "20", "--check_loss", "1",
        "--mixed_precision", "fp32", "--attn_impl", "xla"]


def test_trainer_rampup_gives_the_jax_sizes_and_consumed_samples(tmp_path):
    """``tests/test_schedules.py``'s trainer integration, held to the JAX
    trainer: the same batch size per iteration (from its ``train_iter``
    records) and the same consumed samples; a run saved mid-ramp and
    resumed continues with the sizes the uninterrupted run took."""
    from galvatron_tpu.core.arguments import initialize_galvatron as j_init
    from galvatron_tpu.core.trainer import train as j_train
    from galvatron_tpu.utils.metrics import read_metrics as j_read
    from galvatron_tpu_torch.core.arguments import initialize_galvatron as t_init
    from galvatron_tpu_torch.core.trainer import train as t_train

    jpath = str(tmp_path / "j.jsonl")
    jout = j_train(j_init("train", TINY + ["--train_iters", "6", "--metrics_path", jpath]),
                   verbose=False)
    jsizes = [r["batch_size"] for r in j_read(jpath) if r["event"] == "train_iter"]
    out = t_train(t_init("train", TINY + ["--train_iters", "6", "--device", "cpu"]))
    assert out["batch_sizes"] == jsizes == [8, 8, 16, 16, 16, 16]
    assert out["consumed_samples"] == sum(jsizes) == 80
    assert len(out["losses"]) == len(jout["losses"]) == 6
    assert all(np.isfinite(out["losses"]))
    # save at 3, resume to 6: the rest of the ramp and the same losses
    ck = str(tmp_path / "ck")
    t_train(t_init("train", TINY + ["--train_iters", "3", "--device", "cpu", "--save", ck]))
    res = t_train(t_init("train", TINY + ["--train_iters", "6", "--device", "cpu",
                                          "--load", ck]))
    assert res["batch_sizes"] == jsizes[3:] and res["consumed_samples"] == 80
    np.testing.assert_array_equal(res["losses"], out["losses"][3:])


def test_rampup_refusals_match_the_reference():
    from galvatron_tpu_torch.core.arguments import initialize_galvatron as t_init
    from galvatron_tpu_torch.core.trainer import train as t_train

    cases = [(["--pp_deg", "1", "--chunks", "3"], "divisible by chunks"),
             (["--prefetch_depth", "2", "--data_path", "x"], "incompatible with the data pipeline")]
    for extra, match in cases:
        with pytest.raises(ValueError, match=match):
            t_train(t_init("train", TINY + ["--train_iters", "1", "--device", "cpu", *extra]))
