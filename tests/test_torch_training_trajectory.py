"""The 5-step fp32 trajectories of the port's ``build_runtime`` against the
JAX package's; split from ``tests/test_torch_training.py`` (whose helpers
and tolerances they use) so that the suite's workers can share the two
files."""

import jax
import jax.numpy as jnp
import pytest
import torch

from galvatron_tpu.core import optim as jopt
from galvatron_tpu.core.strategy import HybridParallelConfig
from galvatron_tpu.parallel import hybrid as jhybrid
from galvatron_tpu.parallel.mesh import build_mesh
from galvatron_tpu_torch import bridge
from galvatron_tpu_torch.core import dataloader as tdl
from galvatron_tpu_torch.core import optim as topt
from galvatron_tpu_torch.core.optim import tree_leaves
from galvatron_tpu_torch.parallel import hybrid as thybrid
from test_torch_training import (TRAJ_LOSS_ATOL, TRAJ_PARAM_ATOL, _assert_tree_close, _cfgs,
                                 _jax_params)
import _torch_threads  # noqa: F401


@pytest.mark.parametrize("chunks,attn", [(1, "flash"), (2, "flash"), (2, "xla")])
def test_five_step_trajectory_matches_jax_build_runtime(chunks, attn):
    """The whole fp32 train step (forward, backward, micro-batch
    accumulation, clip, AdamW with weight decay) against the JAX runtime on
    a one-device mesh: losses and parameters after 5 steps."""
    jcfg, tcfg = _cfgs(None, attn)
    adam = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    mesh, axes = build_mesh(pp=1, devices=jax.devices()[:1])
    hp = HybridParallelConfig.uniform(2, mixed_precision="fp32", chunks=chunks)
    jrt = jhybrid.build_runtime(jcfg, hp, mesh=mesh, axes=axes, adam=jopt.AdamConfig(**adam),
                                global_batch_size=4, seq_len=64)
    ref = _jax_params(jcfg, seed=5)
    jstate = jrt.init_state_from(jax.tree.map(jnp.asarray, ref))
    trt = thybrid.build_runtime(tcfg, adam=topt.AdamConfig(**adam), global_batch_size=4, seq_len=64,
                                chunks=chunks, mixed_precision="fp32", device="cpu")
    tstate = trt.state_from(bridge.params_from_jax(ref, tcfg, "cpu"))
    loader = tdl.build_dataloader(tcfg, 4, 64, seed=9)
    for step in range(5):
        batch = next(loader)
        jstate, jloss = jrt.train_step(jstate, jnp.asarray(batch))
        tstate, tloss = trt.train_step(tstate, torch.from_numpy(batch))
        assert abs(float(tloss) - float(jloss)) <= TRAJ_LOSS_ATOL, f"step {step}"
    assert tstate["step"] == 5 and tstate["opt"]["count"] == int(jstate["opt"]["count"])
    _assert_tree_close(tree_leaves(tstate["params"]), jstate["params"], TRAJ_PARAM_ATOL,
                       "params after 5 steps")
