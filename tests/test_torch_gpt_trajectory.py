"""The GPT family's 5-step fp32 trajectories against the JAX package's
``build_runtime``; split from ``tests/test_torch_gpt.py`` (whose helpers and
tolerances they use) so that the suite's workers can share the two files."""

import jax
import jax.numpy as jnp
import numpy as np
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
from test_torch_gpt import TRAJ_ATOL, _assert_leaves_close, _cfgs, _jax_params
import _torch_threads  # noqa: F401


@pytest.mark.parametrize("chunks", [1, 2])
def test_five_step_trajectory_matches_jax_build_runtime(chunks):
    """The whole fp32 GPT train step on the flash path (forward, backward,
    micro-batch accumulation, clip, AdamW with weight decay) against the JAX
    runtime on a one-device mesh: losses and parameters after 5 steps."""
    jcfg, tcfg = _cfgs("gelu", "flash")
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
        assert abs(float(tloss) - float(jloss)) <= TRAJ_ATOL, f"step {step}"
    # the key slot of the qkv bias gets an exactly-zero gradient (a shift
    # of every key by one vector moves each score row by a constant, which
    # softmax ignores); AdamW normalises the rounding noise left there to
    # steps of up to ~lr, so that slot is held to 5 steps x lr
    tleaves, jleaves = [], []
    for t, (path, j) in zip(tree_leaves(tstate["params"]),
                            jax.tree_util.tree_flatten_with_path(jstate["params"])[0]):
        j = np.asarray(j)
        if jax.tree_util.keystr(path).endswith("'wqkv_b']"):
            np.testing.assert_allclose(t[1].detach().numpy(), j[1], atol=5 * adam["lr"], rtol=0)
            t, j = t[[0, 2]], j[[0, 2]]
        tleaves.append(t)
        jleaves.append(j)
    _assert_leaves_close(tleaves, jleaves, TRAJ_ATOL, "params after 5 steps")
