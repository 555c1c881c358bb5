"""The 5-step fp32 trajectory with ``fused_norm=True`` of the GPT (LayerNorm, gelu)
family against the JAX runtime, split from ``tests/test_torch_fused_norm.py``
(which holds the body and the cases) so that the suite's workers can share
the trajectories."""

import pytest

from test_torch_fused_norm import TRAJECTORY_CASES, five_step_trajectory


@pytest.mark.parametrize("family,chunks,ckpt", [c for c in TRAJECTORY_CASES if c[0] == "gpt"])
def test_five_step_trajectory_with_fused_norm_matches_jax_build_runtime(family, chunks, ckpt):
    """``five_step_trajectory``: the loss of each of 5 AdamW steps and the
    parameters after them within 1e-4 of the JAX runtime's."""
    five_step_trajectory(family, chunks, ckpt)
