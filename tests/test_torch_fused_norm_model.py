"""The model's loss and every gradient with ``fused_norm=True`` against the
JAX model with the same flag, per family, attention path and recompute
policy; split from ``tests/test_torch_fused_norm.py`` (whose helpers and
tolerances they use) so that the suite's workers can share the files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.models import modeling as jm
from galvatron_tpu_torch.core.optim import tree_leaves
from galvatron_tpu_torch.models import modeling as tm
from test_torch_fused_norm import (GRAD_ATOL, GRAD_SCALE_TOL, LOSS_ATOL, _assert_leaves_close,
                                   _batch, _cfgs, _jax_params, _torch_params)


@pytest.mark.parametrize("recompute", ["off", "gate", "policy"])
@pytest.mark.parametrize("attn", ["xla", "flash"])
@pytest.mark.parametrize("family", ["llama", "opt"])
def test_fused_norm_loss_and_grads_match_jax(family, attn, recompute):
    """The summed token loss and every gradient with ``fused_norm=True`` on
    both sides: loss within 1e-5 a token, each gradient leaf within 1e-6 +
    5e-6 of its largest magnitude (fp32 sums in other orders)."""
    jcfg, tcfg = _cfgs(family, attn, recompute)
    ref = _jax_params(jcfg)
    batch = _batch(2, 64)
    (js, jn), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss_sum(p, jnp.asarray(batch), jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, ref))
    params = _torch_params(ref, tcfg)
    ts, tn = tm.lm_loss_sum(params, torch.from_numpy(batch).long(), tcfg)
    ts.backward()
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(ts.detach()), float(js), atol=LOSS_ATOL * batch.size,
                               rtol=1e-6)
    _assert_leaves_close([p.grad for p in tree_leaves(params)], jg, GRAD_ATOL, "grad",
                         scale_tol=GRAD_SCALE_TOL)
