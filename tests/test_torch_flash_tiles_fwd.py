"""The plain twin of the bf16 grid forward's TMA kernel walk and the grid
dq kernel's walk against the JAX package's Pallas kernels in interpret mode
(``_flash_fwd``, ``_flash_bwd_parts``); split from
``tests/test_torch_flash_attention.py`` (whose helpers and tolerances they
use) so that the suite's workers can share the load."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.ops import flash_attention as jfa
from galvatron_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_attention import FWD_GRID_ATOL, _arrays, _np, _t, _tables, _tiles_close


# ---------------------------------------------------------------------------
# The bf16 grid forward's TMA kernel (csrc/flash_fwd_common.cuh, GRID true):
# the plain twin of its walk held to the reference's `_fwd_kernel`.
# ---------------------------------------------------------------------------

FWD_TILE_CASES = [
    # (head_dim, dtype, causal, rope, out fp32, s, kv_rep); s = 384 is three
    # 128-row blocks, s = 200 leaves the last block and key tile ragged
    *[(d, "bf16", causal, rope, False, 384, 1) for d in (64, 128) for causal in (True, False)
      for rope in (False, True)],
    (64, "bf16", True, False, True, 384, 1),
    (128, "bf16", False, True, True, 384, 1),
    (64, "bf16", True, True, False, 200, 1),
    (128, "bf16", False, False, False, 200, 1),
    (64, "bf16", True, False, False, 384, 2),
    (64, "fp32", True, True, False, 384, 1),
    (128, "fp32", False, False, False, 200, 1),
]


@pytest.mark.parametrize("d,dtype,causal,rope,out_fp32,s,rep", FWD_TILE_CASES)
def test_fwd_tiles_plain_matches_jax_grid_kernel(d, dtype, causal, rope, out_fp32, s, rep):
    """``flash_fwd_tiles_plain`` (128-query blocks, 128-key tiles, the
    online softmax in the kernel's order) against ``_flash_fwd`` in
    interpret mode (blocks of 64, or 40 at s = 200): out in ``out_dtype``
    within 2^-5 by ``bf16_parity_excess`` (fp32 1e-5), lse within 1e-4 (fp32
    1e-5); causal or not, with and without RoPE, GQA, ragged s."""
    b, h = 1, 2 * rep
    sm = 1 / np.sqrt(d)
    block = 64 if s % 64 == 0 else 40
    q, k, v = _arrays([(b, h, s, d), (b, h // rep, s, d), (b, h // rep, s, d)],
                      seed=90 + d + s + 2 * causal + rope)
    tables = _tables(s, d) if rope else None
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jout, jlse = jfa._flash_fwd(*(jnp.asarray(a, jdt) for a in (q, k, v)), tables, sm, causal,
                                block, block, True, out_dtype=jnp.float32 if out_fp32 else None,
                                kv_rep=rep)
    trope = None if tables is None else tuple(torch.from_numpy(t) for t in tables)
    tout, tlse = tfa.flash_fwd_tiles_plain(*(_t(a, tdt).detach() for a in (q, k, v)), trope, sm,
                                           causal, rep, torch.float32 if out_fp32 else None)
    assert tout.dtype == (torch.float32 if out_fp32 else tdt) and tlse.shape == (b, h, s, 1)
    ref = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    if dtype == "fp32":
        np.testing.assert_allclose(_np(tout), ref.numpy(), atol=FWD_GRID_ATOL, rtol=0)
    else:
        assert tfa.bf16_parity_excess(tout, ref) <= tfa.BF16_PARITY_TOL["fwd"]
    np.testing.assert_allclose(_np(tlse), np.asarray(jlse),
                               atol=FWD_GRID_ATOL if dtype == "fp32" else 1e-4, rtol=0)


@pytest.mark.parametrize("d,causal,rope,s,rep", [(64, True, False, 384, 2),
                                                 (128, False, True, 384, 2),
                                                 (64, True, True, 200, 1),
                                                 (128, False, False, 200, 1)])
def test_bwd_tiles_plain_dq_walk_matches_jax_grid_kernels(d, causal, rope, s, rep):
    """The walk the grid dq kernel now takes (128-query blocks over W-key
    tiles, q' and k' from the dk/dv call's pre-pass with RoPE) where the
    cases above leave it open: GQA (k/v broadcast by the caller, as
    ``flash_grid_bwd_parts`` reads kv head h / kv_rep) and a ragged s whose
    last query block and key tile are partly past s, in bf16 against
    ``_flash_bwd_parts`` in interpret mode (blocks of 64, or 40 at
    s = 200)."""
    b, h = 1, 2 * rep
    sm = 1 / np.sqrt(d)
    block = 64 if s % 64 == 0 else 40
    q, k, v, do = _arrays([(b, h, s, d), (b, h // rep, s, d), (b, h // rep, s, d), (b, h, s, d)],
                          seed=110 + d + s + rope)
    kf, vf = (np.repeat(a, rep, axis=1) for a in (k, v))
    rng = np.random.RandomState(6)
    lse = (rng.standard_normal((b, h, s, 1)) * 0.1 + np.log(s)).astype(np.float32)
    delta = rng.standard_normal((b, h, s, 1)).astype(np.float32)
    tables = _tables(s, d) if rope else None
    jgrads = jfa._flash_bwd_parts(*(jnp.asarray(a, jnp.bfloat16) for a in (q, kf, vf, do)), lse,
                                  delta, tables, sm, causal, block, block, True)
    tq, tk, tv, tdo = (_t(a, torch.bfloat16).detach() for a in (q, kf, vf, do))
    trope = None if tables is None else tuple(torch.from_numpy(t) for t in tables)
    if trope is not None:
        tq, tk = tfa.rope_k_plain(tq, *trope), tfa.rope_k_plain(tk, *trope)
    tgrads = tfa.flash_bwd_tiles_plain(tq, tk, tv, tdo, torch.from_numpy(lse),
                                       torch.from_numpy(delta), sm, causal=causal, grid=True,
                                       rope=trope)
    for got, ref in zip(tgrads, jgrads):
        _tiles_close(got, ref.astype(jnp.float32), "bf16")
