"""The grid flash kernels' plain versions (forward, dk/dv and dq on given
row statistics) and the head-major and (B, S, n, d) entries that route to
them, against the JAX package's Pallas grid kernels in interpret mode;
split from ``tests/test_torch_flash_attention.py`` (whose helpers and
tolerances they use) so that the suite's workers can share the two
files."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.ops import flash_attention as jfa
from galvatron_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_attention import (FWD_GRID_ATOL, GRID_BLOCK, GRID_CASES, _arrays,
                                        _assert_attention_matches_jax, _dropped_grid_keep,
                                        _grid_close, _grid_inputs, _np, _t, _tables)


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_forward_plain_matches_jax_kernel(case, monkeypatch):
    """``flash_fwd_grid_plain`` against ``_flash_fwd`` (interpret mode,
    64-row blocks): out (in ``out_dtype``) and the natural-log lse. In
    bf16 the JAX kernel rounds p against a running max, as the CUDA kernel
    does, and passes the card's rule; the plain version with a key tile
    dropped fails it."""
    g = _grid_inputs(case, seed=len(case) + 30)
    q, k, v, _ = g["arrays"]
    rope = g["tables"]
    jout, jlse = jfa._flash_fwd(*(jnp.asarray(a, g["jdt"]) for a in (q, k, v)), rope, g["sm"],
                                g["causal"], GRID_BLOCK, GRID_BLOCK, True,
                                out_dtype=g["out_dtype"][0], kv_rep=g["rep"])
    trope = None if rope is None else tuple(torch.from_numpy(t) for t in rope)
    tout, tlse = tfa.flash_fwd_grid_plain(*(_t(a, g["tdt"]).detach() for a in (q, k, v)), trope,
                                          g["sm"], g["causal"], g["rep"], g["out_dtype"][1])
    assert tout.dtype == (g["out_dtype"][1] or g["tdt"])
    _grid_close(tout, jout.astype(jnp.float32), "fwd", GRID_CASES[case][7])
    np.testing.assert_allclose(_np(tlse), np.asarray(jlse), atol=FWD_GRID_ATOL, rtol=0)
    if GRID_CASES[case][7] == "bf16":
        monkeypatch.setattr(tfa, "_grid_keep", _dropped_grid_keep)
        ctl, _ = tfa.flash_fwd_grid_plain(*(_t(a, g["tdt"]).detach() for a in (q, k, v)), trope,
                                          g["sm"], g["causal"], g["rep"], g["out_dtype"][1])
        ref = torch.from_numpy(np.array(jout.astype(jnp.float32)))
        assert tfa.bf16_parity_excess(ctl, ref) > tfa.BF16_PARITY_TOL["fwd"]


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_backward_plain_matches_jax_kernels(case):
    """``flash_bwd_grid_plain`` against ``_flash_bwd_parts`` (interpret
    mode, 64-row blocks) on caller-given row statistics: lse shifted off the
    forward's and a random delta, as ring attention's global statistics
    are not the local ones; k/v broadcast to h heads by the caller."""
    g = _grid_inputs(case, seed=len(case) + 40)
    q, k, v, do = g["arrays"]
    b, h, _, s, d = GRID_CASES[case][:5]
    rng = np.random.RandomState(5)
    lse = (rng.standard_normal((b, h, s, 1)) * 0.1 + np.log(s)).astype(np.float32)
    delta = rng.standard_normal((b, h, s, 1)).astype(np.float32)
    kf, vf = (np.repeat(a, g["rep"], axis=1) for a in (k, v))
    rope = g["tables"]
    jgrads = jfa._flash_bwd_parts(*(jnp.asarray(a, g["jdt"]) for a in (q, kf, vf, do)), lse,
                                  delta, rope, g["sm"], g["causal"], GRID_BLOCK, GRID_BLOCK, True)
    trope = None if rope is None else tuple(torch.from_numpy(t) for t in rope)
    tgrads = tfa.flash_bwd_grid_plain(*(_t(a, g["tdt"]).detach() for a in (q, kf, vf, do)),
                                      torch.from_numpy(lse), torch.from_numpy(delta), trope,
                                      g["sm"], g["causal"])
    for got, ref in zip(tgrads, jgrads):
        assert got.dtype == g["tdt"]
        _grid_close(got, ref.astype(jnp.float32), "bwd", GRID_CASES[case][7])


def test_grid_bwd_parts_broadcasts_kv_and_writes_into_given_grads():
    """The wrapper's CPU route: GQA k/v broadcast to h heads before the
    plain version, results copied into given outputs."""
    b, h, s, d = 1, 4, 64, 16
    q, k, v, do = (torch.from_numpy(a) for a in _arrays([(b, h, s, d), (b, 2, s, d),
                                                        (b, 2, s, d), (b, h, s, d)], seed=9))
    out, lse = tfa.flash_grid_fwd(q, k, v, None, 0.25, True, 2)
    delta = (do * out).sum(-1, keepdim=True)
    ref = tfa.flash_bwd_grid_plain(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1), do,
                                   lse, delta, None, 0.25, True)
    grads = tuple(torch.empty_like(q) for _ in range(3))
    assert tfa.flash_grid_bwd_parts(q, k, v, do, lse, delta, None, 0.25, True, 2, grads) is grads
    for into, want in zip(grads, ref):
        assert torch.equal(into, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rope", [False, True])
def test_hm_grid_path_matches_jax(causal, rope):
    """``flash_attention_hm`` outside the blocked envelope (no RoPE, or
    non-causal) with four 32-row blocks: forward and gradients through the
    port's grid route against JAX's grid kernels in interpret mode."""
    s, d = 128, 32
    q, k, v, w = _arrays([(1, 4, s, d), (1, 2, s, d), (1, 2, s, d), (1, 4, s, d)],
                         seed=50 + 2 * causal + rope)
    _assert_attention_matches_jax("flash_attention_hm", (q, k, v), w,
                                  _tables(s, d) if rope else None, causal=causal, block_q=32,
                                  block_k=32)


@pytest.mark.parametrize("s,causal,rope", [(1, True, True), (100, True, False),
                                           (96, False, True), (64, True, False)])
def test_bsnd_flash_attention_matches_jax(s, causal, rope):
    """``flash_attention`` over (B, S, n, d): one query row (decode path),
    an untileable s (the einsum fallback, block 64), and the kernel route."""
    d = 32
    q, k, v, w = _arrays([(2, s, 2, d)] * 4, seed=60 + s)
    _assert_attention_matches_jax("flash_attention", (q, k, v), w,
                                  _tables(s, d) if rope else None, causal=causal, block_q=64,
                                  block_k=64)
