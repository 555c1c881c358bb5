"""The fp16 instances' plain versions against the JAX package's Pallas
kernels at fp16 in interpret mode, on the CPU: the grid forward
(``_flash_fwd``) and the grid backward on given row statistics
(``_flash_bwd_parts``), causal and unmasked, with RoPE, GQA, a ragged s
and fp32 output; the four fused norm kernel functions at H 128 and 256;
and ``paged_decode_attention``. Inputs come from numpy seeds and go to both
sides as the same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.ops import flash_attention as jfa
from galvatron_tpu.ops import fused_norm as jfn
from galvatron_tpu_torch.ops import flash_attention as tfa
from galvatron_tpu_torch.ops import fused_norm as fn
from test_torch_flash_attention import _arrays, _tables
from test_torch_fp16 import _row_excess
import _torch_threads  # noqa: F401

# out, dq, dk and dv within 2^-8 of each row's rms, lse within 1e-3: the
# bounds the blocked kernels' fp16 plain versions are held to
# (tests/test_torch_fp16.py)
ROW_TOL = 2 ** -8
LSE_TOL = 1e-3

GRID_CASES = {
    # name: (b, h, kv_heads, s, d, causal, rope, out_fp32, JAX block)
    "causal": (2, 2, 2, 256, 32, True, False, False, 64),
    "unmasked": (1, 2, 2, 256, 32, False, False, False, 64),
    "causal_rope": (1, 2, 2, 256, 32, True, True, False, 64),
    "unmasked_rope": (1, 2, 2, 256, 32, False, True, False, 64),
    "gqa_rep2": (1, 4, 2, 256, 32, True, False, False, 64),
    # a ragged s: one JAX block of 100 rows, a ragged last tile on the card
    "ragged_s100": (1, 2, 2, 100, 32, True, False, False, 100),
    "out_fp32": (1, 2, 2, 256, 32, True, False, True, 64),
}


def _grid(case, seed):
    b, h, kvh, s, d, causal, rope, out_fp32, block = GRID_CASES[case]
    q, k, v, do = _arrays([(b, h, s, d), (b, kvh, s, d), (b, kvh, s, d), (b, h, s, d)], seed)
    tables = _tables(s, d) if rope else None
    trope = None if tables is None else tuple(torch.from_numpy(t) for t in tables)
    return (q, k, v, do), tables, trope, h // kvh, causal, out_fp32, block, 1 / np.sqrt(d)


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_forward_at_fp16_matches_the_pallas_kernel(case):
    """``flash_grid_fwd`` on CPU fp16 tensors (its plain version) against
    ``_flash_fwd`` at fp16: out in fp16 (or fp32), lse in fp32."""
    (q, k, v, _), tables, trope, rep, causal, out_fp32, block, sm = _grid(case, len(case))
    jout, jlse = jfa._flash_fwd(*(jnp.asarray(a, jnp.float16) for a in (q, k, v)), tables, sm,
                                causal, block, block, True,
                                out_dtype=jnp.float32 if out_fp32 else None, kv_rep=rep)
    out_dtype = torch.float32 if out_fp32 else None
    out, lse = tfa.flash_grid_fwd(*(torch.from_numpy(a).half() for a in (q, k, v)), trope, sm,
                                  causal, rep, out_dtype)
    assert out.dtype == (out_dtype or torch.float16) and lse.dtype == torch.float32
    assert _row_excess(out.float().numpy(), np.asarray(jout, np.float32)) <= ROW_TOL
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_backward_at_fp16_matches_the_pallas_kernels(case):
    """``flash_grid_bwd_parts`` on CPU fp16 tensors against
    ``_flash_bwd_parts`` at fp16 on caller-given row statistics (lse off
    the forward's and a random delta, as a ring's global ones are): dq, dk
    and dv in fp16; k/v broadcast to h heads for the JAX side, the wrapper
    broadcasts them itself."""
    (q, k, v, do), tables, trope, rep, causal, _, block, sm = _grid(case, len(case) + 40)
    b, h, _, s, _ = GRID_CASES[case][:5]
    rng = np.random.RandomState(5)
    lse = (rng.standard_normal((b, h, s, 1)) * 0.1 + np.log(s)).astype(np.float32)
    delta = rng.standard_normal((b, h, s, 1)).astype(np.float32)
    kf, vf = (np.repeat(a, rep, axis=1) for a in (k, v))
    jgrads = jfa._flash_bwd_parts(*(jnp.asarray(a, jnp.float16) for a in (q, kf, vf, do)), lse,
                                  delta, tables, sm, causal, block, block, True)
    grads = tfa.flash_grid_bwd_parts(*(torch.from_numpy(a).half() for a in (q, kf, vf, do)),
                                     torch.from_numpy(lse), torch.from_numpy(delta), trope, sm,
                                     causal)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == torch.float16, name
        assert _row_excess(got.float().numpy(), np.asarray(ref, np.float32)) <= ROW_TOL, name


# the four norm kernel functions: tests/test_torch_fused_norm.py's inputs and
# bounds (bf16 y / dx within 2e-2, one rounding of values up to ~4) scaled
# to fp16's ulp (2^-3 of bf16's); the fp32 statistics and column sums keep
# their fp32 bounds
NORM_N = 1030
EPS = 1e-5
NORM_FP16_TOL = 2e-2 * 2 ** -3
STAT_TOL = 1e-5
COLSUM_TOL = 1e-4


def _norm_inputs(h):
    rng = np.random.RandomState(h)
    x = (rng.standard_normal((NORM_N, h)) * 1.5 + 0.3).astype(np.float32)
    dy = rng.standard_normal((NORM_N, h)).astype(np.float32)
    g = (rng.standard_normal(h) * 0.1 + 1.0).astype(np.float32)
    b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    return np.float16(x), np.float16(dy), g, b


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_norm_kernel_functions_at_fp16_match_the_pallas_kernels(norm, h):
    """The wrappers on CPU fp16 rows (their plain versions) against
    ``_rms_fwd`` / ``_rms_bwd`` / ``_ln_fwd`` / ``_ln_bwd`` at fp16 in
    interpret mode: y and dx in fp16, the statistics and dscale / dbias in
    fp32; the backward on the JAX forward's statistics."""
    x, dy, g, b = _norm_inputs(h)
    jx, jdy, jg, jb = jnp.asarray(x), jnp.asarray(dy), jnp.asarray(g), jnp.asarray(b)
    tx, tdy, tg, tb = (torch.from_numpy(np.array(a)) for a in (x, dy, g, b))
    if norm == "rms":
        jy, jr = jfn._rms_fwd(jx, jg, EPS, True)
        jstats = (jr,)
        jback = jfn._rms_bwd(jx, jg, jr, jdy, True)
        y, *stats = fn.rms_fwd(tx, tg, EPS)
        back = fn.rms_bwd(tx, tg, torch.from_numpy(np.array(jr)), tdy)
    else:
        jy, jmu, jr = jfn._ln_fwd(jx, jg, jb, EPS, True)
        jstats = (jmu, jr)
        jback = jfn._ln_bwd(jx, jg, jmu, jr, jdy, True)
        y, *stats = fn.ln_fwd(tx, tg, tb, EPS)
        back = fn.ln_bwd(tx, tg, *(torch.from_numpy(np.array(t)) for t in jstats), tdy)
    assert y.dtype == back[0].dtype == torch.float16 and jy.dtype == jnp.float16
    _close(y, jy, NORM_FP16_TOL, "y")
    for got, ref in zip(stats, jstats):
        assert got.dtype == torch.float32
        _close(got, ref, STAT_TOL, "statistics")
    _close(back[0], jback[0], NORM_FP16_TOL, "dx")
    for name, got, ref in zip(("dscale", "dbias"), back[1:], jback[1:]):
        assert got.dtype == torch.float32
        _close(got, ref, COLSUM_TOL, name)


def test_paged_decode_at_fp16_within_one_ulp_of_pallas():
    """fp16 q / k / v pages: both versions compute in fp32 and cast once,
    so the outputs differ by at most one fp16 ulp of the output."""
    from test_torch_paged_attention import _case, _jax, _torch

    case = _case(4, 2, seed=4)
    got = _torch(*case, dtype=torch.float16)
    ref = _jax(*case, impl="pallas", dtype=jnp.float16)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 10)
    assert np.all(np.abs(got - ref) <= ulp), np.max(np.abs(got - ref) / ulp)
