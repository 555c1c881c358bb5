"""The port's blocked-causal flash attention (plain versions, the autograd
entries and the dispatch gates) against the JAX package's Pallas kernels,
which run in interpret mode on the CPU, as tests/test_ops.py runs them.
Inputs come from numpy seeds and go to both sides as the same arrays."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.models import modeling as jm
from galvatron_tpu.ops import flash_attention as jfa
from galvatron_tpu_torch.ops import flash_attention as tfa

# fp32: the two sides sum the products in other orders, and the Pallas
# kernels walk the softmax in blocks while the plain version takes the
# whole row at once; both differences stay near fp32 rounding of O(1) values
FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4
# bf16: both sides round q/k/p/ds at the same points, but p is rounded
# against a running max on the JAX side and the row max here, so single
# elements can land one bf16 ulp apart; outputs are O(1) (ulp 2^-7)
BF16_ATOL = 2 ** -6


def _tables(s, d):
    cfg = jm.ModelConfig(num_heads=1, hidden_size=d, max_seq_len=s)
    cos, sin = jm.rope_tables(cfg, s)
    return np.array(cos), np.array(sin)  # writable copies for torch.from_numpy


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).requires_grad_(True)


def _np(t):
    return t.detach().float().numpy()


CASES = {
    # name: (b, h, kv_heads, s, d, jax block_q)
    "mha": (2, 4, 4, 64, 32, 1024),
    "gqa_rep2": (2, 4, 2, 64, 32, 1024),
    "ragged_s100": (1, 2, 2, 100, 64, 1024),
    "multiblock_s128_bq32": (1, 2, 2, 128, 32, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hm_forward_and_grads_match_jax(case):
    b, h, kvh, s, d, bq = CASES[case]
    q, k, v, w = _arrays([(b, h, s, d), (b, kvh, s, d), (b, kvh, s, d), (b, h, s, d)], seed=len(case))
    cos, sin = _tables(s, d)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention_hm(q_, k_, v_, rope=(cos, sin), block_q=bq, block_k=bq)
        return (out * w).sum(), out

    (jl, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    tout = tfa.flash_attention_hm(tq, tk, tv, rope=(torch.from_numpy(cos), torch.from_numpy(sin)),
                                  block_q=bq, block_k=bq)
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=FWD_ATOL, rtol=0)
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_qkv_stacked_forward_and_grads_match_jax(dtype):
    b, h, s, d = 2, 4, 64, 32
    qkv, w = _arrays([(b, 3, h, s, d), (b, h, s, d)], seed=7)
    cos, sin = _tables(s, d)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def jloss(x):
        out = jfa.flash_attention_qkv(x, rope=(cos, sin))
        return (out.astype(jnp.float32) * w).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(qkv, jdt))
    tx = _t(qkv, tdt)
    tout = tfa.flash_attention_qkv(tx, rope=(torch.from_numpy(cos), torch.from_numpy(sin)))
    (tout.float() * torch.from_numpy(w)).sum().backward()
    fwd_tol, grad_tol = (FWD_ATOL, GRAD_ATOL) if dtype == "fp32" else (BF16_ATOL, 4 * BF16_ATOL)
    np.testing.assert_allclose(_np(tout), np.asarray(jout.astype(jnp.float32)), atol=fwd_tol,
                               rtol=0)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jg.astype(jnp.float32)), atol=grad_tol,
                               rtol=0)


def test_qkv_stacked_accepts_a_strided_projection_view():
    """The stacked input as the projection produces it: a (b, s, 3, h, d)
    buffer viewed as (b, 3, h, s, d), no copy; its gradient keeps the view's
    strides (the projection backward reads it as is)."""
    b, h, s, d = 1, 2, 64, 32
    (x,) = _arrays([(b, s, 3, h, d)], seed=3)
    cos, sin = (torch.from_numpy(t) for t in _tables(s, d))
    base = _t(x)
    view = base.permute(0, 2, 3, 1, 4)
    out = tfa.flash_attention_qkv(view, rope=(cos, sin))
    out.sum().backward()
    ref_in = _t(x).permute(0, 2, 3, 1, 4).contiguous().detach().requires_grad_(True)
    ref = tfa.flash_attention_qkv(ref_in, rope=(cos, sin))
    ref.sum().backward()
    np.testing.assert_array_equal(_np(out), _np(ref))
    np.testing.assert_array_equal(_np(base.grad.permute(0, 2, 3, 1, 4)), _np(ref_in.grad))


def test_qkv_backward_past_the_blocked_gate_takes_the_grid_kernels():
    """block_q 768 at s = 2304: the blocked forward applies but the blocked
    backward's 512-key tiles do not divide s, so the backward is the grid
    one on the blocked forward's lse (``_flash_qkv_bwd_rule``'s else
    branch): gradients against JAX."""
    b, h, s, d = 1, 1, 2304, 16
    assert tfa._use_blocked(s, d, True, True, 768, 768)
    assert not tfa._use_blocked_bwd(s, d, True, True, 768, 768)
    qkv, w = _arrays([(b, 3, h, s, d), (b, h, s, d)], seed=17)
    cos, sin = _tables(s, d)

    def jloss(x):
        return (jfa.flash_attention_qkv(x, rope=(cos, sin), block_q=768) * w).sum()

    jg = jax.grad(jloss)(qkv)
    tx = _t(qkv)
    out = tfa.flash_attention_qkv(tx, rope=(torch.from_numpy(cos), torch.from_numpy(sin)),
                                  block_q=768)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jg), atol=GRAD_ATOL, rtol=0)


def _dropped_tile_keep(s, device):
    """The causal mask with keys 0-63 dropped for the rows from
    max(64, s/2): a kernel that skipped that tile."""
    r = torch.arange(s, device=device)
    mask = r[:, None] >= r[None, :]
    mask[max(64, s // 2):, :64] = False
    return mask


@pytest.mark.parametrize("case", ["ragged_s100", "multiblock_s128_bq32"])
def test_bf16_parity_rule_holds_jax_and_rejects_a_dropped_tile(case, monkeypatch):
    """The rule the card holds the bf16 kernels to (``bf16_parity_excess``
    within ``BF16_PARITY_TOL``), applied to the JAX Pallas kernels against
    the port's plain versions: with four 32-row blocks the JAX forward
    rounds p against a running max, as the CUDA kernels do, and passes. The
    plain versions with a key tile dropped fail it."""
    b, h, kvh, s, d, bq = CASES[case]
    q, k, v, w = _arrays([(b, h, s, d), (b, kvh, s, d), (b, kvh, s, d), (b, h, s, d)], seed=13)
    cos, sin = _tables(s, d)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention_hm(q_, k_, v_, rope=(cos, sin), block_q=bq, block_k=bq)
        return (out.astype(jnp.float32) * w).sum(), out

    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(*args)
    ref = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in (jout, *jg)]

    def run():
        tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
        out = tfa.flash_attention_hm(tq, tk, tv, rope=(torch.from_numpy(cos),
                                                       torch.from_numpy(sin)),
                                     block_q=bq, block_k=bq)
        (out.float() * torch.from_numpy(w)).sum().backward()
        return [out, tq.grad, tk.grad, tv.grad]

    excess = [tfa.bf16_parity_excess(g, r) for g, r in zip(run(), ref)]
    assert excess[0] <= tfa.BF16_PARITY_TOL["fwd"]
    assert max(excess[1:]) <= tfa.BF16_PARITY_TOL["bwd"]
    monkeypatch.setattr(tfa, "_causal_keep", _dropped_tile_keep)
    control = [tfa.bf16_parity_excess(g, r) for g, r in zip(run(), ref)]
    assert control[0] > tfa.BF16_PARITY_TOL["fwd"]
    assert min(control[1:]) > tfa.BF16_PARITY_TOL["bwd"]


def test_bf16_parity_excess_forgives_one_ulp_and_scales_with_the_row():
    """One ulp of each element is the rounding both sides do: no excess.
    Past it, the error counts in units of the row's rms, so a row of small
    values is held as tightly as a row of large ones."""
    ref = torch.tensor([[1.0, -0.5, 0.25, 2.0], [1e-3, -2e-3, 4e-3, 1e-3]])
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs())) - 7)
    assert tfa.bf16_parity_excess(ref + ulp, ref) == 0.0
    rms = ref.square().mean(dim=-1, keepdim=True).sqrt()
    for row in range(2):
        got = ref.clone()
        got[row, 0] += ulp[row, 0] + 0.1 * rms[row, 0]
        assert tfa.bf16_parity_excess(got, ref) == pytest.approx(0.1, rel=1e-5)


def test_flash_bwd_plain_writes_into_given_grads():
    b, h, s, d = 1, 4, 64, 16
    q, k, v, do = (torch.from_numpy(a) for a in _arrays([(b, h, s, d), (b, 2, s, d),
                                                        (b, 2, s, d), (b, h, s, d)], seed=9))
    cos, sin = (torch.from_numpy(t) for t in _tables(s, d))
    out, lse = tfa.flash_fwd_blocked_plain(q, k, v, cos, sin, 0.25, 2)
    res = tfa.flash_bwd_plain(q, k, v, do, out, lse, cos, sin, 0.25, 2)
    ref = tfa.flash_bwd_blocked_plain(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1),
                                      do, out, lse, cos, sin, 0.25)
    grads = tuple(torch.empty_like(q) for _ in range(3))
    assert tfa.flash_bwd_plain(q, k, v, do, out, lse, cos, sin, 0.25, 2, grads) is grads
    for got, into, want in zip(res, grads, ref):
        assert torch.equal(got, want) and torch.equal(into, want)


@pytest.mark.parametrize("case", ["mha", "ragged_s100"])
def test_plain_forward_lse_matches_jax_blocked_kernel(case):
    """``flash_fwd_blocked_plain`` against ``_flash_fwd_blocked`` itself
    (interpret mode): out and the natural-log lse."""
    b, h, _, s, d, bq = CASES[case]
    q, k, v = _arrays([(b, h, s, d)] * 3, seed=11)
    cos, sin = _tables(s, d)
    jout, jlse = jfa._flash_fwd_blocked(q, k, v, (cos, sin), 1 / np.sqrt(d), min(bq, s), True)
    tout, tlse = tfa.flash_fwd_blocked_plain(*(torch.from_numpy(a) for a in (q, k, v, cos, sin)),
                                             1 / np.sqrt(d))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=FWD_ATOL, rtol=0)


# the shape table of tests/test_ops.py's gate assertions, plus the shapes
# the port's tests and main path use
GATE_SHAPES = [
    (16384, 128, 1024), (8192, 256, 1024), (4096, 128, 128), (8192, 128, 1024),
    (2048, 128, 1024), (4096, 128, 1024), (100, 64, 1024), (128, 32, 32), (64, 32, 1024),
    (1536, 128, 1024), (2048, 128, 512),
]


@pytest.mark.parametrize("s,d,bq", GATE_SHAPES)
def test_gates_agree_with_jax(s, d, bq):
    cos_sin = (None, None)
    b = min(bq, s)
    assert tfa._use_blocked(s, d, True, cos_sin, b, b) == jfa._use_blocked(s, d, True, cos_sin, b, b)
    assert tfa._use_blocked_bwd(s, d, True, cos_sin, b, b) == jfa._use_blocked_bwd(
        s, d, True, cos_sin, b, b)
    assert tfa._bwd_blocks(b) == jfa._bwd_blocks(b)
    assert tfa.flash_tileable(s, bq) == jfa.flash_tileable(s, bq)
    assert tfa.flash_qkv_supported(s, d, True, cos_sin) == jfa.flash_qkv_supported(
        s, d, True, cos_sin)
    assert not tfa._use_blocked(s, d, False, cos_sin, b, b)
    assert not tfa._use_blocked(s, d, True, None, b, b)


def test_envelopes_are_the_reference_defaults():
    assert tfa._BLOCKED_MAX_SEQ_X_DIM == jfa._BLOCKED_MAX_SEQ_X_DIM
    assert tfa._BWD_MAX_SEQ_X_DIM == jfa._BWD_MAX_SEQ_X_DIM
    assert tfa._BLOCKED_MAX_UNROLL == jfa._BLOCKED_MAX_UNROLL


def test_shapes_of_the_grid_kernels_raise_naming_the_roadmap():
    """The two shapes that raised before the grid kernels were ported (an
    untileable s = 1536 with RoPE, and no RoPE) now compute: forward and
    gradients against JAX's ``flash_attention_hm`` (its einsum fallback and
    its grid kernels in interpret mode)."""
    for s, rope, seed in ((1536, True, 21), (64, False, 22)):
        q, k, v, w = _arrays([(1, 2, s, 32), (1, 1, s, 32), (1, 1, s, 32), (1, 2, s, 32)],
                             seed=seed)
        _assert_attention_matches_jax("flash_attention_hm", (q, k, v), w,
                                      _tables(s, 32) if rope else None)


def _assert_attention_matches_jax(name, arrays, w, tables=None, **kw):
    """JAX's and the port's entry ``name`` on the same arrays, with the
    same rope tables and keywords: outputs and the gradients of
    sum(out * w)."""
    def jloss(*qkv):
        out = getattr(jfa, name)(*qkv, rope=tables, **kw)
        return (out * w).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(*arrays)
    tq, tk, tv = (_t(a) for a in arrays)
    trope = None if tables is None else tuple(torch.from_numpy(t) for t in tables)
    tout = getattr(tfa, name)(tq, tk, tv, rope=trope, **kw)
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=FWD_ATOL, rtol=0)
    for n, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{name} d{n}")


# the grid kernels' cases: several 64-row blocks at s = 256, so the JAX
# side walks a real grid and splits the diagonal blocks from the rest
GRID_CASES = {
    # name: (b, h, kv_heads, s, d, causal, rope, dtype, out_fp32)
    "causal": (2, 2, 2, 256, 32, True, False, "fp32", False),
    "causal_rope": (1, 2, 2, 256, 32, True, True, "fp32", False),
    "noncausal": (1, 2, 2, 256, 32, False, False, "fp32", False),
    "noncausal_rope": (1, 2, 2, 256, 32, False, True, "fp32", False),
    "gqa_rep2": (1, 4, 2, 256, 32, True, False, "fp32", False),
    "out_fp32": (1, 2, 2, 256, 32, True, False, "fp32", True),
    "bf16_causal": (1, 2, 2, 256, 32, True, False, "bf16", False),
    "bf16_noncausal_rope_out_fp32": (1, 2, 2, 256, 32, False, True, "bf16", True),
}
GRID_BLOCK = 64


def _grid_inputs(case, seed):
    b, h, kvh, s, d, causal, rope, dtype, out_fp32 = GRID_CASES[case]
    q, k, v, do = _arrays([(b, h, s, d), (b, kvh, s, d), (b, kvh, s, d), (b, h, s, d)], seed)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tables = _tables(s, d) if rope else None
    return dict(arrays=(q, k, v, do), jdt=jdt, tdt=tdt, tables=tables, rep=h // kvh,
                causal=causal, out_dtype=(jnp.float32, torch.float32) if out_fp32 else (None, None),
                sm=1 / np.sqrt(d))


def _grid_close(got, ref, which, dtype):
    if dtype == "fp32":
        tol = {"fwd": FWD_GRID_ATOL, "bwd": GRAD_ATOL}[which]
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=tol, rtol=0)
    else:
        assert tfa.bf16_parity_excess(got, torch.from_numpy(np.array(ref, np.float32))) \
            <= tfa.BF16_PARITY_TOL[which]


# fp32 out and lse of the grid plain version against the grid kernel
FWD_GRID_ATOL = 1e-5


def _dropped_grid_keep(s, causal, device):
    """The grid mask with keys 0-63 dropped for the rows from max(64, s/2)."""
    r = torch.arange(s, device=device)
    mask = r[:, None] >= r[None, :] if causal else torch.ones(s, s, dtype=torch.bool)
    mask[max(64, s // 2):, :64] = False
    return mask


def test_wrapper_refuses_what_the_kernel_does_not_take():
    cos, sin = torch.zeros(64, 6), torch.zeros(64, 6)
    q = torch.zeros(1, 2, 64, 12)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q, q, q, cos, sin, 0.3)
    q = torch.zeros(1, 2, 64, 16, dtype=torch.float64)
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        tfa.flash_fwd(q, q, q, torch.zeros(64, 8), torch.zeros(64, 8), 0.3)
    # fp16 runs the blocked kernels only; the grid kernels refuse it, naming the item
    q = torch.zeros(1, 2, 64, 16, dtype=torch.float16)
    with pytest.raises(TypeError, match=r"bf16 or fp32.*§1\.1"):
        tfa.flash_grid_fwd(q, q, q, None, 0.3, True)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    b, h, s, d = 1, 2, 64, 16
    q, k, v = (torch.from_numpy(a) for a in _arrays([(b, h, s, d)] * 3, seed=5))
    cos, sin = (torch.from_numpy(t) for t in _tables(s, d))
    before = (tfa.flash_fwd.launches, tfa.flash_bwd.launches)
    out, lse = tfa.flash_fwd(q, k, v, cos, sin, 0.25)
    ref_out, ref_lse = tfa.flash_fwd_blocked_plain(q, k, v, cos, sin, 0.25)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    tfa.flash_bwd(q, k, v, out, out, lse, cos, sin, 0.25)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == before


# ---------------------------------------------------------------------------
# The bf16 forward's k pre-pass (csrc/flash_fwd.cu ropes k once per call into
# a scratch): its plain version against the reference's rounding, bitwise.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["stacked", "gqa"])
def test_rope_k_plain_is_bitwise_the_reference_rounding(layout):
    import jax

    b, h, kvh, s, d = 2, 4, 2, 48, 64
    rng = np.random.RandomState(5)
    cos, sin = _tables(s, d)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32) * 3)
    qkv = qkv.to(torch.bfloat16).permute(0, 2, 3, 1, 4)  # the projection's strided view
    k = qkv[:, 1] if layout == "stacked" else qkv[:, 1, :kvh].contiguous()
    got = tfa.rope_k_plain(k, torch.from_numpy(cos), torch.from_numpy(sin))
    assert got.is_contiguous() and got.dtype == torch.bfloat16 and got.shape == k.shape
    kj = jnp.asarray(k.float().numpy()).astype(jnp.bfloat16)
    rope = jax.vmap(jax.vmap(jfa._rope_rows, (0, None, None)), (0, None, None))
    ref = np.asarray(rope(kj, jnp.asarray(cos), jnp.asarray(sin)).astype(jnp.bfloat16))
    assert np.array_equal(got.view(torch.int16).numpy(), ref.view(np.int16))


# ---------------------------------------------------------------------------
# The bf16 backward's TMA kernels (csrc/flash_bwd_common.cuh): the pre-pass
# (q' and k' roped once per call, delta) and the tile decomposition of the
# dk/dv and dq kernels, each as a plain twin held to the reference.
# ---------------------------------------------------------------------------


def _bf16_bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("layout", ["stacked", "gqa"])
def test_bwd_prepass_plain_is_the_reference_rounding(layout):
    """q' bitwise the reference's ``_rope_rows(q, cos·lam, sin·lam)
    .astype(bf16)`` (``_bwd_kernel_blocked``'s q rows), k' bitwise its
    ``_rope_rows(k, cos, sin).astype(bf16)``, and delta the fp32
    ``Σ do·out`` within 1e-5 (bf16 products are exact in fp32; only the
    order of the 64 additions differs)."""
    b, h, kvh, s, d = 2, 4, 2, 48, 64
    sm = 1 / np.sqrt(d)
    rng = np.random.RandomState(6)
    cos, sin = _tables(s, d)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32) * 3)
    qkv = qkv.to(torch.bfloat16).permute(0, 2, 3, 1, 4)  # the projection's strided view
    q = qkv[:, 0]
    k = qkv[:, 1] if layout == "stacked" else qkv[:, 1, :kvh].contiguous()
    do, out = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(2))
    qr, kr, delta = tfa.flash_bwd_prepass_plain(q, k, do, out, torch.from_numpy(cos),
                                                torch.from_numpy(sin), sm)
    assert qr.is_contiguous() and kr.is_contiguous() and delta.shape == (b, h, s)
    lam = jnp.float32(sm * jfa.LOG2E)
    rope = jax.vmap(jax.vmap(jfa._rope_rows, (0, None, None)), (0, None, None))

    def ref(x, c, s_):
        xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return np.asarray(rope(xj, c, s_).astype(jnp.bfloat16)).view(np.int16)

    assert np.array_equal(_bf16_bits(qr), ref(q, jnp.asarray(cos) * lam, jnp.asarray(sin) * lam))
    assert np.array_equal(_bf16_bits(kr), ref(k, jnp.asarray(cos), jnp.asarray(sin)))
    jdelta = jnp.sum(jnp.asarray(do.float().numpy()) * jnp.asarray(out.float().numpy()), axis=-1)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), atol=1e-5, rtol=0)


# (head_dim, dtype): both head dims of the kernels and so both walked-tile
# sizes (128 rows at head_dim 64, 64 at head_dim 128), fp32 for the
# algorithm and bf16 for the rounding points
TILE_CASES = [(64, "fp32"), (128, "fp32"), (64, "bf16"), (128, "bf16")]


def _tiles_close(got, ref, dtype):
    """fp32: GRAD_ATOL (summation order over tiles); bf16: the card's rule
    (``bf16_parity_excess`` within ``BF16_PARITY_TOL``: p and ds round at
    the same points, a value near a rounding boundary may land one bf16 ulp
    the other way)."""
    ref = torch.from_numpy(np.array(ref, np.float32))
    if dtype == "fp32":
        np.testing.assert_allclose(_np(got), ref.numpy(), atol=GRAD_ATOL, rtol=0)
    else:
        assert tfa.bf16_parity_excess(got, ref) <= tfa.BF16_PARITY_TOL["bwd"]


# ---------------------------------------------------------------------------
# The C entries' ctypes bindings against their extern "C" signatures
# ---------------------------------------------------------------------------

_CTYPE_OF = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "const long long*": ctypes.POINTER(ctypes.c_longlong), "int": ctypes.c_int,
             "float": ctypes.c_float, "int*": ctypes.POINTER(ctypes.c_int)}


def _c_signature(source, name):
    """The parameter types of ``int name(...)`` in ``csrc/<source>.cu``,
    parsed from its ``extern "C"`` block."""
    import re
    from pathlib import Path

    text = (Path(tfa.__file__).parent / "csrc" / f"{source}.cu").read_text()
    extern = text[text.index('extern "C" {'):]
    params = re.search(r"\bint " + name + r"\(([^)]*)\)", extern).group(1)
    return [" ".join(p.split()[:-1]).replace(" *", "*") for p in params.split(",")]


@pytest.mark.parametrize("name", sorted(tfa._ENTRIES))
def test_flash_c_entries_match_their_ctypes_argtypes(name):
    """Every flash C entry's ctypes argument list has one entry per C
    parameter, each of the matching type: a missing or extra argument
    shifts every later one and corrupts pointers silently on the card."""
    source, argtypes = tfa._ENTRIES[name]
    params = _c_signature(source, name)
    assert [_CTYPE_OF[p] for p in params] == argtypes


def test_grid_route_counters_exist_and_count_nothing_on_cpu():
    """``flash_grid_fwd.routes`` and ``flash_grid_bwd_parts.dq_routes`` (beside
    ``dkv_routes``) count the routes the C entries report, and ``.modes`` /
    ``.dkv_modes`` / ``.dq_modes`` the launches by shape and mask; CPU
    tensors run the plain versions and count no route, no launch and no
    mode."""
    for routes in (tfa.flash_grid_fwd.routes, tfa.flash_grid_bwd_parts.dkv_routes,
                   tfa.flash_grid_bwd_parts.dq_routes):
        assert set(routes) == set(tfa.ROUTES)
    counters = lambda: (dict(tfa.flash_grid_fwd.routes),  # noqa: E731
                        dict(tfa.flash_grid_bwd_parts.dkv_routes),
                        dict(tfa.flash_grid_bwd_parts.dq_routes), tfa.flash_grid_fwd.launches,
                        tfa.flash_grid_bwd_parts.dkv_launches, tfa.flash_grid_bwd_parts.dq_launches,
                        dict(tfa.flash_grid_fwd.modes), dict(tfa.flash_grid_bwd_parts.dkv_modes),
                        dict(tfa.flash_grid_bwd_parts.dq_modes))
    before = counters()
    b, h, s, d = 1, 2, 64, 64
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _arrays([(b, h, s, d)] * 4, seed=12))
    cos, sin = (torch.from_numpy(t) for t in _tables(s, d))
    out, lse = tfa.flash_grid_fwd(q, k, v, (cos, sin), 0.125, True)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    tfa.flash_grid_bwd_parts(q, k, v, do, lse, delta, (cos, sin), 0.125, True)
    assert counters() == before


def test_grid_launch_modes_key_by_shape_and_mask():
    """``_count_mode``, which the grid wrappers call where they launch, keys
    a launch by q's (b, h, s) and its mask, so a ring's past hops (unmasked)
    count apart from its diagonal blocks (causal) at the same shape."""
    modes = {}
    q = torch.empty(2, 32, 8192, 128, device="meta")
    for causal in (True, False, False):
        tfa._count_mode(modes, q, causal)
    tfa._count_mode(modes, q[:, :16], True)
    assert modes == {"2,32,8192,causal": 1, "2,32,8192,unmasked": 2, "2,16,8192,causal": 1}
