"""Paged decode attention of the PyTorch port against the JAX package.

On the CPU the port's ``paged_decode_attention`` runs its plain version (the
kernel's function in PyTorch). It is held to JAX's
``paged_decode_attention`` both through the Pallas kernel (interpret mode,
as tests/test_paged_kv.py runs it) and through the XLA gather path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.ops import flash_attention as jfa
from galvatron_tpu_torch.ops import flash_attention as tfa
import _torch_threads  # noqa: F401

# fp32: the three implementations sum in different orders; 2e-5 is the
# tolerance the JAX package holds its own pallas-vs-xla check to
TOL = 2e-5

B, MB, BS, D = 4, 4, 8, 16
NPAGES = 1 + B * MB


def _case(n_heads, kv_heads, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, n_heads, D).astype(np.float32)
    k = rng.randn(NPAGES, BS, kv_heads, D).astype(np.float32)
    v = rng.randn(NPAGES, BS, kv_heads, D).astype(np.float32)
    tables = np.asarray([
        [5, 0, 0, 0],      # offset 0: only the first position; null-block tail
        [1, 2, 3, 4],      # offset 8: first position of the second block
        [1, 2, 9, 10],     # shares rows 1's first two blocks; last position
        [11, 12, 0, 0],    # ragged offset inside block 1; null-block tail
    ], np.int32)
    offsets = np.asarray([0, BS, MB * BS - 1, 13], np.int32)
    return q, k, v, tables, offsets


def _jax(q, k, v, tables, offsets, impl, dtype=jnp.float32):
    return np.asarray(jfa.paged_decode_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(tables), jnp.asarray(offsets), impl=impl,
    ).astype(jnp.float32))


def _torch(q, k, v, tables, offsets, dtype=torch.float32):
    out = tfa.paged_decode_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.from_numpy(tables),
        torch.from_numpy(offsets),
    )
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("n_heads,kv_heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_paged_decode_matches_jax(impl, n_heads, kv_heads):
    case = _case(n_heads, kv_heads)
    np.testing.assert_allclose(_torch(*case), _jax(*case, impl=impl), rtol=TOL, atol=TOL)


def test_paged_decode_ignores_keys_past_offset():
    """Changing K/V at positions past a row's offset (including the null
    block) leaves the output bit-identical."""
    q, k, v, tables, offsets = _case(4, 2)
    ref = _torch(q, k, v, tables, offsets)
    k2, v2 = k.copy(), v.copy()
    for page in (0, 3, 4):  # the null block and pages wholly past row 1's offset
        k2[page] += 100.0
        v2[page] -= 100.0
    k2[5, 1:] = 1e4  # row 0 attends position 0 only
    v2[12, 6:] = 1e4  # row 3 sits at offset 13 = its page 12, position 5
    np.testing.assert_array_equal(_torch(q, k2, v2, tables, offsets), ref)


def test_paged_decode_bf16_within_one_ulp_of_pallas():
    """bf16 inputs: both versions compute in fp32 and cast once, so the
    outputs differ by at most one bf16 ulp of the output."""
    case = _case(4, 2, seed=3)
    got = _torch(*case, dtype=torch.bfloat16)
    ref = _jax(*case, impl="pallas", dtype=jnp.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp), np.max(np.abs(got - ref) / ulp)


def _tensors(n_heads=4, kv_heads=2):
    q, k, v, tables, offsets = _case(n_heads, kv_heads)
    return [torch.from_numpy(a) for a in (q, k, v, tables, offsets)]


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError, "bf16, fp16 or fp32"),
    (lambda a: a.__setitem__(1, a[1].to(torch.bfloat16)), TypeError, "one dtype"),
    (lambda a: a.__setitem__(3, a[3].long()), TypeError, "int32"),
    (lambda a: a.__setitem__(4, a[4].long()), TypeError, "int32"),
    (lambda a: a.__setitem__(0, a[0].expand(B, 2, 4, D).contiguous()), ValueError, "q_len == 1"),
    (lambda a: a.__setitem__(0, a[0][..., :12].contiguous()), ValueError, "num_blocks"),
    (lambda a: a.__setitem__(0, torch.zeros(B, 1, 3, D)), ValueError, "multiple of"),
    (lambda a: a.__setitem__(3, a[3][:2]), ValueError, "block_tables"),
    (lambda a: a.__setitem__(4, a[4][:2]), ValueError, "q_offset"),
    (lambda a: a.__setitem__(1, a[1].transpose(0, 1).contiguous().transpose(0, 1)),
     ValueError, "contiguous"),
], ids=["fp64", "mixed", "tables-int64", "offsets-int64", "q-len", "head-dim",
        "heads", "tables-shape", "offsets-shape", "non-contiguous"])
def test_paged_decode_wrapper_rejects(mutate, exc, match):
    args = _tensors()
    mutate(args)
    with pytest.raises(exc, match=match):
        tfa.paged_decode_attention(*args)


def test_paged_decode_wrapper_rejects_head_dim_the_kernel_cannot_take():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 1, 2, 12).astype(np.float32))
    k = torch.from_numpy(rng.randn(3, 4, 2, 12).astype(np.float32))
    tables = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.paged_decode_attention(q, k, k, tables, torch.zeros(1, dtype=torch.int32))


def test_cpu_path_never_counts_a_launch():
    before = tfa.paged_decode_attention.launches
    tfa.paged_decode_attention(*_tensors())
    assert tfa.paged_decode_attention.launches == before


def test_decode_attention_matches_jax():
    """The contiguous-cache decode (probabilities cast to q's dtype before
    PV, as the reference does), GQA, per-row offsets."""
    rng = np.random.RandomState(7)
    q = rng.randn(3, 1, 4, D).astype(np.float32)
    k = rng.randn(3, 24, 2, D).astype(np.float32)
    v = rng.randn(3, 24, 2, D).astype(np.float32)
    offs = np.asarray([0, 11, 23], np.int32)
    ref = np.asarray(jfa.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          q_offset=jnp.asarray(offs)))
    got = tfa.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               q_offset=torch.from_numpy(offs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# The split-K kernel's plan and arithmetic (csrc/paged_decode.cu). The kernel
# itself runs only on the card; here its split plan and a plain twin of its
# partial-and-combine arithmetic are held to the JAX Pallas kernel.
# ---------------------------------------------------------------------------

PLAN_SHAPES = [
    # (b, kv x head chunks, max positions, SMs)
    (4, 32, 2048, 132), (4, 8, 2048, 132), (1, 32, 16384, 132), (4, 32, 293 * 7, 132),
    (1, 1, 1, 132), (64, 32, 2048, 132), (3, 2, 385, 114), (2, 2, 128 * 64, 16),
]


@pytest.mark.parametrize("b,kv,max_pos,sms", PLAN_SHAPES)
def test_paged_split_plan_covers_every_position_once(b, kv, max_pos, sms):
    splits, length = tfa._paged_splits(b, kv, max_pos, sms)
    assert splits >= 1 and length % tfa._PAGED_TILE == 0
    covered = np.zeros(max_pos, np.int64)
    for s in range(splits):
        lo, hi = s * length, min((s + 1) * length, max_pos)
        assert lo < hi, f"split {s} is empty"
        covered[lo:hi] += 1
    assert np.all(covered == 1)
    # no split under the minimum unless the whole row is shorter
    assert splits == 1 or length >= tfa._PAGED_MIN_SPLIT
    # at most about the aimed blocks an SM (one more split would pass it)
    assert splits == 1 or b * kv * (splits - 1) < tfa._PAGED_BLOCKS_PER_SM * sms


def test_paged_split_plan_never_reads_the_offsets():
    """The plan is a function of shapes alone, and the wrapper reads no
    device value back to the host (a sync in every decode layer)."""
    import inspect

    assert list(inspect.signature(tfa._paged_splits).parameters) == [
        "b", "kv", "max_positions", "num_sms"]
    src = inspect.getsource(tfa.paged_decode_attention)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(q_offset", "bool("):
        assert call not in src, call


def _split_case(bs, g, seed):
    """kv=2 heads, g query heads each, ~384 positions a row; six rows at
    offsets 0, bs - 1, bs, a split's last position, the next split's first
    position and the row's last position."""
    kv, d = 2, 16
    mb = -(-384 // bs)
    max_pos = mb * bs
    splits = tfa._paged_splits(6, kv, max_pos, 132)
    length = splits[1]
    assert splits[0] >= 3  # several splits, most of them past a short row's offset
    offsets = np.asarray([0, bs - 1, bs, length - 1, length, max_pos - 1], np.int32)
    b = len(offsets)
    rng = np.random.RandomState(seed)
    npages = 1 + b * mb
    q = rng.randn(b, 1, kv * g, d).astype(np.float32)
    k = rng.randn(npages, bs, kv, d).astype(np.float32)
    v = rng.randn(npages, bs, kv, d).astype(np.float32)
    tables = (rng.permutation(npages - 1)[: b * mb] + 1).reshape(b, mb).astype(np.int32)
    return (q, k, v, tables, offsets), splits


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("bs", [1, 7, 16, 64])
def test_paged_split_combine_twin_matches_jax_pallas(bs, g):
    """The kernel's split-and-combine arithmetic (partials per split in base
    2, empty splits skipped, combined in split order) against JAX's Pallas
    kernel (interpret mode), fp32, at split edges and with splits wholly past
    a row's offset."""
    case, splits = _split_case(bs, g, seed=bs * 10 + g)
    q, k, v, tables, offsets = (torch.from_numpy(a) for a in case)
    got = tfa.paged_decode_split_plain(q, k, v, tables, offsets, splits=splits).numpy()
    ref = _jax(*case, impl="pallas")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_paged_split_combine_twin_all_splits_empty_writes_zeros():
    """A row with nothing to attend (offset < 0; the engine never passes
    one) gets an empty partial from every split and zeros out, as the
    kernel's combine writes."""
    case, splits = _split_case(16, 2, seed=0)
    q, k, v, tables, offsets = (torch.from_numpy(a) for a in case)
    offsets[0] = -1
    got = tfa.paged_decode_split_plain(q, k, v, tables, offsets, splits=splits)
    assert torch.all(got[0] == 0) and torch.all(torch.isfinite(got))
