"""Card-side checks of the port (marker ``gpu``): the hand-written paged
decode, flash forward/backward and fused norm kernels against their plain
PyTorch versions on the same CUDA tensors, and the engine and the train
step on the card against the CPU. Each test skips,
with its reason, where ``torch.cuda.is_available()`` is false; run them on
the card with ``python -m pytest tests/test_torch_gpu.py -m gpu``."""

import math

import numpy as np
import pytest
import torch

from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.ops import flash_attention as fa
from galvatron_tpu_torch.ops import fused_norm as fn

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, b, n, kv, d, bs, mb, offsets, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    nblocks = 1 + b * mb
    q = torch.randn(b, 1, n, d, generator=g)
    k = torch.randn(nblocks, bs, kv, d, generator=g)
    v = torch.randn(nblocks, bs, kv, d, generator=g)
    tables = (torch.randperm(nblocks - 1, generator=g)[: b * mb] + 1).reshape(b, mb)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            tables.to(dev, torch.int32), torch.tensor(offsets, dtype=torch.int32, device=dev))


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("n,kv,d", [(32, 32, 128), (32, 8, 128), (8, 2, 64), (25, 25, 64),
                                    (4, 4, 256)])
def test_kernel_matches_plain_bf16(cuda, n, kv, d):
    """bf16: the kernel's output is within one output ulp of the plain
    version computed in fp32 on the same inputs, plus the fp32 tolerance
    1e-5 for results that cancel to near zero (summation order differs)."""
    case = _case(cuda, torch.bfloat16, 4, n, kv, d, 16, 128, [0, 15, 16, 2047])
    before = fa.paged_decode_attention.launches
    out = fa.paged_decode_attention(*case)
    torch.cuda.synchronize()
    assert fa.paged_decode_attention.launches == before + 1
    ref = fa.paged_decode_attention_plain(*[t.float() if t.is_floating_point() else t
                                            for t in case])
    assert torch.all((out.float() - ref).abs() <= _bf16_ulp(ref) + 1e-5)


@pytest.mark.parametrize("kv", [32, 8])
def test_kernel_matches_plain_fp32(cuda, kv):
    """fp32: agreement to 1e-5 (summation order differs)."""
    case = _case(cuda, torch.float32, 4, 32, kv, 128, 16, 128, [0, 15, 16, 2047])
    out = fa.paged_decode_attention(*case)
    ref = fa.paged_decode_attention_plain(*case)
    assert (out - ref).abs().max().item() <= 1e-5


def _paged_close(case):
    """The kernel against the plain version computed in fp32: bf16 within
    one output ulp + 1e-5, fp32 within 1e-5; one launch."""
    before = fa.paged_decode_attention.launches
    out = fa.paged_decode_attention(*case)
    torch.cuda.synchronize()
    assert fa.paged_decode_attention.launches == before + 1
    ref = fa.paged_decode_attention_plain(*[t.float() if t.is_floating_point() else t
                                            for t in case])
    err = (out.float() - ref).abs()
    if out.dtype == torch.float32:
        return bool(err.max() <= 1e-5)
    return bool(torch.all(err <= _bf16_ulp(ref) + 1e-5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,kv,bs,mb", [
    (32, 32, 16, 128), (32, 8, 16, 128), (32, 4, 16, 128), (8, 1, 16, 128),
    (16, 16, 1, 700), (16, 4, 7, 293), (16, 16, 64, 32),
], ids=["mha", "gqa4", "gqa8", "g8", "bs1", "bs7", "bs64"])
def test_paged_kernel_at_split_edges(cuda, n, kv, bs, mb, dtype):
    """Rows at offset 0, bs - 1, bs, the last position of split 0, the
    first of split 1 and the row's last position: every edge of a page, a
    warp tile and a split, over MHA, GQA groups of 4 and 8 and block sizes
    1, 7, 16 and 64."""
    _, length = fa._paged_splits(6, kv, mb * bs, fa._num_sms(cuda))
    offsets = [0, bs - 1, bs, length - 1, length, mb * bs - 1]
    assert _paged_close(_case(cuda, dtype, 6, n, kv, 128, bs, mb, offsets, seed=bs))


def test_paged_kernel_long_row(cuda):
    """One row of 16384 positions (many splits)."""
    assert _paged_close(_case(cuda, torch.bfloat16, 1, 32, 32, 128, 16, 1024, [16383]))


def test_paged_kernel_all_splits_empty_but_one(cuda):
    """Every row's offset inside split 0: every other split writes an empty
    partial that the combine must skip."""
    _, length = fa._paged_splits(4, 32, 2048, fa._num_sms(cuda))
    offsets = [3, 0, 100, length - 1]
    assert _paged_close(_case(cuda, torch.bfloat16, 4, 32, 32, 128, 16, 128, offsets))


def test_engine_on_card_matches_cpu(cuda):
    """fp32 greedy output of the engine on the card equals the engine on
    the CPU (plain attention) for prompts sharing a prefix."""
    from galvatron_tpu_torch.serving import Engine

    cfg = modeling.ModelConfig(vocab_size=384, hidden_size=256, num_layers=2, num_heads=4,
                               num_kv_heads=2, ffn_dim=512, max_seq_len=128,
                               dtype=torch.float32)
    cpu_params = modeling.init_model_params(cfg, 0, "cpu")
    rng = np.random.RandomState(0)
    base = rng.randint(1, 384, (40,)).tolist()
    prompts = [base + [5], base + [9, 11], rng.randint(1, 384, (7,)).tolist()]
    outs = []
    for dev in ("cpu", "cuda"):
        params = _to(cpu_params, dev)
        with Engine(params, cfg, device=dev, num_slots=2, prefill_chunk=16,
                    kv_num_blocks=-1) as eng:
            outs.append(eng.generate(prompts, max_new_tokens=8))
            st = eng.stats()
    assert outs[0] == outs[1]
    assert st["decode_steps"] > 0
    assert math.isfinite(st["tokens_per_s"])


@pytest.mark.parametrize("family,backend", [("llama", "slot"), ("gpt", "paged"),
                                            ("gpt", "slot")])
def test_slot_and_gpt_engines_on_card_match_cpu(cuda, family, backend):
    """fp32 greedy output of the slot engine (plain decode attention) and of
    GPT (learned positions, LayerNorm, biases, tied head; head_dim 64) on the
    card equals the same engine on the CPU; the paged GPT engine launches
    the kernel once a layer a decode step, the slot engine never."""
    from galvatron_tpu_torch.serving import Engine

    kw = dict(vocab_size=384, hidden_size=256, num_layers=2, num_heads=4, ffn_dim=512,
              max_seq_len=128, dtype=torch.float32)
    if family == "gpt":
        kw.update(pos_embed="learned", norm_type="layernorm", act_fn="gelu", use_bias=True,
                  tie_word_embeddings=True)
    else:
        kw.update(num_kv_heads=2)
    cfg = modeling.ModelConfig(**kw)
    cpu_params = modeling.init_model_params(cfg, 0, "cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 384, (n,)).tolist() for n in (40, 7, 23)]
    outs = []
    for dev in ("cpu", "cuda"):
        before = fa.paged_decode_attention.launches
        with Engine(_to(cpu_params, dev), cfg, device=dev, num_slots=2, prefill_chunk=16,
                    kv_num_blocks=-1 if backend == "paged" else 0) as eng:
            outs.append(eng.generate(prompts, max_new_tokens=8))
            st = eng.stats()
        launches = fa.paged_decode_attention.launches - before
    assert outs[0] == outs[1]
    assert launches == (2 * st["decode_steps"] if backend == "paged" else 0)


FLASH_CASES = {
    # name: (dtype, b, h, kv_heads, s, d, stacked)
    "main_bf16_stacked": (torch.bfloat16, 2, 32, 32, 2048, 128, True),
    "ragged_s100_d64": (torch.bfloat16, 2, 4, 4, 100, 64, False),
    "gqa_rep4": (torch.bfloat16, 2, 32, 8, 512, 128, False),
    "fp32": (torch.float32, 1, 8, 8, 512, 128, True),
    "fp32_ragged_d40": (torch.float32, 1, 2, 2, 77, 40, False),
    "fp32_d256": (torch.float32, 1, 2, 1, 200, 256, False),
    # bf16 off the tensor-core head dims (64, 128): the CUDA-core kernels
    "bf16_ragged_d40": (torch.bfloat16, 1, 4, 2, 77, 40, False),
    "bf16_d256": (torch.bfloat16, 1, 2, 2, 130, 256, True),
    # the TMA path at ragged s: a last key tile partly past s, zero-filled
    "ragged_s1000_d128_stacked": (torch.bfloat16, 1, 8, 8, 1000, 128, True),
    "ragged_s2047_d64_stacked": (torch.bfloat16, 1, 4, 4, 2047, 64, True),
    "ragged_s2047_d128_gqa": (torch.bfloat16, 1, 8, 2, 2047, 128, False),
    "ragged_s1000_d64_gqa": (torch.bfloat16, 2, 8, 4, 1000, 64, False),
    "ragged_s100_d128_stacked": (torch.bfloat16, 2, 4, 4, 100, 128, True),
    # the TMA backward at head_dim 64 (128-row walked tiles)
    "d64_stacked_s1024": (torch.bfloat16, 2, 8, 8, 1024, 64, True),
    "gqa_rep4_d64": (torch.bfloat16, 2, 16, 4, 512, 64, False),
    # fp16 (the fp16 training path): at head_dim 64 / 128 the TMA route's
    # fp16 instances (.f16 wgmma), as bf16's cases above; off them the
    # CUDA-core kernels' __half instances
    "main_fp16_stacked": (torch.float16, 2, 32, 32, 2048, 128, True),
    "fp16_gqa_ragged_s1000_d64": (torch.float16, 1, 8, 2, 1000, 64, False),
    "fp16_ragged_s1000_d128_stacked": (torch.float16, 1, 8, 8, 1000, 128, True),
    "fp16_d64_stacked_s1024": (torch.float16, 2, 8, 8, 1024, 64, True),
    "fp16_gqa_rep4_d64": (torch.float16, 2, 16, 4, 512, 64, False),
    "fp16_ragged_d40": (torch.float16, 1, 4, 2, 77, 40, False),
}


def _blocked_route(dtype, d):
    """The route a blocked flash call with aligned operands takes: the TMA
    + wgmma kernels for bf16 and fp16 at head_dim 64 / 128, the CUDA-core
    kernels elsewhere."""
    return "tma" if dtype in (torch.bfloat16, torch.float16) and d in (64, 128) else "cuda_core"


def _flash_inputs(dtype, b, h, kvh, s, d, stacked, seed=0):
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, d)).astype(np.float32))
    qkv = qkv.to("cuda", dtype).permute(0, 2, 3, 1, 4)  # the projection's strided view
    if stacked:
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    else:
        q = qkv[:, 0]
        k, v = qkv[:, 1, :kvh].contiguous(), qkv[:, 2, :kvh].contiguous()
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2) / d))
    freqs = np.outer(np.arange(s), inv)
    cos = torch.from_numpy(np.cos(freqs).astype(np.float32)).cuda()
    sin = torch.from_numpy(np.sin(freqs).astype(np.float32)).cuda()
    do = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).to("cuda", dtype)
    return q, k, v, do, cos, sin


def _close(got, ref, which):
    """fp32: max abs error within 1e-5 (forward) or 1e-4 (backward). bf16:
    ``fa.bf16_parity_excess`` (the error beyond one output ulp, over the
    row's rms) within ``fa.BF16_PARITY_TOL``; fp16 the same with its ulp,
    ``fa.fp16_parity_excess`` within ``fa.FP16_PARITY_TOL``."""
    if got.dtype == torch.float32:
        return (got - ref).abs().max().item() <= {"fwd": 1e-5, "bwd": 1e-4}[which]
    if got.dtype == torch.float16:
        return fa.fp16_parity_excess(got, ref) <= fa.FP16_PARITY_TOL[which]
    return fa.bf16_parity_excess(got, ref) <= fa.BF16_PARITY_TOL[which]


def _dropped_tile_keep(s, device):
    """The causal mask with keys 0-63 dropped for the rows from
    max(64, s/2): a kernel that skipped that tile."""
    r = torch.arange(s, device=device)
    mask = r[:, None] >= r[None, :]
    mask[max(64, s // 2):, :64] = False
    return mask


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, case, monkeypatch):
    """flash_fwd / flash_bwd kernels against their plain versions on the
    same CUDA tensors, as in ``_close``; lse within 1e-5 (fp32) or 1e-4
    (16-bit: it is never rounded to 16 bits, only fp32 summation order
    differs); one launch each, on the route ``_blocked_route`` names. The
    plain versions with a key tile dropped must fail the same check."""
    dtype, b, h, kvh, s, d, stacked = FLASH_CASES[case]
    q, k, v, do, cos, sin = _flash_inputs(dtype, b, h, kvh, s, d, stacked)
    rep = h // kvh
    sm = 1.0 / math.sqrt(d)
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    want = _blocked_route(dtype, d)
    routes_before = (fa.flash_fwd.routes[want], fa.flash_bwd.routes[want])
    out, lse = fa.flash_fwd(q, k, v, cos, sin, sm, rep)
    grads = fa.flash_bwd(q, k, v, do, out, lse, cos, sin, sm, rep)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert (fa.flash_fwd.routes[want], fa.flash_bwd.routes[want]) == (routes_before[0] + 1,
                                                                      routes_before[1] + 1)
    ref_out, ref_lse = fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm, rep)
    assert _close(out, ref_out, "fwd")
    assert (lse - ref_lse).abs().max().item() <= (1e-5 if dtype == torch.float32 else 1e-4)
    kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    ref_grads = fa.flash_bwd_blocked_plain(q, kf, vf, do, out, lse, cos, sin, sm)
    for name, g, r in zip("qkv", grads, ref_grads):
        assert torch.isfinite(g).all(), name
        assert _close(g, r, "bwd"), name
    if want == "tma":  # query 0's dq is 0 exactly: its one key is itself
        assert (grads[0][:, :, 0] == 0).all()
    monkeypatch.setattr(fa, "_causal_keep", _dropped_tile_keep)
    assert not _close(fa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm, rep)[0], ref_out, "fwd")
    ctl = fa.flash_bwd_blocked_plain(q, kf, vf, do, out, lse, cos, sin, sm)
    for name, c, r in zip("qkv", ctl, ref_grads):
        assert not _close(c, r, "bwd"), name


def test_fp16_blocked_pair_takes_tma_and_the_other_kernels_keep_theirs(cuda):
    """At fp16 with operands a tensor map takes, head_dim 128: the blocked
    pair reports the TMA route (its fp16 mainloop instances), the grid
    kernels the CUDA-core route (their TMA route is bf16's), and every
    launch is counted as fp16, paged_decode's and the norms' too."""
    q, k, v, do, cos, sin = _flash_inputs(torch.float16, 1, 4, 4, 256, 128, True)
    blocked = (fa.flash_fwd, fa.flash_bwd)
    grid = (fa.flash_grid_fwd.routes, fa.flash_grid_bwd_parts.dkv_routes,
            fa.flash_grid_bwd_parts.dq_routes)
    before = [dict(w.routes) for w in blocked] + [dict(r) for r in grid]
    out, lse = fa.flash_fwd(q, k, v, cos, sin, 0.1)
    fa.flash_bwd(q, k, v, do, out, lse, cos, sin, 0.1)
    gout, glse = fa.flash_grid_fwd(q, k, v, None, 0.1, True)
    delta = (do.float() * gout.float()).sum(-1, keepdim=True).contiguous()
    grads = fa.flash_grid_bwd_parts(q, k, v, do, glse, delta, None, 0.1, True)
    torch.cuda.synchronize()
    assert gout.dtype == torch.float16 and all(g.dtype == torch.float16 for g in grads)
    for r, r0 in zip([w.routes for w in blocked], before):
        assert r == {"cuda_core": r0["cuda_core"], "tma": r0["tma"] + 1}
    for r, r0 in zip(grid, before[len(blocked):]):
        assert r == {"cuda_core": r0["cuda_core"] + 1, "tma": r0["tma"]}
    paged = fa.paged_decode_attention.dtypes["torch.float16"]
    out = fa.paged_decode_attention(*_case(cuda, torch.float16, 2, 8, 2, 128, 16, 8, [0, 100]))
    assert out.dtype == torch.float16
    assert fa.paged_decode_attention.dtypes["torch.float16"] == paged + 1
    norms = fn.dtype_counts()
    x = torch.randn(4, 256, device="cuda").half()
    g = torch.ones(256, device="cuda")
    y, rstd = fn.rms_fwd(x, g, 1e-5)
    fn.rms_bwd(x, g, rstd, x)
    y2, mu, rstd2 = fn.ln_fwd(x, g, g, 1e-5)
    fn.ln_bwd(x, g, mu, rstd2, x)
    torch.cuda.synchronize()
    assert y.dtype == y2.dtype == torch.float16
    assert {k: v["torch.float16"] - norms[k]["torch.float16"]
            for k, v in fn.dtype_counts().items()} == dict.fromkeys(norms, 1)


GRID_CASES = {
    # name: (dtype, b, h, kv_heads, s, d, causal, rope, stacked, out_fp32)
    "gpt_bf16_stacked": (torch.bfloat16, 2, 25, 25, 1024, 64, True, False, True, False),
    "noncausal_bf16": (torch.bfloat16, 2, 16, 16, 512, 64, False, False, False, False),
    "rope_past_envelope_d128": (torch.bfloat16, 1, 2, 2, 2048, 128, True, True, False, False),
    "gqa_rep4": (torch.bfloat16, 2, 16, 4, 512, 64, True, False, False, False),
    "out_fp32": (torch.bfloat16, 2, 8, 8, 512, 64, True, False, True, True),
    "ragged_noncausal_s100": (torch.bfloat16, 1, 4, 4, 100, 64, False, True, False, False),
    "fp32": (torch.float32, 1, 4, 4, 512, 64, True, False, True, False),
    "fp32_noncausal_rope_d40": (torch.float32, 1, 2, 2, 77, 40, False, True, False, False),
    # bf16 off the tensor-core head dims: the CUDA-core kernels
    "bf16_d40_rope": (torch.bfloat16, 1, 4, 2, 77, 40, True, True, False, False),
    # the dk/dv kernel's TMA route at both head dims, causal or not, with and
    # without RoPE (the pre-pass), stacked or contiguous, GQA, ragged s
    "noncausal_d128_stacked": (torch.bfloat16, 2, 8, 8, 512, 128, False, False, True, False),
    "causal_rope_d64_gqa": (torch.bfloat16, 2, 8, 2, 512, 64, True, True, False, False),
    "noncausal_rope_d128_stacked": (torch.bfloat16, 1, 4, 4, 384, 128, False, True, True, False),
    "causal_d128_gqa_ragged_s1000": (torch.bfloat16, 2, 8, 2, 1000, 128, True, False, False,
                                     False),
    # the encoders' attention: unmasked, no RoPE, the stacked projection
    # view; ViT's 196 (and 197) rows are ragged against the 64 / 128-row
    # tiles, so the keys past s must take no weight and the rows past s add
    # nothing to dk / dv; head_dim 80 (vit-huge) takes the CUDA-core kernels
    "encoder_vit_s196_d64": (torch.bfloat16, 4, 16, 16, 196, 64, False, False, True, False),
    "encoder_s197_d64": (torch.bfloat16, 2, 16, 16, 197, 64, False, False, True, False),
    "encoder_bert_s512_d64": (torch.bfloat16, 4, 16, 16, 512, 64, False, False, True, False),
    "encoder_vit_huge_s256_d80": (torch.bfloat16, 2, 16, 16, 256, 80, False, False, True,
                                  False),
    "encoder_s196_d80": (torch.bfloat16, 2, 16, 16, 196, 80, False, False, True, False),
    "encoder_s197_d80": (torch.bfloat16, 1, 4, 4, 197, 80, False, False, True, False),
    "encoder_fp32_s196_d80": (torch.float32, 1, 4, 4, 196, 80, False, False, True, False),
    # T5: t5-large's encoder (unmasked) and decoder self-attention (causal)
    # at (b, 16, 512, 64) in the stacked view, and t5-3b's 32 heads of
    # head_dim 32 (the CUDA-core kernels) both ways
    "t5_large_s512_d64": (torch.bfloat16, 4, 16, 16, 512, 64, False, False, True, False),
    "t5_large_causal_s512_d64": (torch.bfloat16, 4, 16, 16, 512, 64, True, False, True, False),
    "t5_3b_s512_d32": (torch.bfloat16, 2, 32, 32, 512, 32, False, False, True, False),
    "t5_3b_causal_s512_d32": (torch.bfloat16, 2, 32, 32, 512, 32, True, False, True, False),
    # fp16: the CUDA-core instances at every shape, the TMA route's head dims
    # and aligned views included (the route is chosen on the type)
    "gpt_fp16_stacked": (torch.float16, 2, 25, 25, 1024, 64, True, False, True, False),
    "noncausal_fp16": (torch.float16, 2, 16, 16, 512, 64, False, False, False, False),
    "rope_fp16_d128": (torch.float16, 1, 2, 2, 2048, 128, True, True, False, False),
    "gqa_rep4_fp16": (torch.float16, 2, 16, 4, 512, 64, True, False, False, False),
    "out_fp32_fp16": (torch.float16, 2, 8, 8, 512, 64, True, False, True, True),
    "ragged_noncausal_rope_s100_fp16": (torch.float16, 1, 4, 4, 100, 64, False, True, False,
                                        False),
    "encoder_s256_d80_fp16": (torch.float16, 2, 16, 16, 256, 80, False, False, True, False),
}


def _dropped_grid_keep(s, causal, device):
    """The grid mask with keys 0-63 dropped for the rows from max(64, s/2)."""
    r = torch.arange(s, device=device)
    mask = r[:, None] >= r[None, :] if causal else torch.ones(s, s, dtype=torch.bool,
                                                              device=device)
    mask[max(64, s // 2):, :64] = False
    return mask


def _grid_close(got, ref, which, dtype):
    """As ``_close``, by the input dtype: a bf16 (fp16) kernel writing fp32
    output still rounds p and ds to bf16 (fp16), so it is held to that
    type's rule."""
    if dtype == torch.float32:
        return (got - ref).abs().max().item() <= {"fwd": 1e-5, "bwd": 1e-4}[which]
    if dtype == torch.float16:
        return fa.fp16_parity_excess(got, ref) <= fa.FP16_PARITY_TOL[which]
    return fa.bf16_parity_excess(got, ref) <= fa.BF16_PARITY_TOL[which]


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_kernels_match_plain(cuda, case, monkeypatch):
    """flash_grid_fwd / flash_grid_bwd_parts kernels against their plain
    versions on the same CUDA tensors (lse within 1e-5 fp32, 1e-4 bf16);
    one launch of each kernel, each on the route its inputs call for (the
    TMA + wgmma kernels for bf16 at head_dim 64 / 128, the CUDA-core kernels
    elsewhere). The plain versions with a key tile dropped must fail the
    same check."""
    dtype, b, h, kvh, s, d, causal, rope, stacked, out_fp32 = GRID_CASES[case]
    q, k, v, do, cos, sin = _flash_inputs(dtype, b, h, kvh, s, d, stacked)
    rope = (cos, sin) if rope else None
    rep, sm = h // kvh, 1.0 / math.sqrt(d)
    out_dtype = torch.float32 if out_fp32 else None
    before = (fa.flash_grid_fwd.launches, fa.flash_grid_bwd_parts.dkv_launches,
              fa.flash_grid_bwd_parts.dq_launches)
    routes = (fa.flash_grid_fwd.routes, fa.flash_grid_bwd_parts.dkv_routes,
              fa.flash_grid_bwd_parts.dq_routes)
    routes_before = [dict(r) for r in routes]
    dtypes = (fa.flash_grid_fwd.dtypes, fa.flash_grid_bwd_parts.dkv_dtypes,
              fa.flash_grid_bwd_parts.dq_dtypes)
    dtypes_before = [d[str(dtype)] for d in dtypes]
    out, lse = fa.flash_grid_fwd(q, k, v, rope, sm, causal, rep, out_dtype)
    delta = (do.float() * out.float()).sum(-1, keepdim=True).contiguous()
    grads = fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, rope, sm, causal, rep)
    torch.cuda.synchronize()
    after = (fa.flash_grid_fwd.launches, fa.flash_grid_bwd_parts.dkv_launches,
             fa.flash_grid_bwd_parts.dq_launches)
    assert after == tuple(n + 1 for n in before)
    assert [d[str(dtype)] for d in dtypes] == [n + 1 for n in dtypes_before]
    want = "tma" if dtype == torch.bfloat16 and d in (64, 128) else "cuda_core"
    for name, r, r0 in zip(("forward", "dk/dv", "dq"), routes, routes_before):
        assert r == {x: r0[x] + (x == want) for x in fa.ROUTES}, name
    assert out.dtype == (out_dtype or dtype)
    ref_out, ref_lse = fa.flash_fwd_grid_plain(q, k, v, rope, sm, causal, rep, out_dtype)
    assert _grid_close(out, ref_out, "fwd", dtype)
    assert (lse - ref_lse).abs().max().item() <= (1e-5 if dtype == torch.float32 else 1e-4)
    kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    ref_grads = fa.flash_bwd_grid_plain(q, kf, vf, do, lse, delta, rope, sm, causal)
    for name, g, r in zip("qkv", grads, ref_grads):
        assert torch.isfinite(g).all(), name
        assert _grid_close(g, r, "bwd", dtype), name
    monkeypatch.setattr(fa, "_grid_keep", _dropped_grid_keep)
    ctl_out = fa.flash_fwd_grid_plain(q, k, v, rope, sm, causal, rep, out_dtype)[0]
    assert not _grid_close(ctl_out, ref_out, "fwd", dtype)
    ctl = fa.flash_bwd_grid_plain(q, kf, vf, do, lse, delta, rope, sm, causal)
    for name, c, r in zip("qkv", ctl, ref_grads):
        assert not _grid_close(c, r, "bwd", dtype), name


REPEAT_CASES = {
    # name: (family, dtype, b, h, kv_heads, s, d, causal, rope, stacked)
    "blocked_main_d128": ("blocked", torch.bfloat16, 2, 32, 32, 2048, 128, True, True, True),
    "blocked_gqa_d64": ("blocked", torch.bfloat16, 2, 16, 4, 1024, 64, True, True, False),
    "blocked_fp32": ("blocked", torch.float32, 1, 8, 8, 512, 128, True, True, True),
    "blocked_main_fp16_d128": ("blocked", torch.float16, 2, 32, 32, 2048, 128, True, True, True),
    "blocked_gqa_fp16_d64": ("blocked", torch.float16, 2, 16, 4, 1024, 64, True, True, False),
    "grid_gpt_d64": ("grid", torch.bfloat16, 2, 25, 25, 1024, 64, True, False, True),
    "grid_rope_noncausal_d128": ("grid", torch.bfloat16, 1, 8, 2, 512, 128, False, True, False),
    "grid_fp32": ("grid", torch.float32, 1, 4, 4, 512, 64, True, False, True),
}


@pytest.mark.parametrize("case", sorted(REPEAT_CASES))
def test_backward_kernels_repeat_bitwise_on_their_route(cuda, case):
    """Two calls of a backward wrapper on the same inputs give the same bits
    of dq, dk and dv (sums in registers over in-block loops, no atomics),
    and the call takes the route its inputs call for: the TMA + wgmma
    kernels with aligned operands at head_dim 64 / 128 for bf16 and, in the
    blocked pair, fp16; the CUDA-core kernels for fp32 (for the grid, the
    dk/dv and the dq kernel each). The forward reports its route the same
    way."""
    family, dtype, b, h, kvh, s, d, causal, rope, stacked = REPEAT_CASES[case]
    q, k, v, do, cos, sin = _flash_inputs(dtype, b, h, kvh, s, d, stacked)
    rep, sm = h // kvh, 1.0 / math.sqrt(d)
    want = (_blocked_route(dtype, d) if family == "blocked"
            else "tma" if dtype == torch.bfloat16 else "cuda_core")
    if family == "blocked":
        fwd_before = dict(fa.flash_fwd.routes)
        out, lse = fa.flash_fwd(q, k, v, cos, sin, sm, rep)
        assert fa.flash_fwd.routes[want] == fwd_before[want] + 1
        routes = fa.flash_bwd.routes

        def call():
            return fa.flash_bwd(q, k, v, do, out, lse, cos, sin, sm, rep)
    else:
        tables = (cos, sin) if rope else None
        fwd_before = dict(fa.flash_grid_fwd.routes)
        out, lse = fa.flash_grid_fwd(q, k, v, tables, sm, causal, rep)
        assert fa.flash_grid_fwd.routes[want] == fwd_before[want] + 1
        delta = (do.float() * out.float()).sum(-1, keepdim=True).contiguous()
        routes = fa.flash_grid_bwd_parts.dkv_routes
        dq_before = dict(fa.flash_grid_bwd_parts.dq_routes)

        def call():
            return fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, tables, sm, causal, rep)
    before = dict(routes)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert routes == {r: before[r] + (2 if r == want else 0) for r in fa.ROUTES}
    if family == "grid":
        assert fa.flash_grid_bwd_parts.dq_routes == {
            r: dq_before[r] + (2 if r == want else 0) for r in fa.ROUTES}
    for name, a, b_ in zip("qkv", first, second):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b_), name


@pytest.mark.parametrize("d,causal", [(128, True), (64, False)])
def test_grid_dq_reads_the_dkv_prepass_scratch(cuda, d, causal):
    """With RoPE, one ``flash_grid_bwd_parts`` call ropes q and k once: the
    dk/dv call's pre-pass writes the scratches the wrapper allocates and the
    dq kernel reads them, so a profiler window over the call holds one
    pre-pass, one dk/dv and one dq kernel, all on the TMA route; dq (and dk,
    dv) match the plain version."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do, cos, sin = _flash_inputs(torch.bfloat16, 2, 8, 2, 512, d, False, seed=3)
    rep, sm = 4, 1.0 / math.sqrt(d)
    out, lse = fa.flash_grid_fwd(q, k, v, (cos, sin), sm, causal, rep)
    delta = (do.float() * out.float()).sum(-1, keepdim=True).contiguous()
    fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, (cos, sin), sm, causal, rep)  # warm
    dq_before = dict(fa.flash_grid_bwd_parts.dq_routes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grads = fa.flash_grid_bwd_parts(q, k, v, do, lse, delta, (cos, sin), sm, causal, rep)
        torch.cuda.synchronize()
    assert fa.flash_grid_bwd_parts.dq_routes["tma"] == dq_before["tma"] + 1
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    count = {n: sum(n in name for name in names)
             for n in ("bwd::prepass_kernel", "bwd::dkdv_kernel", "bwd::dq_kernel")}
    assert count == dict.fromkeys(count, 1), names
    kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    ref = fa.flash_bwd_grid_plain(q, kf, vf, do, lse, delta, (cos, sin), sm, causal)
    for name, g, r in zip("qkv", grads, ref):
        assert _grid_close(g, r, "bwd", torch.bfloat16), name


@pytest.mark.parametrize("family,d", [("grid", 64), ("blocked", 128)])
def test_persistent_forward_repeats_and_zeroes_its_counter(cuda, family, d):
    """The TMA forward is persistent: its blocks take items from a counter
    that the last block zeroes again. Two calls on one stream, and one on a
    second stream (a counter of its own), give the same bits, and every
    counter is zero after them."""
    q, k, v, _, cos, sin = _flash_inputs(torch.bfloat16, 2, 8, 8, 1000, d, True, seed=4)
    sm = 1.0 / math.sqrt(d)
    if family == "grid":
        call = lambda: fa.flash_grid_fwd(q, k, v, None, sm, True)  # noqa: E731
        routes = fa.flash_grid_fwd.routes
    else:
        call = lambda: fa.flash_fwd(q, k, v, cos, sin, sm)  # noqa: E731
        routes = fa.flash_fwd.routes
    before = routes["tma"]
    first, second = call(), call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        third = call()
    torch.cuda.synchronize()
    assert routes["tma"] == before + 3
    for got in (second, third):
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
    assert all(int(w.abs().sum()) == 0 for w in fa._WORK.values())


def _small_cfg(family, **kw):
    """Small configs of the two families: LLaMA (blocked kernels; MHA or
    GQA by ``num_kv_heads``) and GPT (learned positions, LayerNorm, gelu,
    biases, tied head: the grid kernels)."""
    shape = dict(vocab_size=384, hidden_size=256, num_layers=2, num_heads=4, attn_impl="flash")
    if family == "gpt":
        return modeling.PRESETS["gpt-0.3b"].replace(**shape, **kw)
    return modeling.ModelConfig(ffn_dim=512, **shape, **kw)


def _path_launches(family):
    """The launch counter of the family's forward kernel."""
    return fa.flash_grid_fwd.launches if family == "gpt" else fa.flash_fwd.launches


def _norm_launches(family):
    """(forward, backward) launch counts of the family's norm kernels."""
    counts = fn.launch_counts()
    return (counts["ln_fwd"], counts["ln_bwd"]) if family == "gpt" else (
        counts["rms_fwd"], counts["rms_bwd"])


def _train_steps_match_cpu(family, **kw):
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    cfg = _small_cfg(family, max_seq_len=128, **kw)
    norms = (2 * cfg.num_layers + 1) * 2 if cfg.fused_norm else 0  # per two steps
    adam = AdamConfig(lr=1e-3, weight_decay=0.01)
    cpu_params = modeling.init_model_params(cfg, 0, "cpu")
    batches = [torch.from_numpy(np.random.RandomState(i).randint(0, 384, (2, 129)))
               for i in range(2)]
    losses = {}
    # the CPU run last: its state updates cpu_params in place
    for dev, precision in (("cuda", "fp32"), ("cuda", "bf16"), ("cpu", "fp32")):
        rt = build_runtime(cfg, adam=adam, global_batch_size=2, seq_len=128,
                           mixed_precision=precision, device=dev)
        state = rt.state_from(_to(cpu_params, dev))
        before, norm_before = _path_launches(family), _norm_launches(family)
        losses[dev, precision] = [float(rt.train_step(state, b)[1]) for b in batches]
        assert _path_launches(family) - before == (0 if dev == "cpu" else 2 * 2)
        assert [a - b for a, b in zip(_norm_launches(family), norm_before)] == [
            0 if dev == "cpu" else norms] * 2
    assert np.allclose(losses["cuda", "fp32"], losses["cpu", "fp32"], atol=1e-4, rtol=0)
    assert np.all(np.isfinite(losses["cuda", "bf16"]))


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_train_steps_on_card_match_cpu(cuda, kv_heads):
    """fp32 train steps through the flash kernels on the card (MHA: the
    stacked qkv view; GQA: the interleaved projection's k/v views) against
    the plain versions on the CPU, from the same weights and batches;
    bf16 on the card (the tensor-core kernels) stays finite."""
    _train_steps_match_cpu("llama", num_kv_heads=kv_heads)


def test_gpt_train_steps_on_card_match_cpu(cuda):
    """As above for GPT: q/k/v as views of the biased stacked projection
    through the grid kernels."""
    _train_steps_match_cpu("gpt")


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_fused_norm_train_steps_on_card_match_cpu(cuda, family):
    """As above with ``fused_norm=True``: every norm through the RMSNorm
    (llama) or LayerNorm (gpt) kernels, forward and backward, 2 x layers + 1
    launches of each a step."""
    _train_steps_match_cpu(family, fused_norm=True)


def _bf16_grads_match_plain(family, monkeypatch, **kw):
    from galvatron_tpu_torch.core.optim import tree_leaves

    cfg = _small_cfg(family, max_seq_len=256, dtype=torch.bfloat16, **kw)
    params = modeling.init_model_params(cfg, 0, "cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = torch.from_numpy(np.random.RandomState(0).randint(0, 384, (2, 257))).cuda()

    def step():
        loss = modeling.lm_loss(params, batch, cfg)
        loss.backward()
        grads = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return loss.item(), grads

    def worst(gs, refs):
        return max(((g - r).norm() / r.norm()).item() for g, r in zip(gs, refs))

    before = _path_launches(family)
    loss, grads = step()
    assert _path_launches(family) - before == 2
    if family == "gpt":
        monkeypatch.setattr(fa, "flash_grid_fwd", fa.flash_fwd_grid_plain)
        monkeypatch.setattr(fa, "flash_grid_bwd_parts", fa.flash_grid_bwd_parts_plain)
    else:
        monkeypatch.setattr(fa, "flash_fwd", fa.flash_fwd_blocked_plain)
        monkeypatch.setattr(fa, "flash_bwd", fa.flash_bwd_plain)
    if cfg.fused_norm:
        for name in ("rms_fwd", "rms_bwd", "ln_fwd", "ln_bwd"):
            monkeypatch.setattr(fn, name, getattr(fn, name + "_plain"))
    norm_before = fn.launch_counts()
    ref_loss, ref_grads = step()
    assert fn.launch_counts() == norm_before
    assert abs(loss - ref_loss) <= 1e-3
    assert worst(grads, ref_grads) <= 2 ** -5
    monkeypatch.setattr(fa, "_causal_keep", _dropped_tile_keep)
    assert worst(step()[1], ref_grads) > 2 ** -5


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_bf16_grads_through_kernels_match_plain_on_card(cuda, kv_heads, monkeypatch):
    """bf16 over fp32 masters (the tensor-core kernels at head_dim 64): the
    loss and every parameter gradient of one forward + backward through the
    kernels against the same step with the wrappers swapped for their plain
    versions on the card, so every other op is the same. The largest
    per-tensor relative gradient error stays under 2^-5; the plain versions
    with a key tile dropped exceed it."""
    _bf16_grads_match_plain("llama", monkeypatch, num_kv_heads=kv_heads)


def test_gpt_bf16_grads_through_kernels_match_plain_on_card(cuda, monkeypatch):
    """As above for GPT through the grid kernels."""
    _bf16_grads_match_plain("gpt", monkeypatch)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_fused_norm_bf16_grads_through_kernels_match_plain_on_card(cuda, family, monkeypatch):
    """As above with ``fused_norm=True``: the flash and the norm wrappers
    swapped for their plain versions give the reference step."""
    before = _norm_launches(family)
    _bf16_grads_match_plain(family, monkeypatch, fused_norm=True)
    assert [a - b for a, b in zip(_norm_launches(family), before)] == [2 * 2 + 1] * 2


NORM_CASES = {
    # name: (norm, dtype, rows, H)
    "rms_bf16_train": ("rms", torch.bfloat16, 4096, 4096),
    "ln_bf16_train": ("ln", torch.bfloat16, 4096, 2048),
    "rms_fp32": ("rms", torch.float32, 1000, 4096),
    "ln_fp32": ("ln", torch.float32, 1000, 2048),
    "rms_one_row": ("rms", torch.bfloat16, 1, 4096),
    "ln_four_rows_h128": ("ln", torch.bfloat16, 4, 128),
    "rms_h5120": ("rms", torch.bfloat16, 777, 5120),
    "ln_h7168_fp32": ("ln", torch.float32, 300, 7168),
    "ln_h8192": ("ln", torch.bfloat16, 300, 8192),
    "rms_h4096_fp16": ("rms", torch.float16, 1000, 4096),
    "ln_h2048_fp16": ("ln", torch.float16, 1000, 2048),
    "ln_h128_fp16": ("ln", torch.float16, 3000, 128),
}
# bf16 y / dx by fa.bf16_parity_excess (both sides round one fp32 value,
# computed with the row sum in another order: within one ulp); dscale / dbias
# by the largest error over the vector's rms (fp32 column sums in another
# order); the limits of chip_smoke.py's norm phase
NORM_BF16_TOL = 2 ** -10
NORM_FP16_TOL = 2 ** -13  # the same scaled to fp16's ulp
NORM_COLSUM_TOL = 1e-4


def _vec_err(got, ref):
    return ((got - ref).abs().max() / ref.square().mean().sqrt().clamp_min(1e-30)).item()


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_norm_kernels_match_plain(cuda, case):
    """rms_fwd / rms_bwd / ln_fwd / ln_bwd kernels against their plain
    versions on the same CUDA tensors: fp32 y and statistics within 1e-5, dx
    within 1e-4; bf16 (fp16) y and dx within ``NORM_BF16_TOL``
    (``NORM_FP16_TOL``); dscale and dbias
    within ``NORM_COLSUM_TOL``; one launch each, and the same bits on a
    second launch (no atomics). The plain column sums with the first rows
    left out must fail the same check."""
    norm, dtype, n, h = NORM_CASES[case]
    rng = np.random.RandomState(0)
    x32 = torch.from_numpy((rng.standard_normal((n, h)) * 1.5 + 0.3).astype(np.float32)).cuda()
    dy = (torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)).cuda()
          + 0.5 * x32).to(dtype)
    x = x32.to(dtype)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(h)).astype(np.float32)).cuda()
    b = torch.from_numpy((0.1 * rng.standard_normal(h)).astype(np.float32)).cuda()
    if norm == "rms":
        fwd, plain_fwd = (lambda: fn.rms_fwd(x, g, 1e-5)), (lambda: fn.rms_fwd_plain(x, g, 1e-5))
        bwd, plain_bwd = fn.rms_bwd, fn.rms_bwd_plain
    else:
        fwd = lambda: fn.ln_fwd(x, g, b, 1e-5)  # noqa: E731
        plain_fwd = lambda: fn.ln_fwd_plain(x, g, b, 1e-5)  # noqa: E731
        bwd, plain_bwd = fn.ln_bwd, fn.ln_bwd_plain
    before = _norm_launches("gpt" if norm == "ln" else "llama")
    y, *stats = fwd()
    dx, *dvecs = bwd(x, g, *stats, dy)
    again = bwd(x, g, *stats, dy)
    torch.cuda.synchronize()
    after = _norm_launches("gpt" if norm == "ln" else "llama")
    assert (after[0] - before[0], after[1] - before[1]) == (1, 2)
    for a, b_ in zip((dx, *dvecs), again):
        assert torch.equal(a, b_)
    ref_y, *ref_stats = plain_fwd()
    ref_dx, *ref_dvecs = plain_bwd(x, g, *stats, dy)
    for a, r in zip(stats, ref_stats):
        assert (a - r).abs().max().item() <= 1e-5
    if dtype == torch.float32:
        assert (y - ref_y).abs().max().item() <= 1e-5
        assert (dx - ref_dx).abs().max().item() <= 1e-4
    elif dtype == torch.float16:
        assert fa.fp16_parity_excess(y, ref_y) <= NORM_FP16_TOL
        assert fa.fp16_parity_excess(dx, ref_dx) <= NORM_FP16_TOL
    else:
        assert fa.bf16_parity_excess(y, ref_y) <= NORM_BF16_TOL
        assert fa.bf16_parity_excess(dx, ref_dx) <= NORM_BF16_TOL
    strip = max(1, n // 256)
    _, *strip_vecs = plain_bwd(x[:strip], g, *[t[:strip] for t in stats], dy[:strip])
    for a, r, sv in zip(dvecs, ref_dvecs, strip_vecs):
        assert torch.isfinite(a).all()
        assert _vec_err(a, r) <= NORM_COLSUM_TOL
        assert _vec_err(r - sv, r) > NORM_COLSUM_TOL


def test_norm_wrappers_raise_on_the_card_for_what_the_kernels_do_not_take(cuda):
    """No quiet other path on the card: a width past the kernels' reach, a
    misaligned view and an fp64 row raise."""
    g = torch.ones(8320, device="cuda")
    with pytest.raises(ValueError, match="8192"):
        fn.rms_fwd(torch.zeros(4, 8320, device="cuda"), g, 1e-5)
    with pytest.raises(TypeError):
        fn.rms_fwd(torch.zeros(4, 128, device="cuda", dtype=torch.float64), g[:128], 1e-5)
    flat = torch.zeros(4 * 128 + 4, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fn.rms_fwd(flat[4:].view(4, 128), torch.ones(128, device="cuda"), 1e-5)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_two_ranks_sharing_the_card_over_gloo_train_like_one(cuda, tmp_path):
    """Two ``cli train`` ranks on card 0 (LOCAL_RANK 0 each) over gloo, a
    plan that changes its DP degree at every boundary (TP + SP, zero3 under
    full recompute, selective, zero2; vocab TP), fp32: the losses of 3 steps
    match the same layers' plan at world size 1 on the card."""
    import os
    import sys
    from pathlib import Path

    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig, LayerStrategy
    from galvatron_tpu_torch.parallel.launch import launch_local
    from galvatron_tpu_torch.utils.metrics import read_metrics

    root = Path(__file__).resolve().parents[1]
    ckpt = ["none", "full", "selective", "none"]
    plans = {
        1: HybridParallelConfig(layer_strategies=[LayerStrategy(ckpt=c) for c in ckpt],
                                mixed_precision="fp32"),
        2: HybridParallelConfig(layer_strategies=[
            LayerStrategy(tp=2, sp=True), LayerStrategy(dp_type="zero3", ckpt="full"),
            LayerStrategy(tp=2, ckpt="selective"), LayerStrategy(dp_type="zero2")],
            vocab_tp=2, mixed_precision="fp32"),
    }
    losses = {}
    for world, hp in plans.items():
        plan, metrics = tmp_path / f"plan{world}.json", tmp_path / f"m{world}.jsonl"
        hp.save(str(plan))
        argv = ["train", "--num_layers", "4", "--hidden_size", "256", "--num_heads", "2",
                "--ffn_dim", "512", "--vocab_size", "256", "--seq_length", "256",
                "--global_train_batch_size", "4", "--train_iters", "3",
                "--galvatron_config_path", str(plan), "--metrics_path", str(metrics)]
        if world == 1:
            assert cli.main(argv) == 0
        else:
            ranks = launch_local(
                [sys.executable, "-m", "galvatron_tpu_torch.cli", *argv, "--dist_backend",
                 "gloo"], 2, timeout_s=300, local_ranks=[0, 0], cwd=str(root),
                env=dict(os.environ, PYTHONPATH=str(root)))
            assert all(r.returncode == 0 for r in ranks), [r.output[-2000:] for r in ranks]
        losses[world] = [r["loss"] for r in read_metrics(str(metrics))
                         if r["event"] == "train_iter"]
    assert len(losses[2]) == 3
    np.testing.assert_allclose(losses[2], losses[1], atol=1e-4, rtol=0)
