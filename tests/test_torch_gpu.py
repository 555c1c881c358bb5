"""Card-side checks of the port (marker ``gpu``): the hand-written paged
decode kernel against its plain PyTorch version on the same CUDA tensors,
and the engine on the card against the engine on the CPU. Each test skips,
with its reason, where ``torch.cuda.is_available()`` is false; run them on
the card with ``python -m pytest tests/test_torch_gpu.py -m gpu``."""

import math

import numpy as np
import pytest
import torch

from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.ops import flash_attention as fa

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


@pytest.mark.parametrize("n,kv,d", [(32, 32, 128), (32, 8, 128), (8, 2, 64), (4, 4, 256)])
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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
