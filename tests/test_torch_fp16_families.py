"""fp16 on every family the port trains: 5-step trajectories of the port's
runtime at pp = 1 against the JAX package's flat fp16 ``build_runtime`` on a
one-device mesh, from the same weights (``bridge``), at
``tests/test_torch_fp16.py``'s tiny shape: GPT (gelu), OPT (relu) with
``fused_norm``, BERT (masked LM), ViT (classification) with ``fused_norm``,
T5, Baichuan's ALiBi, LLaMA with ``fused_norm`` and Swin with
``fused_norm``. The ``fused_norm`` cases run at width 128, so that the
norms pass the kernels' ``H % 128`` gate; attention takes the flash entries
(the grid kernels, or LLaMA's blocked ones; ALiBi and Swin's window
attention are einsums in both packages). Losses are held to 5e-3 relative,
the loss scale, the clean-step count and the skipped steps bitwise (Swin's
second step overflows at 2^16 in both packages and is skipped); and the
port's run must have reached the fp16 kernels' plain versions its family's
path runs through."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.core import checkpoint as jck
from galvatron_tpu.core import optim as jopt
from galvatron_tpu.core.strategy import HybridParallelConfig as JHP
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.parallel import hybrid as jhybrid
from galvatron_tpu.parallel.mesh import build_mesh
from galvatron_tpu_torch import bridge
from galvatron_tpu_torch.core import optim as topt
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.ops import flash_attention as tfa
from galvatron_tpu_torch.ops import fused_norm as fn
from galvatron_tpu_torch.parallel import hybrid as thybrid
from test_torch_fp16 import (ADAM, LOSS_RTOL, SHAPE, STEPS, _assert_same_trajectory,
                             _jax_flat)
import _torch_threads  # noqa: F401

_GPT = dict(use_bias=True, pos_embed="learned", norm_type="layernorm", tie_word_embeddings=True)
_VISION = dict(vocab_size=1, max_seq_len=0, pos_embed="learned", norm_type="layernorm",
               act_fn="gelu", causal=False, objective="cls", num_classes=16)
#: family -> (model shape, the plain kernel versions its fp16 run must reach)
FAMILIES = {
    "gpt_gelu": (dict(SHAPE, **_GPT, act_fn="gelu", attn_impl="flash"), ("grid",)),
    "opt_relu_fused": (dict(SHAPE, **_GPT, act_fn="relu", attn_impl="flash", fused_norm=True,
                            hidden_size=128), ("grid", "ln")),
    "bert_mlm": (dict(SHAPE, **_GPT, act_fn="gelu", causal=False, objective="mlm",
                      attn_impl="flash"), ("grid",)),
    "vit_cls_fused": (dict(SHAPE, **_VISION, hidden_size=128, image_size=16, patch_size=4,
                           attn_impl="flash", fused_norm=True), ("grid", "ln")),
    "t5": (dict(SHAPE, max_seq_len=16, enc_layers=2, enc_seq=16, pos_embed="learned",
                act_fn="gelu", tie_word_embeddings=True, attn_impl="flash"), ("grid",)),
    "baichuan_alibi": (dict(SHAPE, pos_embed="alibi", attn_impl="flash"), ()),
    "llama_fused": (dict(SHAPE, hidden_size=128, ffn_dim=256, attn_impl="flash",
                         fused_norm=True), ("blocked", "rms")),
    "swin_fused": (dict(_VISION, hidden_size=128, num_layers=4, num_heads=2, image_size=16,
                        patch_size=2, swin_depths=(2, 2), swin_window=4, fused_norm=True),
                   ("ln",)),
}
#: the plain versions a kernel family's wrappers run on CPU tensors
PLAIN = {"grid": (tfa, "flash_fwd_grid_plain"), "blocked": (tfa, "flash_fwd_blocked_plain"),
         "ln": (fn, "ln_fwd_plain"), "rms": (fn, "rms_fwd_plain")}


def _batches(cfg, seed=0):
    """Token rows, or pixels ‖ label rows of a vision model."""
    rng = np.random.RandomState(seed)
    if cfg.image_size:
        return [np.concatenate([rng.randint(0, 256, (8, cfg.sample_len)),
                                rng.randint(0, cfg.num_classes, (8, 1))], 1).astype(np.int32)
                for _ in range(STEPS)]
    return [rng.randint(0, 128, (8, cfg.sample_len + 1)).astype(np.int32) for _ in range(STEPS)]


def jax_fp16_trajectory(shape, batches, params=None):
    """(initial flat state, per-step records) of the JAX package's pp = 1
    fp16 runtime on one device for the model ``shape``, from ``params``
    (numpy leaves) or its own ``key(0)`` init; the batch is the batches'
    rows. The gloo worlds hold their fp16 entries to it too."""
    jcfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    hp = JHP.uniform(jcfg.total_layers, mixed_precision="fp16")
    mesh, axes = build_mesh(pp=1, devices=jax.devices()[:1])
    rt = jhybrid.build_runtime(jcfg, hp, mesh=mesh, axes=axes, adam=jopt.AdamConfig(**ADAM),
                               global_batch_size=len(batches[0]),
                               seq_len=jcfg.max_seq_len or None)
    state = (rt.init_state(jax.random.key(0)) if params is None
             else rt.init_state_from(jax.tree.map(jnp.asarray, params)))
    start = _jax_flat(jck.portable_flat_state(state, rt))
    recs = []
    for b in batches:
        count = int(state["opt"]["count"])
        state, loss = rt.train_step(state, jnp.asarray(b))
        recs.append(_rec(float(loss), state["scaler"], count == int(state["opt"]["count"])))
    return start, recs


def assert_follows_jax_fp16(losses, scale, recs):
    """A world's fp16 entry against :func:`jax_fp16_trajectory`: its step
    losses within ``LOSS_RTOL`` relative, its final loss scale bitwise."""
    np.testing.assert_allclose(losses, [r["loss"] for r in recs], rtol=LOSS_RTOL)
    assert scale == recs[-1]["scale"]


def _rec(loss, scaler, skipped):
    return {"loss": loss, "scale": float(scaler["scale"]),
            "good_steps": int(scaler["good_steps"]), "skipped": bool(skipped)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fp16_trajectory_matches_jax(family, monkeypatch):
    shape, kernels = FAMILIES[family]
    jcfg = jm.ModelConfig(dtype=jnp.float32, **shape)
    tcfg = tm.ModelConfig(dtype=torch.float32, **shape)
    batches = _batches(jcfg)
    start, want = jax_fp16_trajectory(shape, batches)
    fp16_calls = dict.fromkeys(PLAIN, 0)

    def spy(kind, plain):
        def counted(x, *args, **kw):
            fp16_calls[kind] += x.dtype == torch.float16
            return plain(x, *args, **kw)
        return counted

    for kind, (module, name) in PLAIN.items():
        monkeypatch.setattr(module, name, spy(kind, getattr(module, name)))
    rt = thybrid.build_runtime(tcfg, adam=topt.AdamConfig(**ADAM), global_batch_size=8,
                               seq_len=tcfg.max_seq_len or None, mixed_precision="fp16",
                               device="cpu")
    assert rt.cfg.dtype == torch.float16
    state = bridge.state_from_jax(start, rt)
    got = []
    for b in batches:
        state, loss = rt.train_step(state, torch.from_numpy(b.astype(np.int64)))
        got.append(_rec(float(loss), state["scaler"], not rt.stats["updated"]))
    assert np.isfinite([r["loss"] for r in got]).all()
    _assert_same_trajectory(got, want)  # Swin's second step overflows in both packages
    assert {k for k, n in fp16_calls.items() if n} == set(kernels), fp16_calls

