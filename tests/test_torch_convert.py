"""HuggingFace import and export in the port against the JAX package's
(``tests/test_convert.py``'s cases) and against ``transformers`` and
``safetensors`` themselves, at fp32 on the CPU.

Every HF model is built inside a test from a config and seeded weights;
``from_pretrained`` only ever loads a directory a test wrote. Import: the
port's ``from_hf_*`` equals the JAX ``from_hf_*`` (through
``bridge.params_from_jax``) bitwise, and the port's logits are within 1e-4
of the HF torch forward (the JAX test holds 2e-4). The runtime cases
(GSPMD-style tp + zero3, GPipe, 1F1B, interleaved; OPT, GPT-2 and an ALiBi
Baichuan checkpoint under tp 2; ``cli train --load_hf`` at tp 2) run in one
4-rank gloo world (``parallel/launch.py``), their eval losses held to the HF
(or the Baichuan reference) cross entropy within the JAX test's 2e-4.
Export: ``cli export-hf`` of both packages, loaded by ``from_pretrained``,
gives bitwise-equal state dicts and equal logits. The port's safetensors
reader and writer are held to the ``safetensors`` library both ways, and a
minimal ``config.json`` per family to ``AutoConfig`` followed by the JAX
``config_from_hf_*``.

Run as a script (``python tests/test_torch_convert.py worker CASES OUT``)
this file is one rank of the world; that path imports neither JAX nor
``transformers``.
"""

import contextlib
import io
import json
import os
import pickle
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
WORLD_TIMEOUT_S = 600
#: port logits against the HF torch forward, fp32
LOGIT_TOL = 1e-4
#: runtime eval losses against the HF cross entropy (the JAX test's)
LOSS_TOL = 2e-4
BATCH, SEQ = 8, 16


def _tf():
    return pytest.importorskip("transformers")


def _tiny_hf(num_kv_heads=4, n_layers=2, seed=0):
    tf = _tf()
    cfg = tf.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=112,
                         num_hidden_layers=n_layers, num_attention_heads=4,
                         num_key_value_heads=num_kv_heads, max_position_embeddings=64,
                         rms_norm_eps=1e-6)
    torch.manual_seed(seed)
    return tf.LlamaForCausalLM(cfg).eval()


def _opt_hf(seed=3):
    tf = _tf()
    cfg = tf.OPTConfig(hidden_size=48, num_hidden_layers=2, num_attention_heads=4, ffn_dim=96,
                       vocab_size=96, max_position_embeddings=32, word_embed_proj_dim=48,
                       activation_function="relu")
    torch.manual_seed(seed)
    return tf.OPTForCausalLM(cfg).eval()


def _gpt2_hf(seed=2):
    tf = _tf()
    cfg = tf.GPT2Config(vocab_size=96, n_embd=48, n_layer=2, n_head=4, n_positions=32)
    torch.manual_seed(seed)
    return tf.GPT2LMHeadModel(cfg).eval()


def _f32(cfg):
    return cfg.replace(dtype=torch.float32, attn_impl="xla")


def _assert_same_params(jax_params, port_params, tcfg):
    """The JAX import (numpy, through the bridge) equals the port's, bitwise."""
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core.checkpoint import flatten

    want = flatten(bridge.params_from_jax(jax_params, _f32(tcfg), "cpu"))
    got = flatten(port_params)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _import_parity(hf, jfrom, jconfig, tfrom, tconfig, tokens):
    """Both packages' importers on one in-memory HF model: bitwise equal
    trees, and the port's fp32 logits within LOGIT_TOL of HF's."""
    import jax

    from galvatron_tpu_torch.models import modeling as tm

    jcfg = jconfig(hf.config)
    tcfg = _f32(tconfig(hf.config))
    jp = jax.tree.map(np.asarray, jfrom(hf, jcfg))
    tp = tfrom(hf, tcfg)
    _assert_same_params(jp, tp, tcfg)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)).logits.numpy()
        ours = tm.forward(tp, torch.tensor(tokens), tcfg).numpy()
    np.testing.assert_allclose(ours, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    return tp, tcfg


def _llama_parity(hf):
    from galvatron_tpu.models import convert as jc
    from galvatron_tpu_torch.models import convert as tc

    tokens = np.random.RandomState(0).randint(0, 128, (2, 16))
    return _import_parity(hf, jc.from_hf_llama, jc.config_from_hf_llama, tc.from_hf_llama,
                          tc.config_from_hf_llama, tokens)


def test_hf_llama_logit_parity_mha():
    _llama_parity(_tiny_hf(num_kv_heads=4))


def test_hf_llama_logit_parity_gqa():
    """GQA (kv_heads < heads) exercises the interleaved fused-QKV packing."""
    _llama_parity(_tiny_hf(num_kv_heads=2))


def test_load_hf_llama_roundtrip(tmp_path):
    """``save_pretrained`` → the port's loader: the model shape from
    ``config.json``, the weights equal to the JAX loader's (which goes
    through ``from_pretrained``) bitwise."""
    import jax

    from galvatron_tpu.models.convert import load_hf_llama as j_load
    from galvatron_tpu_torch.models.convert import load_hf_llama

    hf = _tiny_hf()
    hf.save_pretrained(tmp_path / "ckpt")
    params, cfg = load_hf_llama(str(tmp_path / "ckpt"))
    assert cfg.hidden_size == 64 and cfg.num_layers == 2
    assert tuple(params["layers"][0]["attn"]["wqkv"].shape) == (64, 3, 64)
    jp, jcfg = j_load(str(tmp_path / "ckpt"))
    assert (cfg.norm_eps, cfg.kv_heads, cfg.max_seq_len) == (jcfg.norm_eps, jcfg.kv_heads,
                                                             jcfg.max_seq_len)
    _assert_same_params(jax.tree.map(np.asarray, jp), params, cfg)


def test_load_hf_rejects_unsupported_arch(tmp_path):
    tf = _tf()
    from galvatron_tpu_torch.models.convert import load_hf_llama

    bloom = tf.BloomForCausalLM(tf.BloomConfig(hidden_size=32, n_layer=1, n_head=2,
                                               vocab_size=64))
    bloom.save_pretrained(tmp_path / "bloom")
    with pytest.raises(ValueError, match="LLaMA-architecture"):
        load_hf_llama(str(tmp_path / "bloom"))


def test_hf_opt_logit_parity():
    """OPT import: separate-q/k/v packing, +2 position offset sliced off the
    table, ReLU MLP."""
    from galvatron_tpu.models import convert as jc
    from galvatron_tpu_torch.models import convert as tc

    tokens = np.random.RandomState(3).randint(0, 96, (2, 16))
    _import_parity(_opt_hf(), jc.from_hf_opt, jc.config_from_hf_opt, tc.from_hf_opt,
                   tc.config_from_hf_opt, tokens)


def test_hf_gpt2_logit_parity():
    """GPT-2 import: biases and the blocked c_attn mapping."""
    from galvatron_tpu.models import convert as jc
    from galvatron_tpu_torch.models import convert as tc

    tokens = np.random.RandomState(2).randint(0, 96, (2, 16))
    _import_parity(_gpt2_hf(), jc.from_hf_gpt2, jc.config_from_hf_gpt2, tc.from_hf_gpt2,
                   tc.config_from_hf_gpt2, tokens)


def test_to_hf_gpt2_roundtrip():
    """Export half of the GPT-2 round trip: the port's params → HF state
    dict (equal to the JAX ``to_hf_gpt2``'s, bitwise) → a fresh
    GPT2LMHeadModel reproduces the source model's logits."""
    import jax

    from galvatron_tpu.models import convert as jc
    from galvatron_tpu_torch.models import convert as tc

    tf = _tf()
    hf = _gpt2_hf(seed=4)
    tcfg = _f32(tc.config_from_hf_gpt2(hf.config))
    params = tc.from_hf_gpt2(hf, tcfg)
    sd = tc.to_hf_gpt2(params, tcfg)
    jcfg = jc.config_from_hf_gpt2(hf.config)
    jsd = jc.to_hf_gpt2(jax.tree.map(np.asarray, jc.from_hf_gpt2(hf, jcfg)), jcfg)
    assert sorted(sd) == sorted(jsd) and all(np.array_equal(sd[k], jsd[k]) for k in sd)
    hf2 = tf.GPT2LMHeadModel(hf.config).eval()
    missing, unexpected = hf2.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                                              strict=False)
    assert not unexpected, unexpected
    assert all("attn.bias" in m or "masked_bias" in m for m in missing), missing
    tokens = torch.tensor(np.random.RandomState(4).randint(0, 96, (2, 16)))
    with torch.no_grad():
        np.testing.assert_allclose(hf(tokens).logits.numpy(), hf2(tokens).logits.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_rejects_rope_scaling_and_biases():
    tf = _tf()
    from galvatron_tpu_torch.models.convert import config_from_hf_llama

    cfg = tf.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=2,
                         rope_scaling={"rope_type": "linear", "factor": 2.0})
    with pytest.raises(ValueError, match="rope_scaling"):
        config_from_hf_llama(cfg)
    cfg2 = tf.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=2, attention_bias=True)
    with pytest.raises(ValueError, match="bias"):
        config_from_hf_llama(cfg2)


@pytest.mark.parametrize("kv", [4, 2])
def test_to_hf_llama_roundtrip(kv):
    """Export: a perturbed tree loads into a fresh LlamaForCausalLM and
    reproduces the port's logits (blocked and GQA-interleaved unpacking);
    the state dict equals the JAX ``to_hf_llama``'s bitwise."""
    from galvatron_tpu.models import convert as jc
    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.models import convert as tc
    from galvatron_tpu_torch.models import modeling as tm

    hf = _tiny_hf(num_kv_heads=kv)
    tcfg = _f32(tc.config_from_hf_llama(hf.config))
    params = tc.from_hf_llama(hf, tcfg)
    params["layers"][0]["attn"]["wo"] = params["layers"][0]["attn"]["wo"] + 0.01
    sd = tc.to_hf_llama(params, tcfg)
    jcfg = jc.config_from_hf_llama(hf.config)
    jsd = jc.to_hf_llama(bridge.params_to_numpy(params), jcfg)
    assert sorted(sd) == sorted(jsd) and all(np.array_equal(sd[k], jsd[k]) for k in sd)
    hf2 = _tiny_hf(num_kv_heads=kv)
    hf2.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    tokens = torch.tensor(np.random.RandomState(4).randint(0, 128, (2, 12)))
    with torch.no_grad():
        ref = hf2(tokens).logits.numpy()
        ours = tm.forward(params, tokens, tcfg).numpy()
    np.testing.assert_allclose(ours, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_cli_export_hf(tmp_path, capsys):
    """``cli train --save`` → ``cli export-hf --load`` → the directory
    loads back through ``--load_hf``'s loader (and ``from_pretrained``) with
    the trained weights."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.checkpoint import flatten, restore_raw_checkpoint
    from galvatron_tpu_torch.models.convert import load_hf_checkpoint

    save = str(tmp_path / "ckpt")
    args = ["--device", "cpu", "--model_size", "llama-0.3b", "--hidden_size", "64",
            "--num_layers", "2", "--num_heads", "4", "--ffn_dim", "112", "--vocab_size", "128",
            "--seq_length", "16"]
    assert cli.main(["train", *args, "--global_train_batch_size", "8", "--train_iters", "2",
                     "--mixed_precision", "fp32", "--save", save]) == 0
    out_dir = str(tmp_path / "hf")
    assert cli.main(["export-hf", *args, "--load", save, "--output_dir", out_dir]) == 0
    assert "exported HF checkpoint" in capsys.readouterr().out
    params, cfg = load_hf_checkpoint(out_dir)
    assert cfg.hidden_size == 64 and cfg.num_layers == 2
    raw, _ = restore_raw_checkpoint(save)
    trained = flatten(raw["params"])
    for k, v in flatten(params).items():
        assert torch.equal(v, trained[k].float()), k
    assert cli.main(["export-hf", *args]) == 2  # no --output_dir


# ---------------------------------------------------------------------------
# Baichuan (no transformers class: tests/test_convert.py's reference forward)
# ---------------------------------------------------------------------------


def _baichuan_ref():
    from test_convert import make_baichuan_sd, torch_baichuan_forward

    return make_baichuan_sd, torch_baichuan_forward


def _baichuan_config(alibi):
    ns = dict(model_type="baichuan", vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=112, rms_norm_eps=1e-6,
              tie_word_embeddings=False)
    ns["model_max_length" if alibi else "max_position_embeddings"] = 64
    return ns


def _baichuan_parity(alibi, seed):
    from types import SimpleNamespace

    import jax

    from galvatron_tpu.models import convert as jc
    from galvatron_tpu_torch.models import convert as tc
    from galvatron_tpu_torch.models import modeling as tm

    make_sd, ref_forward = _baichuan_ref()
    hf_cfg = SimpleNamespace(**_baichuan_config(alibi))
    tcfg = _f32(tc.config_from_hf_baichuan(hf_cfg))
    assert tcfg.pos_embed == ("alibi" if alibi else "rope")
    sd = make_sd(seed, 128, 64, 2, 112)
    params = tc.from_hf_baichuan(sd, tcfg)
    jp = jax.tree.map(np.asarray, jc.from_hf_baichuan(sd, jc.config_from_hf_baichuan(hf_cfg)))
    _assert_same_params(jp, params, tcfg)
    tokens = np.random.RandomState(seed).randint(0, 128, (2, 16))
    with torch.no_grad():
        ref = ref_forward(sd, tokens, 4, 2, alibi)
        ours = tm.forward(params, torch.tensor(tokens), tcfg).numpy()
    np.testing.assert_allclose(ours, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_hf_baichuan7b_logit_parity_rotary():
    _baichuan_parity(alibi=False, seed=7)


def test_hf_baichuan13b_logit_parity_alibi():
    """13B-style ALiBi: the relative slope bias against the published
    absolute-position form (softmax-shift-invariant)."""
    _baichuan_parity(alibi=True, seed=13)


def test_load_hf_baichuan_sharded_safetensors_rotary(tmp_path):
    """A SHARDED safetensors checkpoint (index + two shards, written by the
    ``safetensors`` library) with a 7B-style rotary config: the port's
    loader matches the torch reference."""
    from safetensors.numpy import save_file

    from galvatron_tpu_torch.models import modeling as tm
    from galvatron_tpu_torch.models.convert import load_hf_checkpoint

    make_sd, ref_forward = _baichuan_ref()
    d = tmp_path / "bc7b"
    d.mkdir()
    sd = make_sd(9, 128, 64, 2, 112)
    names = sorted(sd)
    half = len(names) // 2
    weight_map = {}
    for fn, keys in (("model-00001-of-00002.safetensors", names[:half]),
                     ("model-00002-of-00002.safetensors", names[half:])):
        save_file({k: sd[k].numpy() for k in keys}, str(d / fn))
        weight_map.update({k: fn for k in keys})
    (d / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    (d / "config.json").write_text(json.dumps(_baichuan_config(alibi=False)))
    params, cfg = load_hf_checkpoint(str(d))
    assert cfg.pos_embed == "rope"
    tokens = np.random.RandomState(9).randint(0, 128, (2, 16))
    with torch.no_grad():
        ref = ref_forward(sd, tokens, 4, 2, alibi=False)
        ours = tm.forward(params, torch.tensor(tokens), _f32(cfg)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_baichuan2_rejected():
    from types import SimpleNamespace

    from galvatron_tpu_torch.models.convert import config_from_hf_baichuan

    with pytest.raises(ValueError, match="Baichuan-2"):
        config_from_hf_baichuan(SimpleNamespace(
            vocab_size=125696, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=112, model_max_length=64))
    with pytest.raises(ValueError, match="neither max_position_embeddings"):
        config_from_hf_baichuan(SimpleNamespace(
            vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=112))


# ---------------------------------------------------------------------------
# files: safetensors both ways, config.json defaults, the state-dict keys
# ---------------------------------------------------------------------------


def _tensors(seed):
    rng = np.random.RandomState(seed)
    return {"a.f32": rng.randn(3, 5).astype(np.float32),
            "b.f16": rng.randn(7).astype(np.float16),
            "c.i64": rng.randint(-2 ** 40, 2 ** 40, (2, 2)).astype(np.int64),
            "d.bf16": torch.from_numpy(rng.randn(4, 3).astype(np.float32)).to(torch.bfloat16),
            "e.scalar": np.asarray(1.5, np.float32)}


def _as_f32(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else v


def test_safetensors_reader_reads_the_library_files(tmp_path):
    """Files written by ``safetensors`` (F32 / F16 / I64 from numpy, BF16
    from torch), sharded with an index: the port's reader gives the same
    values (BF16 widened exactly)."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    from galvatron_tpu_torch.models import hf_io

    t = _tensors(0)
    save_file({k: v for k, v in t.items() if not isinstance(v, torch.Tensor)},
              str(tmp_path / "model-00001-of-00002.safetensors"), metadata={"format": "np"})
    save_torch({"d.bf16": t["d.bf16"]}, str(tmp_path / "model-00002-of-00002.safetensors"),
               metadata={"format": "pt"})
    weight_map = {k: "model-00002-of-00002.safetensors" if k == "d.bf16"
                  else "model-00001-of-00002.safetensors" for k in t}
    (tmp_path / hf_io.SAFE_INDEX).write_text(json.dumps({"weight_map": weight_map}))
    got = hf_io.read_state_dict(str(tmp_path))
    assert sorted(got) == sorted(t)
    for k, v in t.items():
        want = _as_f32(v)
        assert got[k].dtype == (np.float32 if k == "d.bf16" else want.dtype), k
        np.testing.assert_array_equal(got[k], want)
    header, _ = hf_io.read_safetensors_header(str(tmp_path / "model-00002-of-00002.safetensors"))
    assert header["d.bf16"]["dtype"] == "BF16" and header["__metadata__"] == {"format": "pt"}


def test_safetensors_library_reads_the_port_files(tmp_path):
    """The port's writer: ``safetensors`` reads every tensor back (BF16 as
    torch bfloat16), and the metadata; an fp32 array narrows to BF16 as
    torch rounds it."""
    from safetensors import safe_open
    from safetensors.torch import load_file

    from galvatron_tpu_torch.models import hf_io

    t = _tensors(1)
    x = np.random.RandomState(2).randn(6).astype(np.float32)
    t["f.narrowed"] = torch.from_numpy(x).to(torch.bfloat16)
    path = str(tmp_path / "port.safetensors")
    hf_io.write_safetensors(path, t, metadata={"format": "pt"})
    got = load_file(path)
    assert sorted(got) == sorted(t)
    for k, v in t.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], v), k
        else:
            assert np.array_equal(got[k].numpy(), v) and got[k].numpy().dtype == v.dtype, k
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    assert np.array_equal(hf_io.read_safetensors(path)["f.narrowed"],
                          torch.from_numpy(x).to(torch.bfloat16).float().numpy())


def test_sharded_export_loads_in_from_pretrained(tmp_path):
    """Above the shard size the export writes ``save_pretrained``'s sharded
    layout and index; ``from_pretrained`` loads it to the same weights."""
    tf = _tf()
    from galvatron_tpu_torch.models import convert, hf_io

    hf = _tiny_hf()
    tcfg = _f32(convert.config_from_hf_llama(hf.config))
    params = convert.from_hf_llama(hf, tcfg)
    sd = convert.export_state_dict(params, tcfg, gpt2_style=False)
    files = hf_io.write_hf_dir(str(tmp_path / "hf"), convert.hf_export_config(tcfg, False), sd,
                               max_shard_bytes=64 * 1024)
    shards = [f for f in files if f.startswith("model-")]
    assert len(shards) > 2 and hf_io.SAFE_INDEX in files
    back = tf.AutoModelForCausalLM.from_pretrained(str(tmp_path / "hf")).eval()
    for k, v in hf.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def _minimal_configs():
    """model_type → the fields a config.json cannot leave out."""
    return {
        "llama": dict(vocab_size=128, hidden_size=64, intermediate_size=112,
                      num_hidden_layers=2, num_attention_heads=4,
                      max_position_embeddings=64),
        "gpt2": dict(vocab_size=96, n_embd=48, n_layer=2, n_head=4, n_positions=32),
        "opt": dict(vocab_size=96, hidden_size=48, num_hidden_layers=2,
                    num_attention_heads=4, ffn_dim=96, max_position_embeddings=32),
    }


@pytest.mark.parametrize("arch", ["llama", "gpt2", "opt"])
def test_minimal_config_json_reads_as_autoconfig(tmp_path, arch):
    """A config.json without the optional fields (``rms_norm_eps``,
    ``rope_theta``, ``num_key_value_heads``, ``tie_word_embeddings``,
    ``n_inner``, ...): the port's ``config_from_hf_*`` of ``hf_io.hf_config``
    gives the ModelConfig that ``AutoConfig`` followed by the JAX
    ``config_from_hf_*`` gives (LlamaConfig's rms_norm_eps is 1e-6, not
    the JAX fallback's 1e-5)."""
    tf = _tf()
    from galvatron_tpu.models import convert as jc
    from galvatron_tpu_torch.models import convert as tc
    from galvatron_tpu_torch.models import hf_io

    raw = dict(model_type=arch, **_minimal_configs()[arch])
    (tmp_path / "config.json").write_text(json.dumps(raw))
    auto = tf.AutoConfig.from_pretrained(str(tmp_path))
    name = {"llama": "llama", "gpt2": "gpt2", "opt": "opt"}[arch]
    jcfg = getattr(jc, f"config_from_hf_{name}")(auto)
    tcfg = getattr(tc, f"config_from_hf_{name}")(hf_io.hf_config(hf_io.read_config_json(
        str(tmp_path))))
    fields = [f for f in jcfg.__dataclass_fields__ if f in tcfg.__dataclass_fields__
              and f not in ("dtype", "param_dtype", "moe_ctx")]
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    if arch == "llama":
        assert tcfg.norm_eps == 1e-6 and tcfg.num_kv_heads == 4


def test_base_model_files_load_as_from_pretrained_does(tmp_path):
    """GPT-2 files without the ``transformer.`` prefix and OPT files
    without ``model.`` (the published checkpoints' layout), both with no
    ``lm_head.weight`` (tied): the port loads them as ``from_pretrained``
    loads them into the causal-LM model."""
    from galvatron_tpu_torch.models import convert

    for hf, base in ((_gpt2_hf(), "transformer"), (_opt_hf(), "model")):
        d = tmp_path / base
        d.mkdir()
        sd = {k: v.contiguous() for k, v in getattr(hf, base).state_dict().items()}
        assert not any(k.startswith(base + ".") or k.startswith("lm_head") for k in sd)
        torch.save(sd, d / "pytorch_model.bin")
        cfg = hf.config.to_dict()
        (d / "config.json").write_text(json.dumps(cfg))
        got, gcfg = convert.load_hf_checkpoint(str(d))
        want, wcfg = convert.load_hf_checkpoint(hf)
        assert gcfg == wcfg
        from galvatron_tpu_torch.core.checkpoint import flatten

        fw = flatten(want)
        assert all(torch.equal(v, fw[k]) for k, v in flatten(got).items())


# ---------------------------------------------------------------------------
# export parity: cli export-hf of both packages, loaded by from_pretrained
# ---------------------------------------------------------------------------

EXPORT_FLAGS = {
    "llama": ["--model_size", "llama-0.3b", "--hidden_size", "64", "--num_layers", "2",
              "--num_heads", "4", "--ffn_dim", "112", "--vocab_size", "128",
              "--seq_length", "16"],
    "gpt": ["--model_size", "gpt-0.3b", "--hidden_size", "48", "--num_layers", "2",
            "--num_heads", "4", "--vocab_size", "96", "--seq_length", "32"],
}


@pytest.mark.parametrize("family", list(EXPORT_FLAGS))
def test_cli_export_hf_matches_the_jax_package(tmp_path, family):
    """The JAX ``cli export-hf`` of its seed weights, and the port's of a
    checkpoint holding the same weights: ``from_pretrained`` loads both
    directories to bitwise-equal state dicts and equal logits."""
    import jax

    from galvatron_tpu.cli import main as j_main
    from galvatron_tpu.core.arguments import initialize_galvatron as j_init
    from galvatron_tpu.core.arguments import model_config_from_args as j_cfg
    from galvatron_tpu.models import modeling as jm
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core import checkpoint as ck

    tf = _tf()
    flags = EXPORT_FLAGS[family]
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert j_main(["export-hf", *flags, "--output_dir", a]) == 0
    jparams = jax.tree.map(np.asarray, jm.init_model_params(
        jax.random.key(0), j_cfg(j_init("export_hf", flags))))
    tree = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jparams)
    ck.save_checkpoint(str(tmp_path / "ck"), ck.flatten({"params": tree}), 0)
    assert cli.main(["export-hf", "--device", "cpu", *flags, "--load", str(tmp_path / "ck"),
                     "--output_dir", b]) == 0
    ma = tf.AutoModelForCausalLM.from_pretrained(a).eval()
    mb = tf.AutoModelForCausalLM.from_pretrained(b).eval()
    assert type(ma) is type(mb)
    sa, sb = ma.state_dict(), mb.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    tokens = torch.tensor(np.random.RandomState(6).randint(0, 96, (2, 12)))
    with torch.no_grad():
        assert torch.equal(ma(tokens).logits, mb(tokens).logits)


def test_export_hf_refuses_what_the_reference_refuses(tmp_path, capsys):
    from galvatron_tpu_torch import cli

    tiny = ["--device", "cpu", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "2",
            "--vocab_size", "64", "--output_dir", str(tmp_path / "x")]
    assert cli.main(["export-hf", "--model_size", "opt-125m", *tiny]) == 2
    assert "does not support the OPT family" in capsys.readouterr().out
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("pos_embed", ["alibi", "learned"])
def test_export_hf_refuses_positions_the_hf_class_cannot_carry(tmp_path, pos_embed):
    """A kept difference (ROADMAP §3): the reference exports an ALiBi model
    (or a learned-position one with LLaMA's layer) as ``LlamaForCausalLM``,
    which loads back as a RoPE model without the bias or the table. The
    port refuses both before any weight is drawn or file written, and its
    converters refuse a scheme their HF class lacks."""
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.models import convert as tc
    from galvatron_tpu_torch.models import modeling as tm

    out = tmp_path / "x"
    if pos_embed == "alibi":
        tiny = ["--device", "cpu", "--num_layers", "1", "--hidden_size", "40", "--num_heads",
                "5", "--ffn_dim", "64", "--vocab_size", "64", "--output_dir", str(out)]
        with pytest.raises(NotImplementedError, match="no ALiBi bias"):
            cli.main(["export-hf", "--model_size", "baichuan-13b", *tiny])
        assert not out.exists()
    cfg = tm.ModelConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, ffn_dim=64,
                         max_seq_len=16, pos_embed=pos_embed)
    params = tm.init_model_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="rotary positions only"):
        tc.to_hf_llama(params, cfg)
    with pytest.raises(NotImplementedError, match="learned position table only"):
        tc.to_hf_gpt2(params, cfg.replace(pos_embed="rope"))


# ---------------------------------------------------------------------------
# the runtime cases: one 4-rank gloo world (no JAX, no transformers there)
# ---------------------------------------------------------------------------


def _worker(case_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from galvatron_tpu_torch import bridge
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron
    from galvatron_tpu_torch.core.optim import AdamConfig
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.convert import load_hf_checkpoint
    from galvatron_tpu_torch.parallel import hybrid

    torch.set_num_threads(1)
    trainer.init_distributed(torch.device("cpu"), "gloo", timeout_s=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    for case in cases:
        if case["kind"] == "cli":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = trainer.train(initialize_galvatron("train", case["argv"]))
            rec = {"losses": out["losses"], "stdout": buf.getvalue()}
        else:
            full, cfg = load_hf_checkpoint(case["dir"])
            cfg = cfg.replace(dtype=torch.float32, attn_impl="xla")
            hp = HybridParallelConfig.from_json_dict(case["plan"])
            rt = hybrid.build_runtime(cfg, hp, AdamConfig(lr=1e-3), global_batch_size=BATCH,
                                      seq_len=SEQ, device="cpu")
            local = bridge.shard_params(bridge.params_to_numpy(full), cfg, hp, rank, world)
            state = rt.state_from(hybrid.zip_map(
                lambda a, n: torch.from_numpy(np.array(a, copy=True)), local))
            batch = torch.from_numpy(case["batch"])
            rec = {"eval": float(rt.eval_loss(state, batch)), "losses": []}
            for _ in range(case["steps"]):
                state, loss = rt.train_step(state, batch)
                rec["losses"].append(float(loss))
        with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"), "wb") as f:
            pickle.dump(rec, f)
    dist.destroy_process_group()


def _hf_ce_loss(hf_model, tokens):
    x = torch.tensor(tokens)
    with torch.no_grad():
        logits = hf_model(x[:, :-1]).logits
    return float(torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                                   x[:, 1:].reshape(-1)))


def _plans():
    """case → (port plan, layers, steps): ``tests/test_convert.py``'s
    runtime cases at world 4 (its tp 2 with DP 2 over the other ranks)."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig as H
    from galvatron_tpu_torch.core.strategy import LayerStrategy as L

    def layers(n, **kw):
        return [L(**kw) for _ in range(n)]

    return {
        "gspmd": (H(layer_strategies=layers(2, tp=2, dp_type="zero3"), pp=1,
                    mixed_precision="fp32"), 2, 1),
        "pipeline": (H(layer_strategies=layers(2), pp=2, chunks=2, pipeline_type="gpipe",
                       mixed_precision="fp32"), 2, 1),
        "interleaved": (H(layer_strategies=layers(4), pp=2, vpp=2, chunks=2,
                          pipeline_type="gpipe", mixed_precision="fp32"), 4, 1),
        "1f1b": (H(layer_strategies=layers(2), pp=2, chunks=2, pipeline_type="pipedream_flush",
                   mixed_precision="fp32"), 2, 1),
        "opt": (H.uniform(2, tp=2, vocab_tp=2, mixed_precision="fp32"), 2, 2),
        "gpt2": (H(layer_strategies=layers(2, tp=2, dp_type="zero3"),
                   mixed_precision="fp32"), 2, 4),
        "baichuan_alibi": (H.uniform(2, tp=2, vocab_tp=2, mixed_precision="fp32"), 2, 2),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every runtime case in one 4-rank gloo world; returns (references,
    per-case per-rank results, the launcher's per-rank results)."""
    from galvatron_tpu_torch.parallel.launch import launch_local

    tf = _tf()
    make_sd, ref_forward = _baichuan_ref()
    d = tmp_path_factory.mktemp("torch_convert_world")
    cases, refs = [], {}
    rng = np.random.RandomState(1)
    for name, (hp, n_layers, steps) in _plans().items():
        path = d / name
        if name == "opt":
            hf, vocab = _opt_hf(), 96
        elif name == "gpt2":
            hf, vocab = _gpt2_hf(seed=5), 96
        elif name == "baichuan_alibi":
            hf, vocab = None, 128
        else:
            hf, vocab = _tiny_hf(n_layers=n_layers, seed=1), 128
        batch = rng.randint(0, vocab, (BATCH, SEQ + 1)).astype(np.int64)
        if hf is None:  # a Baichuan-13B-style directory: config.json + one torch .bin
            path.mkdir()
            sd = make_sd(5, 128, 64, 2, 112)
            torch.save(sd, path / "pytorch_model.bin")
            (path / "config.json").write_text(json.dumps(_baichuan_config(alibi=True)))
            with torch.no_grad():
                logits = torch.from_numpy(ref_forward(sd, batch[:, :-1], 4, 2, alibi=True))
            refs[name] = float(torch.nn.functional.cross_entropy(
                logits.reshape(-1, 128), torch.from_numpy(batch[:, 1:]).reshape(-1)))
        else:
            hf.save_pretrained(path)
            refs[name] = _hf_ce_loss(hf, batch)
        cases.append(dict(name=name, kind="runtime", dir=str(path), plan=hp.to_json_dict(),
                          batch=batch, steps=steps))
    cli_dir = d / "cli_llama"
    _tiny_hf().save_pretrained(cli_dir)
    cli_argv = ["--device", "cpu", "--load_hf", str(cli_dir), "--global_train_batch_size", "8",
                "--train_iters", "3", "--global_tp_deg", "2", "--mixed_precision", "fp32",
                "--check_loss", "1", "--seq_length", "16"]
    cases.append(dict(name="cli", kind="cli", argv=cli_argv))
    case_path = d / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    run = threading.Thread(target=lambda: out.setdefault("ranks", launch_local(
        [sys.executable, str(Path(__file__).resolve()), "worker", str(case_path), str(d)],
        WORLD, timeout_s=WORLD_TIMEOUT_S, env=env, cwd=str(ROOT))))
    run.start()
    # the same cli run at world size 1, in this process, while the world trains
    from galvatron_tpu_torch.core import trainer
    from galvatron_tpu_torch.core.arguments import initialize_galvatron

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        i = cli_argv.index("--global_tp_deg")
        refs["cli"] = trainer.train(initialize_galvatron(
            "train", cli_argv[:i] + cli_argv[i + 2:]))["losses"]
    run.join()
    del tf
    results = {}
    for c in cases:
        files = [d / f"{c['name']}.{r}.pkl" for r in range(WORLD)]
        if all(f.exists() for f in files):
            results[c["name"]] = [pickle.load(open(f, "rb")) for f in files]
    return refs, results, out["ranks"]


def _world_failure(ranks):
    bad = [r for r in ranks if r.returncode != 0]
    return "\n".join(f"rank {r.rank} rc={r.returncode} killed={r.killed}:\n{r.output[-3000:]}"
                     for r in bad)


def _runtime_case(world, name):
    refs, results, ranks = world
    assert name in results, _world_failure(ranks)
    got = results[name]
    assert all(g["eval"] == got[0]["eval"] and g["losses"] == got[0]["losses"] for g in got)
    return refs[name], got[0]


@pytest.mark.parametrize("name", ["gspmd", "pipeline", "interleaved", "1f1b"])
def test_hf_weights_runtime(world, name):
    """``runtime_loss_parity``: the eval loss of the imported weights under
    the plan (tp 2 + zero3; GPipe; interleaved vpp 2; 1F1B) equals the HF
    cross entropy within 2e-4, and a train step from them is finite."""
    ref, got = _runtime_case(world, name)
    assert abs(got["eval"] - ref) < LOSS_TOL, (got["eval"], ref)
    assert all(np.isfinite(got["losses"]))


def test_hf_opt_through_dispatcher(world):
    """OPT checkpoint → loader → tp 2 (vocab tp 2) trains: the loss falls."""
    ref, got = _runtime_case(world, "opt")
    assert abs(got["eval"] - ref) < LOSS_TOL, (got["eval"], ref)
    l1, l2 = got["losses"]
    assert np.isfinite(l2) and l2 < l1


def test_load_hf_gpt2_through_runtime(world):
    """GPT-2 checkpoint → loader → tp 2 + zero3: the biases train too."""
    ref, got = _runtime_case(world, "gpt2")
    assert abs(got["eval"] - ref) < LOSS_TOL, (got["eval"], ref)
    assert got["losses"][-1] < got["eval"]


def test_load_hf_baichuan_through_runtime(world):
    """A Baichuan-13B-style directory (config.json + torch .bin, ALiBi) →
    loader → tp 2 (vocab tp 2): the eval loss equals the reference forward's
    cross entropy within 2e-4, and the loss falls."""
    ref, got = _runtime_case(world, "baichuan_alibi")
    assert abs(got["eval"] - ref) < LOSS_TOL, (got["eval"], ref)
    l1, l2 = got["losses"]
    assert np.isfinite(l2) and l2 < l1


def test_cli_train_load_hf(world):
    """``cli train --load_hf`` at tp 2 in the world: the shape and weights
    come from the checkpoint ("initialized from HF checkpoint"), and the
    losses equal the same run at world size 1 within 2e-4."""
    refs, results, ranks = world
    assert "cli" in results, _world_failure(ranks)
    got = results["cli"]
    assert "initialized from HF checkpoint" in got[0]["stdout"]
    assert all(g["losses"] == got[0]["losses"] for g in got)
    np.testing.assert_allclose(got[0]["losses"], refs["cli"], rtol=LOSS_TOL, atol=LOSS_TOL)


def test_every_rank_of_the_world_exited_cleanly(world):
    _, _, ranks = world
    assert all(r.returncode == 0 and not r.killed for r in ranks), _world_failure(ranks)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "worker":
        _worker(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(f"usage: {sys.argv[0]} worker CASES OUT")
