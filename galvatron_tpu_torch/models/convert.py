"""HuggingFace checkpoint import and export (the port's counterpart of
``galvatron_tpu/models/convert.py``).

Maps an HF state dict onto the port's parameter tree and back: LLaMA
(``LlamaForCausalLM``: RMSNorm, SwiGLU, RoPE, no biases; per-projection
q/k/v packed into the fused layouts of ``modeling.qkv_dims``: blocked ``(h,
3, n·hd)`` without GQA, interleaved by kv group with GQA; gate/up into
``w13``), Baichuan-1 (7B rotary, 13B ALiBi; its fused ``W_pack``), GPT-2
(Conv1D weights, already input-major; blocked ``c_attn``) and OPT (separate
q/k/v with biases, the +2 position offset sliced off the table). The
arithmetic is the JAX module's, in fp32, as torch operations (their
transposes are blocked and threaded, where numpy's strided copies ran at
~0.2 GB/s on a 7B-width layer): the trees come back as CPU tensors of their
own memory in ``cfg.param_dtype``, in the layout of
``modeling.init_model_params``, and the export's state dicts as numpy fp32
(transposed on the parameters' device). Every refusal of the JAX module is
kept with its message.

The JAX module reads checkpoint directories through ``transformers``
(``AutoConfig``, ``from_pretrained``); the port reads the files itself
(``models/hf_io.py``) and never imports ``transformers`` or
``safetensors``. It takes the state dict as ``from_pretrained`` would:
GPT-2 files without the ``transformer.`` prefix, OPT and LLaMA files
without ``model.``, and no ``lm_head.weight`` when the head is tied. An
untied head missing from the files raises (``from_pretrained`` would draw
it at random).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from galvatron_tpu_torch.models import hf_io
from galvatron_tpu_torch.models.modeling import ModelConfig, Params


def _f32(t) -> torch.Tensor:
    """An fp32 tensor of its own memory (on the source tensor's device; a
    numpy array, possibly a read-only view of a memory-mapped file, on the
    CPU), so that training may update it in place."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(dtype=torch.float32, copy=True)
    return torch.from_numpy(np.array(t, dtype=np.float32))


def _getter(sd: Mapping[str, Any], family: str):
    """Missing-key accessor shared by every importer (one copy of the
    diagnostics instead of one per family)."""

    def get(name: str) -> torch.Tensor:
        if name not in sd:
            raise KeyError(
                f"HF state dict is missing '{name}' — not a {family} "
                f"checkpoint? (keys like {list(sd)[:3]})"
            )
        return _f32(sd[name])

    return get


def _state_dict(model_or_state_dict: Any) -> Mapping[str, Any]:
    if isinstance(model_or_state_dict, Mapping):
        return model_or_state_dict
    return model_or_state_dict.state_dict()


def _to_torch(tree: Any, cfg: ModelConfig) -> Any:
    """Contiguous leaves in ``cfg.param_dtype``. Each importer converts a
    layer as soon as it is built, so the host never holds the transposed
    views of every layer at once."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, cfg) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, cfg) for v in tree]
    return tree.contiguous().to(cfg.param_dtype)


def config_from_hf_llama(hf_config) -> ModelConfig:
    """ModelConfig from a ``LlamaConfig``-shaped object.

    Rejects config features the fused layouts here do not carry — silently
    dropping them would produce a numerically wrong model."""
    if getattr(hf_config, "rope_scaling", None):
        raise ValueError(
            "HF checkpoint uses rope_scaling (Llama-3.1-style scaled RoPE), "
            "which this importer does not implement — frequencies would be "
            "wrong; refusing to convert"
        )
    if getattr(hf_config, "attention_bias", False) or getattr(hf_config, "mlp_bias", False):
        raise ValueError(
            "HF checkpoint carries attention/MLP biases; the fused layouts "
            "here have no bias slots — refusing to silently drop them"
        )
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", None),
        ffn_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
        tie_word_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
    )


def pack_qkv(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Per-projection (h, out) matrices (already input-major, i.e. HF weights
    transposed) → the fused wqkv layout."""
    h, hd = cfg.hidden_size, cfg.head_dim
    n, kv = cfg.num_heads, cfg.kv_heads
    if cfg.qkv_blocked:
        return torch.stack([wq, wk, wv], dim=1)  # (h, 3, n*hd)
    npg = n // kv
    q = wq.reshape(h, kv, npg, hd)
    k = wk.reshape(h, kv, 1, hd)
    v = wv.reshape(h, kv, 1, hd)
    inter = torch.cat([q, k, v], dim=2)  # (h, kv, npg+2, hd)
    return inter.reshape(h, kv * (npg + 2) * hd)


def unpack_qkv(wqkv: torch.Tensor, cfg: ModelConfig):
    """Inverse of pack_qkv: fused wqkv → per-projection (h, out) matrices."""
    h, hd = cfg.hidden_size, cfg.head_dim
    n, kv = cfg.num_heads, cfg.kv_heads
    if cfg.qkv_blocked:
        return wqkv[:, 0, :], wqkv[:, 1, :], wqkv[:, 2, :]
    npg = n // kv
    r = wqkv.reshape(h, kv, npg + 2, hd)
    wq = r[:, :, :npg, :].reshape(h, n * hd)
    wk = r[:, :, npg, :].reshape(h, kv * hd)
    wv = r[:, :, npg + 1, :].reshape(h, kv * hd)
    return wq, wk, wv


def _llama_layers(get, cfg: ModelConfig, attn_fn) -> list:
    """The LLaMA-architecture layers (LLaMA and Baichuan: RMSNorm, SwiGLU,
    no biases); ``attn_fn(prefix)`` gives the fused wqkv."""
    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        layers.append(_to_torch({
            "attn_norm": {"scale": get(pre + "input_layernorm.weight")},
            "attn": {"wqkv": attn_fn(pre),
                     "wo": get(pre + "self_attn.o_proj.weight").t()},
            "mlp_norm": {"scale": get(pre + "post_attention_layernorm.weight")},
            "mlp": {"w13": torch.cat([get(pre + "mlp.gate_proj.weight").t(),
                                      get(pre + "mlp.up_proj.weight").t()], dim=1),
                    "w2": get(pre + "mlp.down_proj.weight").t()},
        }, cfg))
    return layers


def from_hf_llama(model_or_state_dict: Any, cfg: ModelConfig) -> Params:
    """HF ``LlamaForCausalLM`` (or its state dict) → parameter tree in
    ``cfg.param_dtype``. ``cfg`` must describe the same architecture
    (``config_from_hf_llama``)."""
    get = _getter(_state_dict(model_or_state_dict), "LLaMA-architecture")

    def wqkv(pre):
        return pack_qkv(get(pre + "self_attn.q_proj.weight").t(),
                        get(pre + "self_attn.k_proj.weight").t(),
                        get(pre + "self_attn.v_proj.weight").t(), cfg)

    params: Params = {"embed": {"tok": get("model.embed_tokens.weight")},
                      "layers": _llama_layers(get, cfg, wqkv),
                      "final_norm": {"scale": get("model.norm.weight")}}
    if not cfg.tie_word_embeddings:
        params["head"] = {"w": get("lm_head.weight").t()}
    return _to_torch(params, cfg)


def config_from_hf_baichuan(hf_config) -> ModelConfig:
    """ModelConfig from a Baichuan-1 HF config (model_type 'baichuan': a
    trust_remote_code architecture with no transformers config class, read
    raw).

    The 7B checkpoint uses rotary positions and carries
    ``max_position_embeddings``; the 13B checkpoint uses ALiBi and carries
    ``model_max_length`` instead — that field difference is the published
    config discriminator between the two architectures."""
    if hf_config.vocab_size > 100000:
        # Baichuan-2 shares model_type 'baichuan' but normalizes the lm_head
        # rows at forward time (NormHead) and its 7B uses RoPE despite
        # carrying only model_max_length: its 125696-token vocab (vs
        # Baichuan-1's 64000) is the reliable config discriminator.
        raise ValueError(
            f"vocab_size {hf_config.vocab_size} indicates a Baichuan-2 "
            "checkpoint (NormHead + different position-scheme config "
            "encoding), which this importer does not implement — refusing "
            "to silently import it with Baichuan-1 math"
        )
    mpe = getattr(hf_config, "max_position_embeddings", None)
    alibi = mpe is None
    if alibi and getattr(hf_config, "model_max_length", None) is None:
        raise ValueError(
            "baichuan config carries neither max_position_embeddings (7B, "
            "rotary) nor model_max_length (13B, ALiBi) — cannot infer the "
            "position-embedding scheme"
        )
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        ffn_dim=hf_config.intermediate_size,
        max_seq_len=mpe if mpe is not None else hf_config.model_max_length,
        pos_embed="alibi" if alibi else "rope",
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-6)),
        tie_word_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
    )


def from_hf_baichuan(model_or_state_dict: Any, cfg: ModelConfig) -> Params:
    """HF Baichuan-1 state dict (or model) → parameter tree. Baichuan is
    LLaMA-architecture except the attention input projection is already
    fused: ``self_attn.W_pack.weight`` is (3·h, h) in [Q; K; V] row order —
    transposed, exactly the blocked wqkv layout (no GQA in either size)."""
    get = _getter(_state_dict(model_or_state_dict), "Baichuan")
    h, nd = cfg.hidden_size, cfg.num_heads * cfg.head_dim

    def wqkv(pre):
        return get(pre + "self_attn.W_pack.weight").t().reshape(h, 3, nd)

    params: Params = {"embed": {"tok": get("model.embed_tokens.weight")},
                      "layers": _llama_layers(get, cfg, wqkv),
                      "final_norm": {"scale": get("model.norm.weight")}}
    if not cfg.tie_word_embeddings:
        params["head"] = {"w": get("lm_head.weight").t()}
    return _to_torch(params, cfg)


def config_from_hf_gpt2(hf_config) -> ModelConfig:
    """ModelConfig from a ``GPT2Config``-shaped object."""
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported GPT-2 activation {act!r} (the MLP here uses the "
            "tanh-approximate gelu, i.e. HF's gelu_new)"
        )
    if getattr(hf_config, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx is not implemented")
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        ffn_dim=hf_config.n_inner or 4 * hf_config.n_embd,
        max_seq_len=hf_config.n_positions,
        pos_embed="learned",
        norm_type="layernorm",
        act_fn="gelu",
        use_bias=True,
        tie_word_embeddings=True,
        norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
    )


def from_hf_gpt2(model_or_state_dict: Any, cfg: ModelConfig) -> Params:
    """HF ``GPT2LMHeadModel`` (or its state dict) → parameter tree. GPT-2's
    Conv1D weights are already input-major (h_in, h_out) and its fused
    ``c_attn`` is already in the blocked [Q | K | V] column order, so the
    mapping is reshape-only."""
    get = _getter(_state_dict(model_or_state_dict), "GPT-2")
    h, nd = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    params: Params = {
        "embed": {"tok": get("transformer.wte.weight"), "pos": get("transformer.wpe.weight")},
        "layers": [],
        "final_norm": {"scale": get("transformer.ln_f.weight"),
                       "bias": get("transformer.ln_f.bias")},
    }
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        params["layers"].append(_to_torch({
            "attn_norm": {"scale": get(pre + "ln_1.weight"), "bias": get(pre + "ln_1.bias")},
            "attn": {"wqkv": get(pre + "attn.c_attn.weight").reshape(h, 3, nd),
                     "wqkv_b": get(pre + "attn.c_attn.bias").reshape(3, nd),
                     "wo": get(pre + "attn.c_proj.weight"),
                     "wo_b": get(pre + "attn.c_proj.bias")},
            "mlp_norm": {"scale": get(pre + "ln_2.weight"), "bias": get(pre + "ln_2.bias")},
            "mlp": {"w1": get(pre + "mlp.c_fc.weight"), "w1_b": get(pre + "mlp.c_fc.bias"),
                    "w2": get(pre + "mlp.c_proj.weight"), "w2_b": get(pre + "mlp.c_proj.bias")},
        }, cfg))
    return _to_torch(params, cfg)


def config_from_hf_opt(hf_config) -> ModelConfig:
    """ModelConfig from an ``OPTConfig``-shaped object (decoder-only, ReLU
    MLPs, LayerNorm, learned positions with OPT's +2 offset)."""
    if getattr(hf_config, "word_embed_proj_dim", hf_config.hidden_size) != hf_config.hidden_size:
        raise ValueError(
            "OPT checkpoints with projected embeddings (word_embed_proj_dim "
            "!= hidden_size, e.g. opt-350m) are not supported"
        )
    if not getattr(hf_config, "do_layer_norm_before", True):
        raise ValueError(
            "post-norm OPT variants (do_layer_norm_before=False, opt-350m) "
            "are not supported (this decoder is pre-norm)"
        )
    act = getattr(hf_config, "activation_function", "relu")
    if act != "relu":
        raise ValueError(f"unsupported OPT activation {act!r} (expected relu)")
    if not getattr(hf_config, "tie_word_embeddings", True):
        raise ValueError(
            "untied OPT checkpoints (tie_word_embeddings=False) are not "
            "supported — the lm_head would be silently dropped"
        )
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        ffn_dim=hf_config.ffn_dim,
        max_seq_len=hf_config.max_position_embeddings,
        pos_embed="learned",
        norm_type="layernorm",
        act_fn="relu",
        use_bias=True,
        tie_word_embeddings=True,
    )


def from_hf_opt(model_or_state_dict: Any, cfg: ModelConfig) -> Params:
    """HF ``OPTForCausalLM`` (or its state dict) → parameter tree. Separate
    q/k/v projections with biases, packed into the blocked layout; the
    learned position table is read at position+2, so the offset is sliced
    off (exact for left-aligned, unpadded rows: the runtime's batches)."""
    get = _getter(_state_dict(model_or_state_dict), "OPT")
    pos = get("model.decoder.embed_positions.weight")[2:2 + cfg.max_seq_len]
    params: Params = {
        "embed": {"tok": get("model.decoder.embed_tokens.weight"), "pos": pos},
        "layers": [],
        "final_norm": {"scale": get("model.decoder.final_layer_norm.weight"),
                       "bias": get("model.decoder.final_layer_norm.bias")},
    }
    for i in range(cfg.num_layers):
        pre = f"model.decoder.layers.{i}."
        proj = [get(pre + f"self_attn.{x}_proj.weight").t() for x in "qkv"]
        bias = [get(pre + f"self_attn.{x}_proj.bias") for x in "qkv"]
        params["layers"].append(_to_torch({
            "attn_norm": {"scale": get(pre + "self_attn_layer_norm.weight"),
                          "bias": get(pre + "self_attn_layer_norm.bias")},
            "attn": {"wqkv": pack_qkv(*proj, cfg), "wqkv_b": torch.stack(bias, dim=0),
                     "wo": get(pre + "self_attn.out_proj.weight").t(),
                     "wo_b": get(pre + "self_attn.out_proj.bias")},
            "mlp_norm": {"scale": get(pre + "final_layer_norm.weight"),
                         "bias": get(pre + "final_layer_norm.bias")},
            "mlp": {"w1": get(pre + "fc1.weight").t(), "w1_b": get(pre + "fc1.bias"),
                    "w2": get(pre + "fc2.weight").t(), "w2_b": get(pre + "fc2.bias")},
        }, cfg))
    return _to_torch(params, cfg)


def _numpy(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict of fp32 tensors → contiguous numpy fp32 on the host (a
    second name for one tensor stays one array)."""
    out: Dict[str, np.ndarray] = {}
    seen: Dict[int, np.ndarray] = {}
    for k, t in sd.items():
        if id(t) not in seen:
            seen[id(t)] = t.contiguous().cpu().numpy()
        out[k] = seen[id(t)]
    return out


def check_hf_llama_positions(cfg: ModelConfig) -> None:
    """Refuse a LLaMA-style export of a model without rotary positions.
    ``LlamaForCausalLM`` has RoPE and nothing else: an ALiBi model (a
    Baichuan-13B) would come back as a RoPE model without its bias, and a
    learned-position table would be dropped, each without a word. The
    reference exports both so (ROADMAP.md §3, kept differences)."""
    if cfg.pos_embed != "rope":
        raise NotImplementedError(
            f"export-hf of pos_embed={cfg.pos_embed!r}: the LLaMA export carries rotary "
            "positions only (LlamaForCausalLM has no ALiBi bias and no position table), "
            "so the directory would load as a different model; the port refuses it "
            "(ROADMAP.md §3)")


def to_hf_llama(params: Params, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Parameter tree → an HF ``LlamaForCausalLM`` state dict (numpy fp32,
    HF's output-major weight orientation; transposed on the parameters'
    device): the export half of the round trip. A tied head's
    ``lm_head.weight`` is the token table."""
    check_hf_llama_positions(cfg)
    if cfg.act_fn != "swiglu" or cfg.norm_type != "rms" or cfg.use_bias:
        raise ValueError(
            "to_hf_llama exports the LLaMA architecture family only "
            "(RMSNorm + SwiGLU, no projection biases)"
        )
    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": _f32(params["embed"]["tok"]),
        "model.norm.weight": _f32(params["final_norm"]["scale"]),
    }
    for i, lp in enumerate(params["layers"]):
        pre = f"model.layers.{i}."
        wq, wk, wv = unpack_qkv(_f32(lp["attn"]["wqkv"]), cfg)
        sd[pre + "self_attn.q_proj.weight"] = wq.t()
        sd[pre + "self_attn.k_proj.weight"] = wk.t()
        sd[pre + "self_attn.v_proj.weight"] = wv.t()
        sd[pre + "self_attn.o_proj.weight"] = _f32(lp["attn"]["wo"]).t()
        w13 = _f32(lp["mlp"]["w13"])
        f = w13.shape[-1] // 2
        sd[pre + "mlp.gate_proj.weight"] = w13[:, :f].t()
        sd[pre + "mlp.up_proj.weight"] = w13[:, f:].t()
        sd[pre + "mlp.down_proj.weight"] = _f32(lp["mlp"]["w2"]).t()
        sd[pre + "input_layernorm.weight"] = _f32(lp["attn_norm"]["scale"])
        sd[pre + "post_attention_layernorm.weight"] = _f32(lp["mlp_norm"]["scale"])
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = _f32(params["head"]["w"]).t()
    else:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    return _numpy(sd)


def to_hf_gpt2(params: Params, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Parameter tree → an HF ``GPT2LMHeadModel`` state dict (numpy fp32;
    reshape-only): the export half of the GPT-2 round trip."""
    if cfg.pos_embed != "learned":
        raise NotImplementedError(
            f"to_hf_gpt2 of pos_embed={cfg.pos_embed!r}: GPT2LMHeadModel carries a learned "
            "position table only")
    if not cfg.tie_word_embeddings:
        raise ValueError(
            "to_hf_gpt2 exports tied-embedding models only (GPT2LMHeadModel "
            "ties lm_head to wte); an untied head would be silently dropped"
        )
    h, nd = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    sd: Dict[str, torch.Tensor] = {
        "transformer.wte.weight": _f32(params["embed"]["tok"]),
        "transformer.wpe.weight": _f32(params["embed"]["pos"]),
        "transformer.ln_f.weight": _f32(params["final_norm"]["scale"]),
        "transformer.ln_f.bias": _f32(params["final_norm"]["bias"]),
    }
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    for i, lp in enumerate(params["layers"]):
        pre = f"transformer.h.{i}."
        sd[pre + "ln_1.weight"] = _f32(lp["attn_norm"]["scale"])
        sd[pre + "ln_1.bias"] = _f32(lp["attn_norm"]["bias"])
        sd[pre + "attn.c_attn.weight"] = _f32(lp["attn"]["wqkv"]).reshape(h, 3 * nd)
        sd[pre + "attn.c_attn.bias"] = _f32(lp["attn"]["wqkv_b"]).reshape(3 * nd)
        sd[pre + "attn.c_proj.weight"] = _f32(lp["attn"]["wo"])
        sd[pre + "attn.c_proj.bias"] = _f32(lp["attn"]["wo_b"])
        sd[pre + "ln_2.weight"] = _f32(lp["mlp_norm"]["scale"])
        sd[pre + "ln_2.bias"] = _f32(lp["mlp_norm"]["bias"])
        sd[pre + "mlp.c_fc.weight"] = _f32(lp["mlp"]["w1"])
        sd[pre + "mlp.c_fc.bias"] = _f32(lp["mlp"]["w1_b"])
        sd[pre + "mlp.c_proj.weight"] = _f32(lp["mlp"]["w2"])
        sd[pre + "mlp.c_proj.bias"] = _f32(lp["mlp"]["w2_b"])
    return _numpy(sd)


def _state_dict_from_dir(path: str) -> Dict[str, Any]:
    """Raw weight load from an HF checkpoint directory (safetensors or torch
    .bin, sharded or not) WITHOUT any model class (``models/hf_io.py``)."""
    return hf_io.read_state_dict(path)


#: the module prefix ``from_pretrained`` adds to a base model's keys, per family
_PREFIX = {"llama": ("model.", "model.embed_tokens.weight"),
           "gpt2": ("transformer.", "transformer.wte.weight"),
           "opt": ("model.", "model.decoder.embed_tokens.weight")}


def _with_prefix(sd: Dict[str, Any], arch: str) -> Dict[str, Any]:
    """A base-model state dict (keys without the causal-LM wrapper's
    prefix, e.g. GPT-2's ``wte.weight``) renamed as ``from_pretrained``
    loads it into the causal-LM model; a full one as it is."""
    prefix, probe = _PREFIX[arch]
    if probe in sd or probe[len(prefix):] not in sd:
        return sd
    return {k if k.startswith("lm_head.") else prefix + k: v for k, v in sd.items()}


def load_hf_checkpoint(path_or_model: Any) -> tuple:
    """(params, cfg) from a local HF checkpoint directory or an in-memory HF
    model (``.config`` and ``.state_dict()``). Supported architectures:
    LLaMA family (RMSNorm/SwiGLU/RoPE, no biases), Baichuan-1 (7B rotary /
    13B ALiBi, fused W_pack), GPT-2 (LayerNorm/GeLU/learned positions,
    biases) and OPT (LayerNorm/ReLU/learned positions with the +2 offset,
    biases). A directory's ``config.json`` is read as ``AutoConfig`` reads
    it (``hf_io.hf_config``); Baichuan's raw."""
    if isinstance(path_or_model, str):
        raw = hf_io.read_config_json(path_or_model)
        arch = raw.get("model_type")
        if arch not in ("llama", "gpt2", "opt", "baichuan"):
            raise ValueError(
                f"--load_hf supports LLaMA-architecture, Baichuan, GPT-2 and OPT "
                f"checkpoints; got model_type={arch!r} ({path_or_model}/config.json)"
            )
        hf_cfg: Any = hf_io.hf_config(raw)
        model: Any = _state_dict_from_dir(path_or_model)
        if arch != "baichuan":
            model = _with_prefix(model, arch)
    else:
        model = path_or_model
        hf_cfg = model.config
    arch = getattr(hf_cfg, "model_type", "")
    if arch == "gpt2":
        cfg = config_from_hf_gpt2(hf_cfg)
        return from_hf_gpt2(model, cfg), cfg
    if arch == "opt":
        cfg = config_from_hf_opt(hf_cfg)
        return from_hf_opt(model, cfg), cfg
    if arch == "baichuan":
        cfg = config_from_hf_baichuan(hf_cfg)
        return from_hf_baichuan(model, cfg), cfg
    cfg = config_from_hf_llama(hf_cfg)
    return from_hf_llama(model, cfg), cfg


# the JAX module's name for the same function (LLaMA was its first family)
load_hf_llama = load_hf_checkpoint


def hf_export_config(cfg: ModelConfig, gpt2_style: bool) -> Dict[str, Any]:
    """The ``config.json`` of an exported model: the fields the JAX
    ``export-hf`` passes to ``GPT2Config`` / ``LlamaConfig``, with the
    architecture and model type ``from_pretrained`` dispatches on."""
    if gpt2_style:
        return {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
                "vocab_size": cfg.vocab_size, "n_embd": cfg.hidden_size,
                "n_layer": cfg.num_layers, "n_head": cfg.num_heads, "n_inner": cfg.ffn,
                "n_positions": cfg.max_seq_len, "layer_norm_epsilon": cfg.norm_eps,
                "activation_function": "gelu_new", "tie_word_embeddings": True,
                "torch_dtype": "float32"}
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.ffn, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.kv_heads,
            "max_position_embeddings": cfg.max_seq_len, "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta, "tie_word_embeddings": cfg.tie_word_embeddings,
            "hidden_act": "silu", "torch_dtype": "float32"}


def export_state_dict(params: Params, cfg: ModelConfig, gpt2_style: bool
                      ) -> Dict[str, np.ndarray]:
    """The state dict ``save_pretrained`` writes for the exported model: a
    tied ``lm_head.weight`` (a second name for the token table) left out."""
    sd = (to_hf_gpt2 if gpt2_style else to_hf_llama)(params, cfg)
    if cfg.tie_word_embeddings:
        sd.pop("lm_head.weight")
    return sd
