"""LLaMA flash-attention family entry (the reference's
``galvatron_tpu/models/llama_fa/``): the LLaMA family with ``--attn_impl
flash`` injected for ``train`` and ``profile`` unless the user chose an
implementation (the port's flash kernels, ``ops/flash_attention.py``;
``auto`` already picks them on the card, and the injection makes a
``--device cpu`` run take their plain versions)."""

from galvatron_tpu_torch.models.llama import SIZES  # noqa: F401 — same sizes

DEFAULT_MODEL = "llama-7b"

# modes whose arg parser carries --attn_impl (profile shares the training args)
_ATTN_MODES = ("train", "profile")


def fa_main(argv, model_default: str):
    """Shared *_fa entry: forward to the CLI with the family's size default
    and ``--attn_impl flash`` injected unless the user chose an impl."""
    import sys

    from galvatron_tpu_torch.cli import main as cli_main

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _ATTN_MODES and not any(
        a == "--attn_impl" or a.startswith("--attn_impl=") for a in argv
    ):
        argv += ["--attn_impl", "flash"]
    return cli_main(argv, model_default=model_default)


def main(argv=None):
    return fa_main(argv, DEFAULT_MODEL)
