"""Baichuan family entry (the reference's ``galvatron_tpu/models/baichuan/``):
LLaMA's layer; the 13B size uses ALiBi positions (``PRESETS['baichuan-13b']``,
the einsum attention with the bias)."""

DEFAULT_MODEL = "baichuan-7b"
SIZES = ("baichuan-7b", "baichuan-13b")


def main(argv=None):
    from galvatron_tpu_torch.cli import main as cli_main

    return cli_main(argv, model_default=DEFAULT_MODEL)
