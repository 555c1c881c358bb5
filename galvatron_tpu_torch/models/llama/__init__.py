"""LLaMA family entry (the reference's ``galvatron_tpu/models/llama/``):
``python -m galvatron_tpu_torch.models.llama <mode> [flags]`` runs the
port's CLI with this family's default ``--model_size``."""

DEFAULT_MODEL = "llama-7b"
SIZES = ("llama-0.3b", "llama-7b", "llama-13b", "llama-30b")


def main(argv=None):
    from galvatron_tpu_torch.cli import main as cli_main

    return cli_main(argv, model_default=DEFAULT_MODEL)
