"""GPT-2 family entry (the reference's ``galvatron_tpu/models/gpt/``)."""

DEFAULT_MODEL = "gpt-1.5b"
SIZES = ("gpt-0.3b", "gpt-1.5b", "gpt-2.7b", "gpt-6.7b")


def main(argv=None):
    from galvatron_tpu_torch.cli import main as cli_main

    return cli_main(argv, model_default=DEFAULT_MODEL)
