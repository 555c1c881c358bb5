"""OPT family entry (the reference's ``galvatron_tpu/models/opt/``:
decoder-only, ReLU MLPs, learned positions; HF import through
``models/convert.py``)."""

DEFAULT_MODEL = "opt-1.3b"
SIZES = ("opt-125m", "opt-1.3b", "opt-6.7b", "opt-13b", "opt-30b")


def main(argv=None):
    from galvatron_tpu_torch.cli import main as cli_main

    return cli_main(argv, model_default=DEFAULT_MODEL)
