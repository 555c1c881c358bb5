"""BERT family entry (the reference's ``galvatron_tpu/models/bert/``):
masked-LM pretraining of the bidirectional encoder (``causal=False``,
``objective='mlm'``) through the hybrid-parallel runtime; sizes bert-base
and bert-large."""

DEFAULT_MODEL = "bert-base"
SIZES = ("bert-base", "bert-large")


def main(argv=None):
    from galvatron_tpu_torch.cli import main as cli_main

    return cli_main(argv, model_default=DEFAULT_MODEL)
