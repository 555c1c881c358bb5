"""GPT flash-attention family entry (the reference's
``galvatron_tpu/models/gpt_fa/``): the gpt family's sizes with ``--attn_impl
flash`` injected as in ``galvatron_tpu_torch.models.llama_fa``."""

from galvatron_tpu_torch.models.gpt import SIZES  # noqa: F401 — same sizes
from galvatron_tpu_torch.models.llama_fa import fa_main

DEFAULT_MODEL = "gpt-1.5b"


def main(argv=None):
    return fa_main(argv, DEFAULT_MODEL)
