"""T5 encoder-decoder family entry (the reference's
``galvatron_tpu/models/t5/``): a bidirectional encoder stack, its final
norm, and a causal decoder whose layers cross-attend to it, trained through
the hybrid-parallel runtime. Per-layer strategies cover the encoder, then
the decoder; at pp > 1 the coupled encoder-decoder pipeline
(``parallel/pipeline_encdec.py``, GPipe or 1F1B). Sizes t5-base, t5-large
and t5-3b, with learned positions rather than T5's relative bias (the
reference's documented deviation, ``modeling.PRESETS``)."""

DEFAULT_MODEL = "t5-base"
SIZES = ("t5-base", "t5-large", "t5-3b")


def main(argv=None):
    from galvatron_tpu_torch.cli import main as cli_main

    return cli_main(argv, model_default=DEFAULT_MODEL)
