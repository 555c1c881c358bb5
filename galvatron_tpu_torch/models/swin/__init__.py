"""Swin family entry (the reference's ``galvatron_tpu/models/swin/``): image
classification (``objective='cls'``) over a hierarchical pyramid of
shifted-window layers joined by patch merges (``modeling.swin_layer``,
``modeling.patch_merge``), per-layer hybrid strategies at pp = 1 and the
K-section pair-stacked pipeline at pp > 1 (``parallel/pipeline_swin.py``,
GPipe or 1F1B); samples are pixel rows ‖ class label; sizes swin-base and
swin-large."""

DEFAULT_MODEL = "swin-base"
SIZES = ("swin-base", "swin-large")


def main(argv=None):
    from galvatron_tpu_torch.cli import main as cli_main

    return cli_main(argv, model_default=DEFAULT_MODEL)
