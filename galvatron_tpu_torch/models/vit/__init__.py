"""ViT family entry (the reference's ``galvatron_tpu/models/vit/``): image
classification (``objective='cls'``) with the patch-projection embedding,
bidirectional layers and the pooled class head through the hybrid-parallel
runtime, every plan and pipeline schedule included; samples are pixel rows ‖
class label (``modeling.vision_embed``); sizes vit-base, vit-large and
vit-huge."""

DEFAULT_MODEL = "vit-base"
SIZES = ("vit-base", "vit-large", "vit-huge")


def main(argv=None):
    from galvatron_tpu_torch.cli import main as cli_main

    return cli_main(argv, model_default=DEFAULT_MODEL)
