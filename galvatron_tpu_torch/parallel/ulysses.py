"""Ulysses context parallelism: the sequence all-to-all (the port's
counterpart of ``galvatron_tpu/parallel/ulysses.py``).

Instead of rotating K/V round a ring (``parallel/ring.py``), one all-to-all
over the layer's CP group re-shards q, k and v from sequence-sharded
(B, S/cp, n, d) to head-sharded (B, S, n/cp, d) (``comm.all_to_all``), each
rank runs full-sequence causal attention on its heads (the grid flash
kernels under ``attn_impl='flash'``: RoPE is applied before the move, so the
core has none), and a second all-to-all restores sequence sharding. The
heads split is of the tp-LOCAL head count, which cp must divide. K/V cross
at their kv heads where the local kv count splits over cp and repeated to
the query heads where it does not.
"""

from __future__ import annotations

from galvatron_tpu_torch.models import modeling
from galvatron_tpu_torch.parallel import comm
from galvatron_tpu_torch.parallel.mesh import Group
from galvatron_tpu_torch.parallel.ring import rope_rows


def check_heads(num_heads: int, tp: int, cp: int) -> None:
    """The Ulysses head rule, with the reference's message."""
    if num_heads % tp or (num_heads // tp) % cp:
        raise ValueError(
            f"cp_impl='a2a' needs the tp-local head count "
            f"{num_heads}/tp={tp} divisible by cp={cp} "
            "(use cp_impl='ring' for few-head models)"
        )


def _core(q, k, v, cfg):
    """Full-sequence causal attention on (B, S, n, d) q and (B, S, kv, d)
    k/v (the reference's ``modeling.attention`` without RoPE)."""
    if cfg.attn_impl == "flash":
        from galvatron_tpu_torch.ops.flash_attention import flash_attention

        n = q.shape[2]
        k = modeling._repeat_kv(k, n // k.shape[2])
        v = modeling._repeat_kv(v, n // v.shape[2])
        return flash_attention(q, k, v, causal=True)
    return modeling.attention_xla(q, k, v, cfg, 0)


def ulysses_attention(q, k, v, cfg, group: Group, tp: int = 1):
    """q (B, S/cp, n/tp, d) and k/v (B, S/cp, kv/tp, d), this rank's block
    of the sequence and its TP heads; returns the (B, S/cp, n/tp, d)
    context. ``tp`` is the layer's TP degree (the head rule names it)."""
    cp = group.size
    check_heads(q.shape[2] * tp, tp, cp)
    if k.shape[2] % cp:  # grouped K/V cannot split over cp: repeat them
        k = modeling._repeat_kv(k, q.shape[2] // k.shape[2])
        v = modeling._repeat_kv(v, q.shape[2] // v.shape[2])
    # sequence-sharded → head-sharded
    q, k, v = (comm.all_to_all(t, group, 2, 1) for t in (q, k, v))
    # head-sharded → sequence-sharded
    return comm.all_to_all(_core(q, k, v, cfg), group, 1, 2)


def ulysses_decoder_layer(x, p, cfg, group: Group, cos_sin=None, tp=None):
    """A decoder layer whose attention core crosses the CP group by
    all-to-all (the reference's ``ulysses_decoder_layer``): as
    ``ring.ring_decoder_layer``, with :func:`ulysses_attention` for the
    ring."""
    tp_size = tp.size if tp is not None else 1
    return modeling.core_decoder_layer(
        x, p, cfg, lambda q, k, v: ulysses_attention(q, k, v, cfg, group, tp_size),
        rope_rows(cos_sin, group, x.shape[1]), tp)
