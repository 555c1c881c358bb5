"""CLI of the port: python -m galvatron_tpu_torch.cli <mode> [flags]

  train   train a LLaMA- or GPT/OPT-family decoder on one device: synthetic
          tokens from --seed, fp32 master weights, AdamW, the flash kernels
          on the card (--attn_impl auto: blocked-causal with RoPE, grid
          otherwise); a line and a train_iter JSONL record (--metrics_path)
          per iteration
  serve   REST generation server over the continuous-batching engine on the
          paged KV backend (--kv_num_blocks -1), weights initialised from a
          seed; LLaMA family only (GPT serving: ROADMAP.md §1.10)

Both run on the card (--device cuda, the default) or, when asked, on the
CPU (--device cpu). The reference's other modes (search, profile, generate,
warmup, ...) are not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

import sys
import threading
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    mode, rest = argv[0], argv[1:]
    if mode not in ("serve", "train"):
        print(f"mode {mode!r} is not ported yet; expected: train or serve", file=sys.stderr)
        return 2

    from galvatron_tpu_torch.core.arguments import initialize_galvatron, model_config_from_args

    if mode == "train":
        from galvatron_tpu_torch.core.trainer import train

        train(initialize_galvatron(mode, rest))
        return 0
    from galvatron_tpu_torch.device import resolve_device
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.models.tokenizer import build_tokenizer
    from galvatron_tpu_torch.server import GenerationService, run_server
    from galvatron_tpu_torch.serving.engine import Engine

    ns = initialize_galvatron(mode, rest)
    cfg = model_config_from_args(ns)
    modeling.check_serving_supported(cfg)  # before any weight is allocated
    device = resolve_device(ns.device)
    tok = build_tokenizer(ns.tokenizer)
    if tok.vocab_size > cfg.vocab_size:
        cfg = cfg.replace(vocab_size=tok.vocab_size)
    # random weights from seed 0, as the reference's cli does without --load
    params = modeling.cast_params(modeling.init_model_params(cfg, 0, device), cfg)
    engine = Engine(
        params, cfg, device=device,
        num_slots=ns.num_slots,
        prefill_chunk=ns.prefill_chunk,
        max_queue=ns.max_queue,
        request_ttl_s=ns.request_ttl_s if ns.request_ttl_s > 0 else None,
        eos_id=tok.eos_id,
        pad_id=tok.pad_id,
        seed=ns.seed,
        deadline_policy=ns.deadline_policy,
        max_engine_restarts=ns.max_engine_restarts,
        drain_timeout_s=ns.drain_timeout_s,
        kv_block_size=ns.kv_block_size,
        kv_num_blocks=ns.kv_num_blocks,
        prefix_cache=ns.prefix_cache == "on",
    )
    service = GenerationService(cfg, tok, engine, ns.max_new_tokens)
    # the server listens first (/readyz answers 503 "starting"), then one
    # real generation goes through the engine before /readyz turns 200
    service.starting = True
    listening = threading.Event()
    threading.Thread(target=_serve_warmup, args=(engine, service, listening),
                     name="serve-warmup", daemon=True).start()
    run_server(service, port=ns.port, host=ns.host, ready_event=listening,
               drain_timeout_s=ns.drain_timeout_s)
    return 0


def _serve_warmup(engine, service, listening) -> None:
    """One real generation through the scheduler, then ``/readyz`` → 200."""
    listening.wait(timeout=60.0)
    try:
        engine.generate([[1]], max_new_tokens=2)
    except Exception as e:  # noqa: BLE001 — the warm-up is optional, serving is not
        print(f"serving warm-up failed (the first request pays it): "
              f"{type(e).__name__}: {str(e)[:200]}", flush=True)
    finally:
        service.starting = False
        print("serving ready: /readyz now 200", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
