#!/usr/bin/env python3
"""The spread of the PyTorch port's MoE expert-time fit on the card, beside
the reference's fit, and the plan search's decision threshold on it.

    python experiments/torch_moe_fit_spread.py [--batches 4,16] [--reps 6] [--out PATH]

The model is ``chip_smoke.py``'s phase 18 (d) one (llama-7b's family at
h 1024, 8 heads of 128, ffn 2816, 8 switch experts, 2 layers, sequence
512). For each profile batch and each of ``--reps`` repetitions it reads:

- the port's fit: ``profiling.model.profile_model`` as ``cli profile``
  runs it (both widths timed at the same depth, the median of several
  windows each);
- the reference's fit (``galvatron_tpu/profiling/model.py``): the
  per-layer differences of single-window iteration times at depths 1 and 2,
  at the full width and at a quarter of it.

Each reading goes through ``cli search --enable_ep 1`` for two devices at
the phase's settings; the search's expert-parallel degree is recorded. The
threshold is bisected on the first repetition's profile of each batch: the
least expert-time fraction (and the expert ms a sample, that fraction of
the layer's forward) for which the search splits the experts.

Prints one JSON line (and writes it to ``--out`` when given). Needs a card;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODEL = ["--model_size", "llama-7b", "--num_layers", "2", "--moe_experts", "8", "--seq_length",
         "512", "--hidden_size", "1024", "--num_heads", "8", "--ffn_dim", "2816"]
HARDWARE = os.path.join(ROOT, "configs", "hardware", "reference_2x8_ib.json")
SETTLE_BSZ = 4


def _reference_fit(pm, cfg, bsz, seq, device):
    """The reference's two-point fit, single windows: (fraction or None,
    the layer's fwd ms a sample)."""
    f1, f2 = cfg.ffn, max(256, (cfg.ffn // 4 + 255) // 256 * 256)
    t = {(f, n): pm._iter_time_ms(cfg.replace(num_layers=n, ffn_dim=f), bsz, seq, device)
         for f in (f1, f2) for n in (1, 2)}
    fwd = max(1e-4, (t[f1, 2] - t[f1, 1]) / bsz / 3.0)
    fwd_small = max(1e-4, (t[f2, 2] - t[f2, 1]) / bsz / 3.0)
    slope = (fwd - fwd_small) / (f1 - f2)
    return (min(slope * f1 / fwd, 0.99) if slope > 0 else None), fwd


def _search_ep(cli, prefix, fraction, fwd_ms, tmpdir):
    """The largest ep of the searched plan on the profile at ``prefix`` with
    its layer's fwd ms a sample and expert-time fraction replaced."""
    from galvatron_tpu_torch.core.strategy import HybridParallelConfig

    paths = {}
    for kind in ("computation", "memory"):
        with open(f"{prefix}_{kind}.json") as f:
            prof = json.load(f)
        if kind == "computation":
            prof["layertype_0"] = fwd_ms
        else:
            prof["layertype_0"]["moe_expert_time_fraction"] = fraction
        paths[kind] = os.path.join(tmpdir, f"search_{kind}.json")
        with open(paths[kind], "w") as f:
            json.dump(prof, f)
    plan = os.path.join(tmpdir, "plan.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["search", *MODEL, "--num_devices", "2", "--settle_bsz", str(SETTLE_BSZ),
                       "--memory_constraint_gb", "40", "--mixed_precision", "fp32",
                       "--enable_ep", "1", "--time_profile_path", paths["computation"],
                       "--memory_profile_path", paths["memory"], "--hardware_profile_path",
                       HARDWARE, "--output_config_path", plan])
    if rc != 0:
        raise RuntimeError(f"cli search returned {rc}")
    return max(s.ep for s in HybridParallelConfig.load(plan).layer_strategies)


def _threshold(cli, prefix, fwd_ms, tmpdir, steps=10):
    """The least fraction in [0, 0.99] for which the search takes ep > 1 at
    the layer's ``fwd_ms`` (bisection; None when even 0.99 takes no ep)."""
    lo, hi = 0.0, 0.99
    if _search_ep(cli, prefix, hi, fwd_ms, tmpdir) <= 1:
        return None
    if _search_ep(cli, prefix, lo, fwd_ms, tmpdir) > 1:
        return 0.0
    for _ in range(steps):
        mid = (lo + hi) / 2
        if _search_ep(cli, prefix, mid, fwd_ms, tmpdir) > 1:
            hi = mid
        else:
            lo = mid
    return hi


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="4,16")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from galvatron_tpu_torch import cli
    from galvatron_tpu_torch.core.arguments import (
        initialize_galvatron,
        model_config_from_args,
        resolve_execution_config,
    )
    from galvatron_tpu_torch.profiling import model as pm
    from galvatron_tpu_torch.utils.config_utils import save_profiled_model

    device = torch.device("cuda")
    ns = initialize_galvatron("profile", MODEL)
    cfg = resolve_execution_config(model_config_from_args(ns), ns, device)
    seq = cfg.max_seq_len
    res = {"card": torch.cuda.get_device_name(0), "model": MODEL, "settle_bsz": SETTLE_BSZ,
           "fit_windows": pm._FIT_WINDOWS, "batches": {}}
    with tempfile.TemporaryDirectory() as tmpdir:
        prefix = os.path.join(tmpdir, "profile")
        for bsz in (int(b) for b in args.batches.split(",")):
            rows = []
            for rep in range(args.reps):
                with contextlib.redirect_stdout(io.StringIO()):
                    costs = pm.profile_model(cfg, bsz=bsz, seq=seq, device=device)
                save_profiled_model(costs, prefix + "_computation.json", prefix + "_memory.json")
                lt = costs.layer_types[0]
                ref, ref_fwd = _reference_fit(pm, cfg, bsz, seq, device)
                row = {"port": lt.moe_expert_time_fraction, "port_fwd_ms": lt.fwd_ms_per_sample,
                       "reference": ref, "reference_fwd_ms": ref_fwd,
                       "port_ep": _search_ep(cli, prefix, lt.moe_expert_time_fraction,
                                             lt.fwd_ms_per_sample, tmpdir),
                       "reference_ep": _search_ep(cli, prefix, ref, ref_fwd, tmpdir)}
                if rep == 0:
                    thr = _threshold(cli, prefix, lt.fwd_ms_per_sample, tmpdir)
                    res["batches"][str(bsz)] = {
                        "threshold_fraction": thr, "threshold_fwd_ms": lt.fwd_ms_per_sample,
                        "threshold_expert_ms": (None if thr is None
                                                else thr * lt.fwd_ms_per_sample)}
                rows.append(row)
                print(f"batch {bsz} rep {rep}: {json.dumps(row)}", file=sys.stderr, flush=True)
            res["batches"][str(bsz)]["reps"] = rows
            for k in ("port", "reference"):
                vals = [r[k] for r in rows]
                num = [v for v in vals if v is not None]
                res["batches"][str(bsz)][k + "_summary"] = {
                    "min": min(num, default=None), "max": max(num, default=None),
                    "none": len(vals) - len(num),
                    "no_ep": sum(r[k + "_ep"] <= 1 for r in rows)}
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
