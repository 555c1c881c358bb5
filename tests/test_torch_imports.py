"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package (nor Orbax or TensorStore, which the JAX package's checkpoints
need, nor ``transformers`` or ``safetensors``, which the JAX package's HF
import and export lean on), no source imports any of them, and its entry
points refuse to run without a card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "galvatron_tpu_torch"


#: top-level packages the port must never load
FORBIDDEN = ("jax", "galvatron_tpu", "orbax", "tensorstore", "transformers", "safetensors")
#: the same rule inside a subprocess: ``bad`` lists the loaded modules it refuses
_BAD_MODULES = ("bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                f"{FORBIDDEN!r})\n")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import galvatron_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'galvatron_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        + _BAD_MODULES +
        "print(len([m for m in sys.modules if m.startswith('galvatron_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20  # every module really was imported


#: the hybrid-parallel runtime's modules (strategy codec, ranks and groups,
#: sharding rules, collectives, the local launcher, the pipeline schedules
#: and executor, the stage division, context parallelism's ring and
#: all-to-all)
PARALLEL_MODULES = ("galvatron_tpu_torch.core.strategy", "galvatron_tpu_torch.parallel.mesh",
                    "galvatron_tpu_torch.parallel.sharding", "galvatron_tpu_torch.parallel.comm",
                    "galvatron_tpu_torch.parallel.hybrid", "galvatron_tpu_torch.parallel.launch",
                    "galvatron_tpu_torch.parallel.pipeline",
                    "galvatron_tpu_torch.parallel.pipeline_1f1b",
                    "galvatron_tpu_torch.parallel.pipeline_interleaved",
                    "galvatron_tpu_torch.search.pp_division",
                    "galvatron_tpu_torch.parallel.ring", "galvatron_tpu_torch.parallel.ulysses")
#: the profiling and search slice's modules
SEARCH_MODULES = ("galvatron_tpu_torch.search.cost_model",
                  "galvatron_tpu_torch.search.dynamic_programming",
                  "galvatron_tpu_torch.search.native",
                  "galvatron_tpu_torch.search.search_engine",
                  "galvatron_tpu_torch.search.theoretical",
                  "galvatron_tpu_torch.search.memory_fidelity",
                  "galvatron_tpu_torch.profiling.model",
                  "galvatron_tpu_torch.profiling.hardware",
                  "galvatron_tpu_torch.profiling.runtime",
                  "galvatron_tpu_torch.analysis.diagnostics",
                  "galvatron_tpu_torch.analysis.plan_check",
                  "galvatron_tpu_torch.utils.config_utils",
                  "galvatron_tpu_torch.obs.tracing")
#: the training services' modules (checkpoints, corpora, the data pipeline,
#: schedules and the loss scaler)
SERVICES_MODULES = ("galvatron_tpu_torch.core.retry", "galvatron_tpu_torch.core.checkpoint",
                    "galvatron_tpu_torch.core.data", "galvatron_tpu_torch.core.schedules",
                    "galvatron_tpu_torch.core.optim", "galvatron_tpu_torch.core.trainer",
                    "galvatron_tpu_torch.data.shards", "galvatron_tpu_torch.data.mixture",
                    "galvatron_tpu_torch.data.prefetch", "galvatron_tpu_torch.data.pipeline",
                    "galvatron_tpu_torch.bridge")
#: the generation and serving modules (the cache forwards, sampling and the
#: generation loop, both KV backends, the engine, the server, the cli)
SERVING_MODULES = ("galvatron_tpu_torch.models.generation", "galvatron_tpu_torch.serving.kv_slots",
                   "galvatron_tpu_torch.serving.paged_kv", "galvatron_tpu_torch.serving.engine",
                   "galvatron_tpu_torch.server", "galvatron_tpu_torch.cli")
#: the mixture-of-experts slice's module (the rest of it is in the runtime's)
MOE_MODULES = ("galvatron_tpu_torch.models.moe",)
#: the packed-sequence and overlap slice's modules
PACKED_OVERLAP_MODULES = ("galvatron_tpu_torch.data.packing",
                          "galvatron_tpu_torch.ops.collective_matmul")
#: the HF import / export slice's modules and the per-family entry packages
HF_MODULES = ("galvatron_tpu_torch.models.hf_io", "galvatron_tpu_torch.models.convert",
              "galvatron_tpu_torch.models.llama", "galvatron_tpu_torch.models.llama_fa",
              "galvatron_tpu_torch.models.gpt", "galvatron_tpu_torch.models.gpt_fa",
              "galvatron_tpu_torch.models.opt", "galvatron_tpu_torch.models.baichuan")
#: the encoder slice's entry packages and the image stream's loader
ENCODER_MODULES = ("galvatron_tpu_torch.models.bert", "galvatron_tpu_torch.models.vit",
                   "galvatron_tpu_torch.core.dataloader", "galvatron_tpu_torch.models.t5",
                   "galvatron_tpu_torch.parallel.pipeline_encdec")
SCANNED = sorted([str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
                 + ["chip_smoke.py", "experiments/torch_decode_profile.py"])


def test_the_scan_covers_the_parallel_modules():
    for m in PARALLEL_MODULES + SEARCH_MODULES + SERVICES_MODULES + SERVING_MODULES + (
            MOE_MODULES + PACKED_OVERLAP_MODULES + HF_MODULES + ENCODER_MODULES
            + ("galvatron_tpu_torch.data",)):
        assert m.replace(".", "/") + ".py" in SCANNED or \
            m.replace(".", "/") + "/__init__.py" in SCANNED


ALONE_MODULES = (PARALLEL_MODULES + SEARCH_MODULES + SERVICES_MODULES + SERVING_MODULES
                 + MOE_MODULES + PACKED_OVERLAP_MODULES + HF_MODULES + ENCODER_MODULES)
#: one fresh interpreter loads torch and numpy (neither is forbidden) and then
#: forks one child per module: the child imports that module first and alone
#: and reports the forbidden modules it then holds (one JSON line a module)
_ALONE = (
    "import importlib, json, os, sys\n"
    "import numpy, torch\n"
    "for module in sys.argv[1:]:\n"
    "    r, w = os.pipe()\n"
    "    pid = os.fork()\n"
    "    if pid == 0:\n"
    "        os.close(r)\n"
    "        try:\n"
    "            importlib.import_module(module)\n"
    "            " + _BAD_MODULES.replace("\n", "\n            ").rstrip(" ") +
    "            out = {'bad': bad}\n"
    "        except BaseException as e:\n"
    "            out = {'error': repr(e)}\n"
    "        os.write(w, json.dumps(out).encode())\n"
    "        os._exit(0)\n"
    "    os.close(w)\n"
    "    data = b''\n"
    "    while chunk := os.read(r, 65536):\n"
    "        data += chunk\n"
    "    os.close(r)\n"
    "    os.waitpid(pid, 0)\n"
    "    print(json.dumps(dict(json.loads(data), module=module)), flush=True)\n"
)


@pytest.fixture(scope="module")
def alone_imports():
    """{module: what its child reported}, from one fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _ALONE, *ALONE_MODULES], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    import json

    return {d["module"]: d for d in map(json.loads, r.stdout.splitlines())}


@pytest.mark.parametrize("module", ALONE_MODULES)
def test_parallel_module_alone_loads_no_jax(module, alone_imports):
    """Each module of the hybrid runtime, the search, the training services
    and generation / serving, imported first and alone in a child of a
    fresh interpreter that holds only torch and numpy (packing, the
    collective matmul, the HF import / export and the family entry packages
    too), imports cleanly and pulls in neither JAX, the JAX package, Orbax,
    TensorStore, transformers nor safetensors."""
    got = alone_imports[module]
    assert "error" not in got, got["error"]
    assert not got["bad"], got["bad"]


@pytest.mark.parametrize("path", SCANNED)
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_raises_without_a_card(no_card):
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.serving import Engine

    cfg = modeling.ModelConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                               ffn_dim=64, max_seq_len=32)
    params = modeling.init_model_params(cfg, 0, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg, kv_num_blocks=-1)


def test_generation_service_raises_without_a_card(no_card):
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.models.tokenizer import ByteTokenizer
    from galvatron_tpu_torch.server import GenerationService

    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationService(modeling.ModelConfig(), ByteTokenizer(), engine=None)


def test_cli_serve_raises_without_a_card(no_card):
    from galvatron_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["serve", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "2",
                  "--kv_num_blocks", "-1"])


def test_cli_generate_raises_without_a_card(no_card):
    from galvatron_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["generate", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "2"])


def test_cli_train_raises_without_a_card(no_card):
    from galvatron_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["train", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "2",
                  "--train_iters", "1"])


def test_build_runtime_raises_without_a_card(no_card):
    from galvatron_tpu_torch.models import modeling
    from galvatron_tpu_torch.parallel.hybrid import build_runtime

    cfg = modeling.ModelConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                               ffn_dim=64, max_seq_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_runtime(cfg)
    assert build_runtime(cfg, device="cpu").device.type == "cpu"


def test_a_rank_without_a_visible_card_raises(monkeypatch):
    """``cuda:LOCAL_RANK`` must be visible: a rank never wraps around onto
    fewer cards, and no card at all is the usual error."""
    from galvatron_tpu_torch.device import rank_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2 but only 2"):
        rank_device("cuda")
    assert rank_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        rank_device(None)


def test_cli_export_hf_raises_without_a_card(no_card, tmp_path):
    from galvatron_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["export-hf", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "2",
                  "--output_dir", str(tmp_path / "hf")])
    assert not (tmp_path / "hf").exists()


def test_cli_profile_raises_without_a_card(no_card, tmp_path):
    from galvatron_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["profile", "--num_layers", "2", "--hidden_size", "32", "--num_heads", "2",
                  "--output_prefix", str(tmp_path / "p")])
    assert not list(tmp_path.iterdir())


def test_cli_profile_hardware_raises_without_a_card(no_card, tmp_path):
    from galvatron_tpu_torch import cli

    out = tmp_path / "hw.json"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["profile-hardware", "--hardware_output_path", str(out)])
    assert not out.exists()


def test_cli_search_on_analytic_costs_needs_no_device(no_card, tmp_path):
    """A search on analytic costs (or profile files) touches no device: it
    runs without a card under the default --device cuda."""
    from galvatron_tpu_torch import cli

    out = tmp_path / "plan.json"
    assert cli.main(["search", "--num_layers", "4", "--hidden_size", "64", "--num_heads",
                     "4", "--ffn_dim", "128", "--vocab_size", "128", "--seq_length", "32",
                     "--num_devices", "8", "--analytic_costs", "1", "--settle_bsz", "8",
                     "--memory_constraint_gb", "1", "--output_config_path", str(out)]) == 0
    assert out.exists()
    assert cli.main(["check-plan", str(out), "--strict", "1"]) == 0


def test_cli_search_profiling_in_process_raises_without_a_card(no_card, tmp_path):
    from galvatron_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["search", "--num_layers", "2", "--hidden_size", "32", "--num_heads", "2",
                  "--num_devices", "1", "--settle_bsz", "8",
                  "--output_config_path", str(tmp_path / "plan.json")])
