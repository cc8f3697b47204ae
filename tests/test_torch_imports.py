"""The port stands alone: importing every module of ``repro_torch`` in a
fresh interpreter loads neither ``jax`` nor the JAX package ``repro``, and
no file of the port, nor ``chip_smoke.py``, imports either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    return mods


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.launch.serve" in mods and len(mods) > 25
    assert {"repro_torch.serving." + m for m in (
        "kv_manager", "paged_kv", "batch_engine", "spec_engine",
        "resilience", "telemetry", "scheduler", "workload",
        "prefix_cache")} \
        | {"repro_torch.core.spec_decode",
           "repro_torch.kernels.paged_decode_attention",
           "repro_torch.kernels.paged_append_attention",
           "repro_torch.kernels.ssd_scan", "repro_torch.models.mamba2",
           "repro_torch.configs.registry", "repro_torch.configs.mamba2_1_3b",
           "repro_torch.configs.hymba_1_5b",
           "repro_torch.configs.phi3_mini_3_8b",
           "repro_torch.configs.starcoder2_7b",
           "repro_torch.launch.multiarch", "repro_torch.data.pipeline",
           "repro_torch.training.loss", "repro_torch.training.optimizer",
           "repro_torch.training.train_loop", "repro_torch.launch.train",
           "repro_torch.kernels.flash_attention_bwd",
           "repro_torch.kernels.paged_tp", "repro_torch.models.sharding",
           "repro_torch.serving.tp", "repro_torch.launch.mesh",
           "repro_torch.models.moe", "repro_torch.configs.granite_moe_1b",
           "repro_torch.configs.qwen3_moe_235b",
           "repro_torch.configs.whisper_base",
           "repro_torch.configs.llama_3_2_vision_11b"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for f in files:
        bad = set(_imported_roots(f)) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
