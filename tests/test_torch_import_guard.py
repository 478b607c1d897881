"""The port imports nothing of JAX and nothing of the JAX package."""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "cron_operator_tpu")
FILES = sorted((ROOT / "cron_operator_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "hack" / "torch_serving_ab.py",
    ROOT / "hack" / "torch_train_ab.py", ROOT / "hack" / "torch_mesh_cards.py",
    ROOT / "hack" / "torch_mesh_readings.py",
    ROOT / "hack" / "torch_gloo_cuda_probe.py",
    # the image jobs' two-rank readings against one rank, bf16 and f32
    ROOT / "hack" / "torch_image_mesh_sweep.py",
    # the cuDNN mode's effect and cost, and the split's gradient on the CPU
    ROOT / "hack" / "torch_cudnn_modes.py",
    ROOT / "hack" / "torch_resnet_split_cpu.py",
    # the perf tooling: the harness, the step bench and the MFU scripts
    ROOT / "hack" / "torch_bench.py", ROOT / "hack" / "torch_step_bench.py",
    ROOT / "hack" / "torch_mfu_probe.py", ROOT / "hack" / "torch_mfu_attrib.py",
    # the rank bodies of the gloo worlds import the port alone, and the
    # test helper that sets an xdist worker's torch threads torch alone
    ROOT / "tests" / "torch_mesh_ranks.py", ROOT / "tests" / "torch_threads.py",
    # the meshed step captured over NCCL: its warm-up probe and card test
    ROOT / "hack" / "torch_graph_warmup_probe.py",
    ROOT / "tests" / "test_torch_mesh_graph_cuda.py",
    # the decode kernel's card test
    ROOT / "tests" / "test_torch_decode_attention_cuda.py",
    # the GroupNorm kernels' card test
    ROOT / "tests" / "test_torch_group_norm_cuda.py",
    # the loss kernels' card test
    ROOT / "tests" / "test_torch_softmax_xent_cuda.py",
    # the cluster kernels' sweep of cluster sizes
    ROOT / "hack" / "torch_cluster_sweep.py",
    # the LayerNorm kernels' card test and the backward's grid sweep
    ROOT / "tests" / "test_torch_layer_norm_cuda.py",
    ROOT / "hack" / "torch_layer_norm_sweep.py",
    # the flash kernels at lengths no tile divides: their card test, and
    # the kernels' A/B between checkouts
    ROOT / "tests" / "test_torch_flash_ragged_cuda.py",
    ROOT / "hack" / "torch_flash_ab.py",
    # the residual add folded into the LayerNorm pair and the serving
    # entries' prefill graphs (CPU), and the graphs' card test
    ROOT / "tests" / "test_torch_layer_norm_fold.py",
    ROOT / "tests" / "test_torch_graphs_cuda.py",
]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    for name in _imported(ast.parse(path.read_text(), str(path))):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, cron_operator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
