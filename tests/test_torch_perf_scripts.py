"""The port's perf scripts on the CPU at tiny sizes: ``hack/torch_step_bench.py``,
``hack/torch_mfu_probe.py``, ``hack/torch_mfu_attrib.py`` and
``hack/torch_bench.py``, each through its ``--check`` with ``--platform
cpu``, called in this process (the harness's measured run spawns the
``mnist`` job once).

- Each prints the keys of its JAX counterpart (read from the JAX script's
  literals where it prints one dict).
- The step bench's A/B pair is equal to the bit, and its
  ``--emit-matrix-seed`` file loads in the fleet's ``load_seed``, as
  ``tests/test_fleet.py`` loads the JAX script's.
- The harness's line is ``bench.py``'s, anchored on the runner's spawn.
- Without a card and without ``--platform cpu`` every script exits
  non-zero.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import ast
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from cron_operator_tpu.runtime.fleet import ThroughputMatrix

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("torch_step_bench", "torch_mfu_probe", "torch_mfu_attrib",
           "torch_bench")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_perf_{name}", ROOT / "hack" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _dict_keys(path, func=None, target=None):
    """The keys of the dict literal passed to ``json.dumps`` (``func``
    None) or assigned to ``target`` in ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if (target is None and isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
        if (target is not None and isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == target
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict literal in {path}")


def test_step_bench_check_and_matrix_seed(tmp_path, capsys):
    seed_path = tmp_path / "fleet_matrix_seed.json"
    assert _script("torch_step_bench").main(
        ["--check", "--platform", "cpu", "--emit-matrix-seed",
         str(seed_path)]) == 0
    report = _last_json(capsys)
    assert report["mode"] == "check" and report["transformer"] is None
    ab = report["external_ab"]
    assert ab["params_bit_exact"] is True
    assert ab["overlap_hidden_ms_per_step"] > 0
    assert ab["auto_steps_per_call"] == 8
    ref = _dict_keys(ROOT / "hack" / "step_bench.py", target="external_ab")
    assert set(ab) == ref
    assert set(report["fused_vs_external"]) == _dict_keys(
        ROOT / "hack" / "step_bench.py", target="fused_vs_external")
    seed = ThroughputMatrix.load_seed(str(seed_path))
    rate = ab["b_samples_per_s"]
    assert seed == {("train-small", "cpu"): rate, ("*", "cpu"): rate}
    assert ThroughputMatrix(seed).rate("eval", "cpu") == rate


def test_mfu_probe_check(capsys):
    assert _script("torch_mfu_probe").main(["--check", "--platform",
                                            "cpu"]) == 0
    out = _last_json(capsys)
    assert set(out) == _dict_keys(ROOT / "hack" / "mfu_probe.py")
    (rec,) = out["sweep"]
    assert rec["batch"] == 1 and rec["image"] == 32 and "error" not in rec
    for key in ("chain_step_ms", "dispatch_step_ms"):
        assert rec[key] is None or rec[key] > 0
    assert out["flops_per_image"] > 0 and out["peak_flops"] is None


def test_mfu_attrib_check(capsys):
    assert _script("torch_mfu_attrib").main(["--check", "--platform",
                                             "cpu"]) == 0
    out = _last_json(capsys)
    ref = {"batch", "image", "chain", "rng_ms", "rng_rbg_ms",
           "xla_fwd_flops_per_image", "fwd_ms", "fwdbwd_ms",
           "fwdbwd_nonorm_ms", "step_ms"}
    assert ref <= set(out)
    assert out["rng_rbg_ms"] is None and "rbg" in out["rng_rbg_note"]
    assert out["xla_fwd_flops_per_image"] > 0
    for key in ("rng_ms", "fwd_ms", "fwdbwd_ms", "fwdbwd_nonorm_ms",
                "step_ms"):
        assert out[key] is None or out[key] > 0


def test_bench_check_spawns_the_runner(capsys):
    assert _script("torch_bench").main(["--check", "--platform", "cpu"]) == 0
    out = _last_json(capsys)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert out["metric"] == "tick_to_first_train_step_s"
    assert out["value"] > 0 and out["unit"] == "s"
    extra = out["extra"]
    assert extra["anchor"] == "runner_spawn" and extra["model"] == "mnist"
    assert extra["steps_per_s"] > 0 and extra["xla_flops_per_step"] > 0
    for leg in ("attention_bench", "lm_bench", "decode_bench", "mfu_sweep",
                "control_plane"):
        assert "skipped" in extra[leg]


def test_decode_leg_against_the_hbm_roofline():
    bench = _script("torch_bench")
    leg = bench.decode_leg(8, {"tokens_per_s": 1000.0,
                               "decode_read_bytes_per_step": 3.35e8}, 3.35e12)
    # 8 tokens a step, 1e4 steps/s at best
    assert leg["hbm_roofline_tokens_per_s"] == 80000.0
    assert leg["pct_of_hbm_roofline"] == 1.25
    assert "pct_of_hbm_roofline" not in bench.decode_leg(
        8, {"tokens_per_s": 1.0}, None)


@pytest.mark.parametrize("name", SCRIPTS)
def test_no_card_no_cpu_request_exits_non_zero(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert _script(name).main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err
