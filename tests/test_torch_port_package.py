"""Package hygiene of the PyTorch port: it imports nothing of JAX or of the
JAX package, nor the ``msgpack`` package (the card's host has none; the
port reads flax msgpack files with its own decoder), and its entry points
refuse to fall back to the CPU."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "crosstalk_tpu_torch"
# `crosstalk_tpu_torch` starts with `crosstalk_tpu`: the JAX package is
# `crosstalk_tpu` followed by a dot or the end of the name
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|msgpack|crosstalk_tpu)(\.|$)")


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


@pytest.mark.parametrize("name,forbidden", [
    ("crosstalk_tpu", True),
    ("crosstalk_tpu.config", True),
    ("jax.numpy", True),
    ("flax", True),
    ("optax", True),
    ("msgpack", True),
    ("msgpack.fallback", True),
    ("crosstalk_tpu_torch", False),
    ("crosstalk_tpu_torch.io.flax_msgpack", False),
    ("crosstalk_tpu_torch.ops.input_block", False),
    ("jaxtyping", False),
])
def test_forbidden_prefix_rule(name, forbidden):
    assert bool(FORBIDDEN.match(name)) == forbidden


def test_fresh_process_check_covers_the_serving_modules():
    names = set(_module_names())
    assert {
        "crosstalk_tpu_torch.serve", "crosstalk_tpu_torch.serve.batcher",
        "crosstalk_tpu_torch.serve.client", "crosstalk_tpu_torch.serve.predictor",
        "crosstalk_tpu_torch.serve.server", "crosstalk_tpu_torch.serve.wire",
        "crosstalk_tpu_torch.io.export", "crosstalk_tpu_torch.cli.serve",
        "crosstalk_tpu_torch.cli.predict", "crosstalk_tpu_torch.cli.remote_eval",
    } <= names


def test_fresh_process_check_covers_the_training_modules():
    names = set(_module_names())
    assert {
        "crosstalk_tpu_torch.train", "crosstalk_tpu_torch.train.loop",
        "crosstalk_tpu_torch.train.steps", "crosstalk_tpu_torch.train.schedules",
        "crosstalk_tpu_torch.io.checkpoint", "crosstalk_tpu_torch.cli.train",
        "crosstalk_tpu_torch.data.synthetic",
    } <= names


def test_fresh_process_check_covers_the_int8_and_export_modules():
    names = set(_module_names())
    assert {
        "crosstalk_tpu_torch.eval.int8_forward", "crosstalk_tpu_torch.io.export",
        "crosstalk_tpu_torch.tools.export_model",
    } <= names


def test_fresh_process_check_covers_the_parallel_and_debug_modules():
    names = set(_module_names())
    assert {
        "crosstalk_tpu_torch.parallel", "crosstalk_tpu_torch.parallel.distributed",
        "crosstalk_tpu_torch.parallel.mesh", "crosstalk_tpu_torch.utils",
        "crosstalk_tpu_torch.utils.profiling", "crosstalk_tpu_torch.tools.multirank",
    } <= names


def test_fresh_process_check_covers_the_host_and_workflow_modules():
    names = set(_module_names())
    assert {
        "crosstalk_tpu_torch.__main__", "crosstalk_tpu_torch.native",
        "crosstalk_tpu_torch.data.native_loader", "crosstalk_tpu_torch.data.pipeline",
        "crosstalk_tpu_torch.data.synthetic", "crosstalk_tpu_torch.data.remix",
        "crosstalk_tpu_torch.cli.analyse", "crosstalk_tpu_torch.cli.doctor",
        "crosstalk_tpu_torch.tools.make_dataset", "crosstalk_tpu_torch.tools.serve_bench",
        "crosstalk_tpu_torch.tools.scale_bench", "crosstalk_tpu_torch.tools.make_pretrained",
        "crosstalk_tpu_torch.tools.sweep", "crosstalk_tpu_torch.tools.distill",
        "crosstalk_tpu_torch.tools.unmix_demo",
    } <= names


def test_fresh_process_check_covers_the_bench():
    assert "crosstalk_tpu_torch.tools.bench" in set(_module_names())


PROBES = ["int8_tier_probe", "int8_probe", "bwd_audit", "two_branch_sol_probe",
          "two_branch_input_probe", "grouped_trunk_probe"]


def test_fresh_process_check_covers_the_probes():
    assert {f"crosstalk_tpu_torch.tools.{p}" for p in PROBES} <= set(_module_names())


def test_lazy_top_level_names_load_no_jax_in_a_fresh_process():
    """``import crosstalk_tpu_torch`` imports no torch; each public name
    resolves on first use, and none of them loads JAX."""
    code = (
        "import re, sys\n"
        "import crosstalk_tpu_torch as c\n"
        "assert 'torch' not in sys.modules, 'torch imported with the package'\n"
        "assert callable(c.make_fast_forward) and 'torch' in sys.modules\n"
        "for name in c._PUBLIC_API:\n"
        "    getattr(c, name)\n"
        f"bad = sorted(m for m in sys.modules if re.match({FORBIDDEN.pattern!r}, m))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_loads_no_jax_in_a_fresh_process():
    mods = _module_names() + ["chip_smoke"]
    code = (
        "import importlib, re, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if re.match({FORBIDDEN.pattern!r}, m))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_source_scan_finds_no_jax_import():
    offenders = []
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if FORBIDDEN.match(n)]
    assert offenders == []


def test_kernel_source_ships_as_package_data():
    text = (ROOT / "pyproject.toml").read_text()
    assert '"crosstalk_tpu_torch" = ["csrc/*.cu", "native/*.cpp"]' in text
    assert (PKG / "csrc" / "input_block.cu").exists()
    assert (PKG / "native" / "tile_loader.cpp").exists()


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    from crosstalk_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(name)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")


@pytest.mark.parametrize("tool,argv", [
    ("make_pretrained", ["-m", "M", "-s", "S"]),
    ("sweep", ["-m", "M", "-s", "S"]),
    ("distill", ["-m", "M", "-s", "S", "-p", "t.pth"]),
    ("scale_bench", ["-n", "2"]),
    ("serve_bench", []),
    ("unmix_demo", ["-p", "m.pth", "--pairs", "1", "--size", "16"]),
    ("int8_tier_probe", ["--data_dir", "no_such_dir"]),
    ("int8_tier_probe", ["-p", "m.pth", "-o", "double"]),
    ("int8_probe", []),
    ("bwd_audit", ["-o", "double"]),
    ("two_branch_sol_probe", []),
    ("two_branch_input_probe", ["--size", "16"]),
    ("grouped_trunk_probe", []),
])
def test_workflow_tools_without_device_raise_on_a_cudaless_host(tool, argv, monkeypatch,
                                                                tmp_path):
    """Each tool and probe runs on the card unless given ``--device cpu``:
    without a card it raises before it trains, serves, measures or writes
    anything."""
    import importlib

    main = importlib.import_module(f"crosstalk_tpu_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv + (["--output_base", str(tmp_path)] if tool in ("sweep", "distill") else []))
    assert not list(tmp_path.glob("training_run_*"))


def test_eval_cli_without_device_raises_on_a_cudaless_host(monkeypatch, tmp_path):
    from crosstalk_tpu_torch.cli.evaluate import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-m", str(tmp_path), "-s", str(tmp_path), "-p", "none.pth",
              "--output_base", str(tmp_path)])
    assert not list(tmp_path.glob("eval_run_*"))


def test_train_cli_without_device_raises_on_a_cudaless_host(monkeypatch, tmp_path):
    from crosstalk_tpu_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-m", str(tmp_path), "-s", str(tmp_path), "--output_base", str(tmp_path)])
    assert not list(tmp_path.glob("training_run_*"))


def test_multirank_tool_without_device_raises_on_a_cudaless_host(monkeypatch, tmp_path):
    """The tool's ranks run on the card unless ``--device cpu`` is given:
    it raises before it joins a process group or writes anything."""
    from crosstalk_tpu_torch.tools.multirank import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["step", "--rank", "0", "--world", "1", "--port", "1", "--out", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("flags", [
    ["--num_devices", "0"],
    ["--num_devices", "-2"],
    ["--num_devices", "100000"],
    ["--batch_size", "0"],
    ["-o", "double", "--num_conv_blocks", "4"],
])
def test_eval_cli_rejects_what_is_not_ported(flags, tmp_path, capsys):
    """Usage errors: a device count outside 1..visible (the JAX CLI's
    check), a non-positive batch, a depth flag on the two-branch model."""
    from crosstalk_tpu_torch.cli.evaluate import main

    rc = main(["-m", str(tmp_path), "-s", str(tmp_path), "-p", "none.pth",
               "--device", "cpu", "--output_base", str(tmp_path), *flags])
    assert rc == 1
    assert "Error" in capsys.readouterr().out
    assert not list(tmp_path.glob("eval_run_*"))
