"""The port's library surface against the JAX package's, on the CPU: the
lazy top-level names, each subpackage's ``__all__``, the console scripts,
and the three functions behind those names that came last
(``read_checkpoint_meta``, ``architecture_summary``, ``normalize_tile``).

The JAX-only names are the ones whose job the port does otherwise: the
Flax <-> torch converters (the port's models load a ``.pth`` natively),
the Flax layer classes, and the sharding helpers of a one-process mesh.
"""

import importlib
import os
import re
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crosstalk_tpu
import crosstalk_tpu.config as jcfg
import crosstalk_tpu_torch
from crosstalk_tpu.data.transforms import normalize_tile as jax_normalize_tile
from crosstalk_tpu.models import registry as jreg
from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.data.transforms import normalize_tile
from crosstalk_tpu_torch.io.checkpoint import (
    CKPT_DIR,
    CKPT_FILE,
    PREV_FILE,
    load_checkpoint,
    read_checkpoint_meta,
    save_checkpoint,
)
from crosstalk_tpu_torch.models.registry import architecture_summary, build_model, count_params

ROOT = Path(__file__).resolve().parents[1]
JAX_ONLY_TOP = {"torch_to_flax", "flax_to_torch"}
OMITTED = {
    "models": {"BatchNorm", "ConvBlock", "DenseBNBlock"},
    "train": {"batch_sharding", "replicate_state"},
    "io": {"torch_to_flax", "flax_to_torch"},
    "parallel": {"make_global_batch"},
}
RENAMED = {"data": {"device_prefetch": "device_batches"}}
ADDED = {"train": {"finish_training_run"}, "parallel": {"replicated_forward", "rank_device"}}
SUBPACKAGES = ["data", "models", "train", "eval", "io", "ops", "serve", "parallel"]


def test_public_api_is_the_jax_one_less_its_jax_only_names():
    assert set(crosstalk_tpu_torch._PUBLIC_API) == set(crosstalk_tpu._PUBLIC_API) - JAX_ONLY_TOP
    for name, module in crosstalk_tpu_torch._PUBLIC_API.items():
        assert module == crosstalk_tpu._PUBLIC_API[name].replace(
            "crosstalk_tpu", "crosstalk_tpu_torch", 1)
    assert dir(crosstalk_tpu_torch) == sorted(crosstalk_tpu_torch.__all__)
    assert crosstalk_tpu_torch.__all__ == sorted(crosstalk_tpu_torch._PUBLIC_API) + ["__version__"]
    with pytest.raises(AttributeError, match="no attribute 'torch_to_flax'"):
        crosstalk_tpu_torch.torch_to_flax


@pytest.mark.parametrize("name", sorted(crosstalk_tpu_torch._PUBLIC_API))
def test_every_public_name_resolves_to_its_module_object(name):
    module = importlib.import_module(crosstalk_tpu_torch._PUBLIC_API[name])
    assert getattr(crosstalk_tpu_torch, name) is getattr(module, name)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_all_mirrors_the_jax_one(sub):
    jax_all = importlib.import_module(f"crosstalk_tpu.{sub}").__all__
    port = importlib.import_module(f"crosstalk_tpu_torch.{sub}")
    renamed = RENAMED.get(sub, {})
    want = {renamed.get(n, n) for n in jax_all if n not in OMITTED.get(sub, set())}
    assert set(port.__all__) == want | ADDED.get(sub, set())
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None
    for name in OMITTED.get(sub, set()) | set(renamed):
        assert f"``{name}``" in port.__doc__, f"{sub}: {name} not named in the docstring"


def _scripts():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_console_scripts_name_the_ports_counterparts():
    scripts = _scripts()
    jax_scripts = {k: v for k, v in scripts.items() if v.startswith("crosstalk_tpu.")}
    port_scripts = {k: v for k, v in scripts.items() if v.startswith("crosstalk_tpu_torch.")}
    assert len(jax_scripts) == 8 and set(scripts) == set(jax_scripts) | set(port_scripts)
    want = {k.replace("crosstalk", "crosstalk-torch", 1):
            v.replace("crosstalk_tpu", "crosstalk_tpu_torch", 1)
            for k, v in jax_scripts.items()}
    assert port_scripts == want
    for target in port_scripts.values():
        module, func = target.split(":")
        assert callable(getattr(importlib.import_module(module), func)), target


# --- read_checkpoint_meta (the cases of tests/test_training.py:1088-1170) ----

def _two_generations(run_dir):
    save_checkpoint(run_dir, {"w": torch.arange(64.0)}, {"epoch": 1})
    save_checkpoint(run_dir, {"w": torch.arange(64.0) + 1}, {"epoch": 2})
    return (os.path.join(run_dir, CKPT_DIR, CKPT_FILE),
            os.path.join(run_dir, CKPT_DIR, PREV_FILE))


def test_read_checkpoint_meta_is_load_checkpoints_meta(tmp_path):
    run_dir = str(tmp_path)
    assert read_checkpoint_meta(run_dir) is None  # no checkpoints/ dir
    os.makedirs(os.path.join(run_dir, CKPT_DIR))
    assert read_checkpoint_meta(run_dir) is None  # an empty one
    _two_generations(run_dir)
    _, meta = load_checkpoint(run_dir)
    assert read_checkpoint_meta(run_dir) == meta
    assert meta["epoch"] == 2 and "state_sha256" in meta


def test_read_checkpoint_meta_never_reads_the_state(tmp_path):
    """A corrupt state behind an intact header: load_checkpoint falls back
    to the previous generation, the meta poll still reads the current one."""
    run_dir = str(tmp_path)
    ckpt, _ = _two_generations(run_dir)
    blob = bytearray(open(ckpt, "rb").read())
    blob[-1] ^= 0xFF
    with open(ckpt, "wb") as f:
        f.write(bytes(blob))
    with pytest.warns(UserWarning, match="previous generation"):
        assert load_checkpoint(run_dir)[1]["epoch"] == 1
    assert read_checkpoint_meta(run_dir)["epoch"] == 2


def test_read_checkpoint_meta_falls_back_and_returns_none(tmp_path):
    run_dir = str(tmp_path)
    ckpt, prev = _two_generations(run_dir)
    good = open(ckpt, "rb").read()
    with open(ckpt, "wb") as f:  # bad magic -> the previous generation
        f.write(b"X" + good[1:])
    assert read_checkpoint_meta(run_dir)["epoch"] == 1
    os.remove(ckpt)  # the rotate-then-replace window
    assert read_checkpoint_meta(run_dir)["epoch"] == 1
    for path in (ckpt, prev):
        with open(path, "wb") as f:
            f.write(b"garbage")
    assert read_checkpoint_meta(run_dir) is None
    with pytest.raises(ValueError, match="unreadable"):
        load_checkpoint(run_dir)


def test_read_checkpoint_meta_never_raises_on_truncations_and_flips(tmp_path):
    """Truncations at the boundaries and at random cuts, bit flips at
    random offsets and in the meta length's high bytes (a length of
    petabytes or more): a dict or None, never an exception; with the
    previous generation intact, always a dict."""
    run_dir = str(tmp_path)
    ckpt, prev = _two_generations(run_dir)
    good = open(ckpt, "rb").read()
    rng = np.random.default_rng(4)
    magic = len(b"CTPUTORCHCKPT1\n")
    cuts = [0, 3, magic, magic + 4, len(good) - 1] + sorted(rng.integers(1, len(good), 12).tolist())
    flips = [good[:o] + bytes([good[o] ^ 0xFF]) + good[o + 1:]
             for o in rng.integers(0, len(good), 16).tolist() + [magic + 5, magic + 6, magic + 7]]
    for blob in [good[:c] for c in cuts] + flips:
        with open(ckpt, "wb") as f:
            f.write(blob)
        meta = read_checkpoint_meta(run_dir)
        assert isinstance(meta, dict) and meta["epoch"] in (1, 2)
    os.remove(prev)
    for blob in [good[:c] for c in cuts] + flips:
        with open(ckpt, "wb") as f:
            f.write(blob)
        meta = read_checkpoint_meta(run_dir)
        assert meta is None or isinstance(meta, dict)


# --- architecture_summary ----------------------------------------------------

_PARAM_LINE = re.compile(r"^  (\S+): \(([\d, ]+)\) (\w+)$")


def _sections(text):
    lines = text.splitlines()
    cut = lines.index("Parameters:")
    params = [_PARAM_LINE.match(line) for line in lines[cut + 1:-1]]
    assert lines[cut - 1] == "" and all(params), text
    sizes = sorted(int(np.prod([int(d) for d in m.group(2).split(",") if d.strip()]))
                   for m in params)
    return lines[:cut - 1], sizes, [m.group(3) for m in params], lines[-1]


@pytest.mark.parametrize("variant", ["single", "double"])
def test_architecture_summary_has_the_jax_layout(variant):
    kw = dict(initial_filters=8, num_conv_blocks=3, initial_filters_per_branch=4)
    jc = jcfg.ModelConfig(variant=variant, **kw)
    jmodel = jreg.build_model(jc)
    want = jreg.architecture_summary(jmodel, jreg.init_model(jmodel, jax.random.key(0),
                                                             image_size=32))
    model = build_model(ModelConfig(variant=variant, **kw), image_size=32)
    got = architecture_summary(model)
    head, sizes, dtypes, total = _sections(got)
    _, want_sizes, want_dtypes, want_total = _sections(want)
    assert "\n".join(head) == repr(model)
    assert sizes == want_sizes and dtypes == want_dtypes
    assert total == want_total == f"Total trainable parameters: {count_params(model):,}"
    names = [m.group(1) for m in map(_PARAM_LINE.match, got.splitlines()) if m]
    assert names == [n for n, _ in model.named_parameters()]


# --- normalize_tile ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16), (3, 2, 8, 12)])
def test_normalize_tile_matches_jax(shape):
    rng = np.random.default_rng(8)
    x = (rng.random(shape) * 7 - 2).astype(np.float32)
    if len(shape) == 4:
        x[1, 0] = 3.5  # one constant tile among varying ones
    got = normalize_tile(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_normalize_tile(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    if len(shape) == 4:
        np.testing.assert_array_equal(got[1, 0], x[1, 0])
    const = np.full(shape, -0.25, np.float32)
    np.testing.assert_array_equal(normalize_tile(torch.from_numpy(const)).numpy(), const)
