"""Resuming on the port a run dir the JAX package trained, on the CPU.

The JAX train CLI trains one epoch on 24 seeded 32 px pairs (``-b 8``,
f32, dropout 0) for a width-8 single-branch model with 3 blocks and a
width-4 two-branch one; its run dir is then read by the port:

  * ``io/flax_msgpack.msgpack_restore`` against flax's own
    ``msgpack_restore``: every leaf's dtype, shape and bytes equal;
  * ``load_checkpoint`` (current and legacy two-file format): parameters,
    BN statistics, Adam moments and step counts bitwise equal to the JAX
    state after layout conversion; its meta and ``read_checkpoint_meta``
    equal the JAX package's;
  * one train step after the resume against the JAX step from the same
    state and batch (flips off, dropout 0, f32): the parameters within 1e-5
    relative (L2 over every compared leaf) and every element within 0.05 x
    lr, apart from the biases a BatchNorm directly follows (their gradient
    is 0 up to rounding, so Adam moves them by a rounding-driven direction,
    as in tests/test_torch_port_train_step.py). Elementwise 1e-5 does not
    hold: JAX's f32 BatchNorm takes E[x^2] - E[x]^2, its gradients sit
    ~5e-4 relative from float64, and the BN shifts, whose values are of
    order lr after two steps, move by up to 0.02 x lr between the packages
    (measured). The BN running statistics the step updated are held within
    1e-5 of each leaf's largest magnitude;
  * the train CLI's ``--resume --device cpu``, the fallback across formats,
    and ``tests/jax_format.py``'s JAX-format writer (which the card tests
    use) byte for byte against the JAX package's ``save_checkpoint``.
"""

import glob
import json
import os
import shutil
import struct
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import crosstalk_tpu.config as jcfg
from crosstalk_tpu.io import checkpoint as jck
from crosstalk_tpu.io.torch_convert import flax_to_torch
from crosstalk_tpu.models import registry as jreg
from crosstalk_tpu.train import steps as jsteps
from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
from crosstalk_tpu_torch.io import checkpoint
from crosstalk_tpu_torch.io.flax_msgpack import msgpack_restore
from crosstalk_tpu_torch.io.torch_convert import from_jax_train_state
from crosstalk_tpu_torch.models.registry import build_model
from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step
from tests import jax_format
from tests.conftest import make_synthetic_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
SMALL = {"single": dict(initial_filters=8, num_conv_blocks=3),
         "double": dict(initial_filters_per_branch=4)}
FLAGS = {"single": ["--initial_filters", "8", "--num_conv_blocks", "3"],
         "double": ["--initial_filters", "4"]}
JAX_MAGIC_LEN = 10  # b"CTPUCKPT1\n"
# one step's elementwise bound, in units of the learning rate: moments that
# were dropped or reordered move an element by O(lr)
STEP_ELEMENT_TOL = 0.05


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch of the JAX train CLI per variant -> (data dirs, {variant:
    run dir})."""
    from crosstalk_tpu.cli.train import main as jax_train

    root = tmp_path_factory.mktemp("jax_runs")
    mixed, source = make_synthetic_dataset(str(root), n=24, size=SIZE, seed=5)
    dirs = {}
    for variant in ("single", "double"):
        base = str(root / variant)
        assert jax_train(["-m", mixed, "-s", source, "-b", "8", "-n", "1", "-o", variant,
                          "--compute_dtype", "f32", "--dropout", "0", "-j", "2",
                          "--output_base", base, *FLAGS[variant]]) == 0
        (dirs[variant],) = glob.glob(os.path.join(base, "training_run_*"))
    return (mixed, source), dirs


def copy_run(run_dir, dest):
    """A copy of a run dir under ``dest`` with the same name (the train CLI
    reads the run's timestamp from it)."""
    out = os.path.join(str(dest), os.path.basename(run_dir))
    shutil.copytree(run_dir, out)
    return out


def jax_model_and_template(variant):
    jmodel = jreg.build_model(jcfg.ModelConfig(variant=variant, compute_dtype="f32",
                                               dropout_single=0.0, dropout_double=0.0,
                                               **SMALL[variant]))
    variables = jreg.init_model(jmodel, jax.random.key(0), image_size=SIZE)
    tx = jsteps.make_optimizer(jcfg.OptimConfig())
    return jmodel, tx, jsteps.init_train_state(jmodel, variables, tx)


def jax_state(run_dir, variant):
    jmodel, tx, template = jax_model_and_template(variant)
    state, meta = jck.load_checkpoint(run_dir, template)
    return jmodel, tx, state, meta


def port_state(variant, payload):
    model = build_model(ModelConfig(variant=variant, compute_dtype="f32", dropout_single=0.0,
                                    dropout_double=0.0, **SMALL[variant]), image_size=SIZE)
    state = init_train_state(model, OptimConfig())
    checkpoint.restore_state(state, payload)
    return state


def assert_restores_the_jax_state(payload, jstate, variant):
    """params + batch stats, Adam moments and step counts bitwise."""
    want = flax_to_torch({"params": jstate.params, "batch_stats": jstate.batch_stats}, variant)
    for name, value in payload["model"].items():
        if not name.endswith("num_batches_tracked"):
            assert value.dtype == torch.float32
            assert np.array_equal(value.numpy(), np.asarray(want[name])), name
    adam = jstate.opt_state[1]
    moments = [flax_to_torch({"params": m, "batch_stats": jstate.batch_stats}, variant)
               for m in (adam.mu, adam.nu)]
    state = port_state(variant, payload)
    opt = state.optimizer.state_dict()["state"]
    names = [n for n, _ in state.model.named_parameters()]
    assert sorted(opt) == list(range(len(names)))
    for i, name in enumerate(names):
        assert np.array_equal(opt[i]["exp_avg"].numpy(), np.asarray(moments[0][name])), name
        assert np.array_equal(opt[i]["exp_avg_sq"].numpy(), np.asarray(moments[1][name])), name
        assert opt[i]["step"].device.type == "cpu"
        assert float(opt[i]["step"]) == int(adam.count)
    assert payload["step"] == state.step == int(jstate.step) == 2


def state_bytes(path):
    with open(path, "rb") as f:
        blob = f.read()
    (n,) = struct.unpack("<Q", blob[JAX_MAGIC_LEN:JAX_MAGIC_LEN + 8])
    return blob[JAX_MAGIC_LEN + 8 + n:]


def assert_leaves_equal(want, got, path=""):
    if isinstance(want, dict):
        assert list(want) == list(got), path
        for k in want:
            assert_leaves_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), path
        for a, b in zip(want, got):
            assert_leaves_equal(a, b, path)
    elif isinstance(got, torch.Tensor):  # a bf16 leaf
        arr = np.asarray(want)
        assert arr.dtype.name == "bfloat16" and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == arr.shape, path
        assert np.array_equal(got.view(torch.int16).numpy(), arr.view(np.int16)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


# --- (a) the decoder ---------------------------------------------------------

def _tree(kind):
    rng = np.random.default_rng(3)
    if kind == "f32":
        return {"params": {"Conv_0": {"kernel": rng.standard_normal((3, 3, 2, 8)).astype(np.float32),
                                      "bias": np.zeros((8,), np.float32)}},
                "big": rng.standard_normal((70, 70)).astype(np.float32)}
    if kind == "int32_scalars":
        return {"step": np.asarray(7, np.int32), "count": np.int32(-3),
                "s64": np.int64(2 ** 40), "u8": np.uint8(200), "f64": np.float64(0.1)}
    if kind == "bf16":
        return {"w": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
                "s": jnp.asarray(1.5, jnp.bfloat16)}
    if kind == "msgpack_types":
        return {"none": None, "t": True, "f": False, "ints": [0, 127, 128, 255, 256, 65535,
                                                             65536, 2 ** 32, -1, -32, -33,
                                                             -129, -32769, -2 ** 40],
                "floats": [0.5, -1e300], "str": "x" * 40, "long": "y" * 300,
                "bin": b"\x00\x01\x02", "complex": 3 + 4j, "empty": {}, "f16": np.float16(2.5),
                "zero_size": np.zeros((0, 3), np.float64), "bools": np.array([True, False]),
                "wide": {f"k{i}": np.asarray(i, np.int32) for i in range(20)}}
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["f32", "int32_scalars", "bf16", "msgpack_types"])
def test_decoder_equals_flax_msgpack_restore(kind):
    data = serialization.msgpack_serialize(_tree(kind))
    assert_leaves_equal(serialization.msgpack_restore(data), msgpack_restore(data))


def test_decoder_reassembles_chunked_arrays(monkeypatch):
    """flax splits leaves above MAX_CHUNK_SIZE bytes; shrunk here so a
    small leaf takes the chunked form."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((7, 9)).astype(np.float32),
            "inner": {"b": jnp.asarray(rng.standard_normal((50,)), jnp.bfloat16)}}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_restore(data)
    assert_leaves_equal(serialization.msgpack_restore(data), got)
    assert got["w"].shape == (7, 9) and np.array_equal(got["w"], tree["w"])


def test_decoder_views_aligned_leaves_and_refuses_bad_data():
    arr = np.arange(1000, dtype=np.float32)
    for key in ("a", "ab", "abc", "abcd"):  # four offsets of the array bytes
        data = serialization.msgpack_serialize({key: arr})
        got = msgpack_restore(data)[key]
        assert np.array_equal(got, arr) and got.flags.aligned
        # a view of the input buffer where its offset is aligned, else a copy
        address = np.frombuffer(data, np.uint8).ctypes.data + data.index(arr.tobytes())
        assert (got.base is not None) == (address % 4 == 0)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-10])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="ext code 5"):
        msgpack_restore(b"\x81\xa1x\xd4\x05\x00")
    with pytest.raises(ValueError, match="not msgpack"):
        msgpack_restore(b"\xc1")


# --- (b) a JAX checkpoint restores bitwise ------------------------------------

@pytest.mark.parametrize("variant", ["single", "double"])
def test_jax_checkpoint_restores_bitwise(runs, variant):
    _, dirs = runs
    run_dir = dirs[variant]
    payload, meta = checkpoint.load_checkpoint(run_dir)
    _, _, jstate, jmeta = jax_state(run_dir, variant)
    assert_restores_the_jax_state(payload, jstate, variant)
    assert meta.pop("source_format") == "jax" and meta.pop("source_file") == "train_ckpt.bin"
    assert meta == jmeta and meta["epoch"] == 1
    assert checkpoint.read_checkpoint_meta(run_dir) == jck.read_checkpoint_meta(run_dir)
    assert "rng" not in payload  # the JAX key does not carry over


# --- (c) the legacy two-file format --------------------------------------------

def legacy_copy(run_dir, dest, with_digest=True):
    """The run's state and meta in the JAX package's two-file format."""
    out = copy_run(run_dir, dest)
    ckpt = os.path.join(out, "checkpoints")
    meta = jck.read_checkpoint_meta(out)
    with open(os.path.join(ckpt, "train_state.msgpack"), "wb") as f:
        f.write(state_bytes(os.path.join(ckpt, "train_ckpt.bin")))
    if not with_digest:
        meta.pop("state_sha256")
    with open(os.path.join(ckpt, "train_meta.json"), "w") as f:
        json.dump(meta, f)
    os.remove(os.path.join(ckpt, "train_ckpt.bin"))
    return out


@pytest.mark.parametrize("variant,with_digest", [("single", True), ("double", True),
                                                 ("single", False)])
def test_legacy_two_file_format_restores_bitwise(runs, tmp_path, variant, with_digest):
    _, dirs = runs
    run_dir = legacy_copy(dirs[variant], tmp_path, with_digest)
    payload, meta = checkpoint.load_checkpoint(run_dir)
    _, _, jstate, jmeta = jax_state(run_dir, variant)
    assert_restores_the_jax_state(payload, jstate, variant)
    assert meta.pop("source_format") == "jax_legacy"
    assert meta.pop("source_file") == "train_state.msgpack"
    assert meta == jmeta
    assert checkpoint.read_checkpoint_meta(run_dir) == jck.read_checkpoint_meta(run_dir)


def test_torn_legacy_pair_raises(runs, tmp_path):
    _, dirs = runs
    run_dir = legacy_copy(dirs["single"], tmp_path)
    path = os.path.join(run_dir, "checkpoints", "train_state.msgpack")
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="torn legacy checkpoint") as err:
        checkpoint.load_checkpoint(run_dir)
    assert "delete" not in str(err.value).lower()


# --- (d) the first step after the resume ------------------------------------

def shadowed_biases(variant):
    if variant == "single":
        return ({f"conv_layers.{4 * k}.bias" for k in range(3)}
                | {"fc_layers.1.bias", "fc_layers.5.bias"})
    return ({f"{br}_branch.conv_blocks.{4 * k}.bias"
             for br in ("bleed", "source") for k in range(4)}
            | {"regression_head.fc_layers.1.bias", "regression_head.fc_layers.5.bias"})


@pytest.mark.parametrize("variant", ["single", "double"])
def test_step_after_resume_matches_the_jax_step(runs, variant):
    _, dirs = runs
    run_dir = dirs[variant]
    jmodel, tx, jstate, _ = jax_state(run_dir, variant)
    payload, _ = checkpoint.load_checkpoint(run_dir)
    state = port_state(variant, payload)
    step = make_train_step(state, compute_dtype="f32", augment=False)
    jstep = jsteps.make_train_step(jmodel, tx, augment=False)

    rng = np.random.default_rng(11)
    raw = (rng.random((8, SIZE, SIZE, 2)) * 1800 + 100).astype(np.float32)
    y = rng.uniform(0, 0.5, (8, 1)).astype(np.float32)
    lr = 1e-3
    jstate, jloss = jstep(jstate, jnp.asarray(raw), jnp.asarray(y), np.float32(lr),
                          jax.random.key(0))
    loss = step(torch.from_numpy(raw), torch.from_numpy(y), lr)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == int(jstate.step) == 3

    want = flax_to_torch({"params": jstate.params, "batch_stats": jstate.batch_stats}, variant)
    skip = shadowed_biases(variant)
    sq_diff = sq_norm = 0.0
    compared = 0
    for name, p in state.model.named_parameters():
        if name in skip:
            continue
        diff = p.detach().numpy().astype(np.float64) - np.asarray(want[name], np.float64)
        sq_diff += float((diff ** 2).sum())
        sq_norm += float((np.asarray(want[name], np.float64) ** 2).sum())
        worst = float(np.abs(diff).max())
        assert worst <= STEP_ELEMENT_TOL * lr, f"{name}: max |diff| {worst:.2e}"
        compared += 1
    assert compared >= 12
    rel = (sq_diff / sq_norm) ** 0.5
    assert rel <= 1e-5, f"parameters after the step: relative L2 difference {rel:.2e}"
    # the BN running statistics the step updated, against JAX's batch_stats:
    # each within 1e-5 of its leaf's largest magnitude (measured: 3.7e-6 at
    # worst), and moved by the step, so the comparison sees the update
    stats = 0
    for name, b in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            got, ref = b.numpy().astype(np.float64), np.asarray(want[name], np.float64)
            worst = float(np.abs(got - ref).max())
            assert worst <= 1e-5 * float(np.abs(ref).max()), f"{name}: max |diff| {worst:.2e}"
            assert not torch.equal(b, payload["model"][name]), name
            stats += 1
    assert stats >= 10


# --- (e) the train CLI -------------------------------------------------------

@pytest.mark.parametrize("variant", ["single", "double"])
def test_cli_resume_continues_the_jax_run(runs, tmp_path, variant, capsys):
    from crosstalk_tpu_torch.cli.train import main as port_train

    (mixed, source), dirs = runs
    run_dir = copy_run(dirs[variant], tmp_path)
    jax_file = os.path.join(run_dir, "checkpoints", "train_ckpt.bin")
    jax_bytes = open(jax_file, "rb").read()
    (log,) = glob.glob(os.path.join(run_dir, "training_log_*.csv"))
    jax_rows = open(log).read().splitlines()
    assert port_train(["-m", mixed, "-s", source, "-n", "2", "--resume", run_dir,
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Resumed a JAX-format checkpoint (train_ckpt.bin) at epoch 1, step 2" in out
    rows = open(log).read().splitlines()
    assert rows[:6] == jax_rows and len(rows) == 7 and rows[6].startswith("2,")
    ckpt = os.path.join(run_dir, "checkpoints")
    assert open(os.path.join(ckpt, "train_ckpt.jax.bin"), "rb").read() == jax_bytes
    assert open(os.path.join(ckpt, "train_ckpt.prev.bin"), "rb").read() == jax_bytes
    payload, meta = checkpoint.load_checkpoint(run_dir)
    assert "source_format" not in meta and meta["epoch"] == 2
    assert meta["global_step"] == payload["step"] == 4
    assert open(os.path.join(run_dir, "params_resume.txt")).read()
    assert glob.glob(os.path.join(run_dir, "best_model_*.pth"))


def test_round_trip_to_a_tpu_and_back_keeps_every_jax_generation(runs, tmp_path, capsys):
    """card -> TPU -> card: the port resumes the JAX run (its epoch-1
    generation kept as train_ckpt.jax.bin); that file goes back to
    train_ckpt.bin and the JAX train CLI trains epoch 2 from it; the port
    resumes again and keeps the epoch-2 generation as train_ckpt.jax.e2.bin,
    the epoch-1 file untouched, and its resume line names the file that
    holds what it read. A generation that both kept names hold other
    versions of refuses to resume."""
    from crosstalk_tpu.cli.train import main as jax_train
    from crosstalk_tpu_torch.cli.train import main as port_train

    (mixed, source), dirs = runs
    run_dir = copy_run(dirs["single"], tmp_path)
    ckpt = os.path.join(run_dir, "checkpoints")
    current, kept = (os.path.join(ckpt, n) for n in ("train_ckpt.bin", "train_ckpt.jax.bin"))
    epoch1 = open(current, "rb").read()
    assert port_train(["-m", mixed, "-s", source, "-n", "2", "--resume", run_dir,
                       "--device", "cpu"]) == 0
    assert f"the JAX generation is kept as {kept}" in capsys.readouterr().out

    shutil.copyfile(kept, current)  # the run goes back to the TPU
    assert jax_train(["-m", mixed, "-s", source, "-n", "2", "--resume", run_dir,
                      "-j", "2"]) == 0
    epoch2 = open(current, "rb").read()
    assert jck.read_checkpoint_meta(run_dir)["epoch"] == 2 and epoch2 != epoch1
    capsys.readouterr()

    assert port_train(["-m", mixed, "-s", source, "-n", "3", "--resume", run_dir,
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    again = os.path.join(ckpt, "train_ckpt.jax.e2.bin")
    assert "Resumed a JAX-format checkpoint (train_ckpt.bin) at epoch 2" in out
    assert f"the JAX generation is kept as {again}" in out
    assert open(kept, "rb").read() == epoch1 and open(again, "rb").read() == epoch2
    meta = checkpoint.read_checkpoint_meta(run_dir)
    assert meta["epoch"] == 3 and "source_format" not in meta

    # the same generation read again is kept once; a third one of epoch 2 refuses
    meta2 = dict(jck.read_checkpoint_meta(run_dir), epoch=2)  # the prev: epoch 2's
    meta2.update(source_format="jax", source_file="train_ckpt.prev.bin")
    assert checkpoint.keep_jax_generation(run_dir, meta2) == again
    other = os.path.join(ckpt, "other.bin")  # another epoch-2 generation
    (n,) = struct.unpack("<Q", epoch2[JAX_MAGIC_LEN:JAX_MAGIC_LEN + 8])
    head = json.loads(epoch2[JAX_MAGIC_LEN + 8:JAX_MAGIC_LEN + 8 + n])
    head["best_val_loss"] = head["best_val_loss"] * 0.5 + 1.0
    head = json.dumps(head).encode()
    open(other, "wb").write(epoch2[:JAX_MAGIC_LEN] + struct.pack("<Q", len(head)) + head
                            + epoch2[JAX_MAGIC_LEN + 8 + n:])
    with pytest.raises(ValueError, match="no JAX generation is lost"):
        checkpoint.keep_jax_generation(run_dir, dict(meta2, source_file="other.bin"))
    assert sorted(os.listdir(ckpt)) == ["other.bin", "train_ckpt.bin", "train_ckpt.jax.bin",
                                       "train_ckpt.jax.e2.bin", "train_ckpt.prev.bin"]


# --- (f) fallback across formats ---------------------------------------------

def port_over_jax(runs, tmp_path):
    """A JAX run dir after the port's first checkpoint: current = the port's
    format, prev = the JAX generation it rotated."""
    _, dirs = runs
    run_dir = copy_run(dirs["single"], tmp_path)
    payload, meta = checkpoint.load_checkpoint(run_dir)
    for key in ("source_format", "source_file", "state_sha256"):
        meta.pop(key)  # the JAX-read keys are not the port's to write
    checkpoint.save_checkpoint(run_dir, payload, dict(meta, epoch=2))
    return run_dir


def corrupt(path):
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_corrupt_port_generation_falls_back_to_the_jax_one(runs, tmp_path):
    run_dir = port_over_jax(runs, tmp_path)
    corrupt(os.path.join(run_dir, "checkpoints", "train_ckpt.bin"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        payload, meta = checkpoint.load_checkpoint(run_dir)
    assert meta["source_format"] == "jax" and meta["epoch"] == 1
    assert meta["source_file"] == "train_ckpt.prev.bin"
    assert any("previous generation (JAX format, epoch 1)" in str(w.message) for w in caught)
    _, _, jstate, _ = jax_state(run_dir, "single")
    assert_restores_the_jax_state(payload, jstate, "single")


def test_every_generation_unreadable_names_each_format_and_never_advises_deleting(
        runs, tmp_path):
    run_dir = port_over_jax(runs, tmp_path)
    for name in ("train_ckpt.bin", "train_ckpt.prev.bin"):
        corrupt(os.path.join(run_dir, "checkpoints", name))
    with pytest.raises(ValueError) as err:
        checkpoint.load_checkpoint(run_dir)
    message = str(err.value)
    assert "train_ckpt.bin (port format)" in message
    assert "train_ckpt.prev.bin (JAX format)" in message
    assert "digest" in message and "delete" not in message.lower()


def test_unknown_tree_raises_and_is_never_a_fresh_state(runs):
    _, dirs = runs
    tree = msgpack_restore(state_bytes(os.path.join(dirs["single"], "checkpoints",
                                                    "train_ckpt.bin")))
    extra = dict(tree, opt_state={"0": {}, "1": dict(tree["opt_state"]["1"], extra={})})
    with pytest.raises(ValueError, match="optax state"):
        from_jax_train_state(extra, "single")
    fewer = dict(tree, params={k: v for k, v in tree["params"].items() if k != "Dense_0"})
    with pytest.raises(ValueError, match="unknown single tree"):
        from_jax_train_state(fewer, "single")
    with pytest.raises(ValueError, match="not a crosstalk_tpu TrainState"):
        from_jax_train_state({"params": {}}, "single")


def test_reads_flax_files_in_a_fresh_process_without_msgpack(runs):
    _, dirs = runs
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['flax'] = None\n"
        "from crosstalk_tpu_torch.io.checkpoint import load_checkpoint\n"
        f"payload, meta = load_checkpoint({dirs['double']!r})\n"
        "print(meta['source_format'], payload['step'], len(payload['model']))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    fmt, step, n = proc.stdout.split()
    assert fmt == "jax" and step == "2" and int(n) > 30


# --- (g) tests/jax_format.py's JAX-format writer -----------------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("variant", ["single", "double"])
def test_jax_format_encoder_writes_the_jax_state_bytes(runs, variant):
    _, dirs = runs
    run_dir = dirs[variant]
    _, _, jstate, _ = jax_state(run_dir, variant)
    want = state_bytes(os.path.join(run_dir, "checkpoints", "train_ckpt.bin"))
    assert want == serialization.to_bytes(jstate)
    got = jax_format.flax_msgpack_bytes(_numpy_tree(serialization.to_state_dict(jstate)))
    assert got == want


def test_jax_format_run_dir_checkpoint_equals_the_jax_file(runs, tmp_path):
    """The port's restore of a JAX checkpoint, written back by
    ``jax_format.jax_train_state`` + ``write_jax_checkpoint``: the JAX
    package's file, byte for byte (layout conversion both ways, key order,
    meta)."""
    _, dirs = runs
    jax_file = os.path.join(dirs["single"], "checkpoints", "train_ckpt.bin")
    payload, meta = checkpoint.load_checkpoint(dirs["single"])
    names = [n for n, _ in port_state("single", payload).model.named_parameters()]
    opt = payload["optimizer"]["state"]
    tree = jax_format.jax_train_state(
        payload["model"], {n: opt[i]["exp_avg"] for i, n in enumerate(names)},
        {n: opt[i]["exp_avg_sq"] for i, n in enumerate(names)}, payload["step"])
    jax_meta = {k: v for k, v in meta.items()
                if k not in ("source_format", "source_file", "state_sha256")}
    path = str(tmp_path / "train_ckpt.bin")
    blob = jax_format.write_jax_checkpoint(path, tree, jax_meta)
    assert blob == open(jax_file, "rb").read() == open(path, "rb").read()
