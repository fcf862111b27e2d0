"""Data parallelism of the port across processes: two Gloo ranks on the CPU
against one process, and against the JAX package's 2-device mesh.

Every rank is a subprocess of its own (``crosstalk_tpu_torch.tools.multirank``,
the train CLI, or a short script) with a timeout of WORKER_TIMEOUT seconds
and a rendezvous timeout of 60 s; a rendezvous failure (another process
took the free port first) is retried once with a fresh port, as
tests/test_multihost.py does. Small sizes: width-8 single-branch models with
3 blocks on 32-64 px tiles, inputs drawn from numpy seeds, JAX weights
carried across with ``from_jax_variables``.

Tolerances, stated per check: two ranks against one on the concatenated
batch differ only in the order of float32 sums, so BatchNorm outputs, input
gradients and statistics agree to 1e-6, the loss to rtol 1e-5, every
gradient leaf to 1e-4 x its max |g| + 1e-7 (leaving out the biases a
BatchNorm directly follows, whose gradient is 0 up to rounding), and the
parameters after one Adam step to 2 x lr plus two float32 ulps of the
leaf's largest value (an Adam step moves a parameter by at most lr, and its
sign flips with the rounding of a near-zero gradient). Against JAX:
BatchNorm 1e-5, the loss rtol 1e-5, BatchNorm statistics rtol 1e-4,
parameters as above, evaluation rows and sums 1e-5.
"""

import csv
import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crosstalk_tpu_torch.io.torch_convert import from_jax_variables, save_pth
from crosstalk_tpu_torch.parallel.distributed import free_port
from crosstalk_tpu_torch.tools import multirank
from tests.conftest import make_synthetic_dataset

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 120
PX = 32
SMALL = ["--initial_filters", "8", "--num_conv_blocks", "3"]
# what a rank prints when its rendezvous fails, e.g. on a port taken
# between free_port() and the bind
_RENDEZVOUS_FAILURE = ("DistNetworkError", "Address already in use", "EADDRINUSE",
                       "Connection refused", "timed out")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["CROSSTALK_DIST_TIMEOUT"] = "60"
    env["OMP_NUM_THREADS"] = "2"  # two ranks share the host's cores
    return env


def run_ranks(argv_for, world=2):
    """Start rank r as ``python argv_for(r, port)`` for r < world, wait for
    each (WORKER_TIMEOUT s) -> (exit codes, outputs)."""
    for attempt in range(2):
        port = free_port()
        procs = [subprocess.Popen([sys.executable, *argv_for(r, port)], cwd=ROOT, env=_env(),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        rcs, outs = [], []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=WORKER_TIMEOUT)
                rcs.append(p.returncode)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = any(rcs) and any(s in o for o in outs for s in _RENDEZVOUS_FAILURE)
        if attempt == 0 and failed:
            continue
        return rcs, outs


def run_ok(argv_for, world=2):
    rcs, outs = run_ranks(argv_for, world)
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} exit code {rc}:\n{out[-3000:]}"
    return outs


def tool(command, out_dir, *flags):
    def argv(rank, port):
        return ["-m", "crosstalk_tpu_torch.tools.multirank", command, "--rank", str(rank),
                "--world", "2", "--port", str(port), "--out", str(out_dir),
                "--device", "cpu", *flags]
    return argv


def load(path):
    return torch.load(path, weights_only=False)


def shadowed_biases(state):
    """The conv/Linear biases a BatchNorm directly follows (items 4k of a
    Sequential with a BatchNorm at 4k + 1)."""
    keys = set(state)
    out = set()
    for k in keys:
        if k.endswith(".bias"):
            prefix, idx = k[:-len(".bias")].rsplit(".", 1)
            if f"{prefix}.{int(idx) + 1}.running_mean" in keys:
                out.add(k)
    return out


# --- cross-replica BatchNorm ------------------------------------------------

BN_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from crosstalk_tpu_torch.models.layers import CrossReplicaBatchNorm1d, CrossReplicaBatchNorm2d
from crosstalk_tpu_torch.parallel.distributed import initialize, process_row_slice

rank, port, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
group = initialize(f"localhost:{port}", 2, rank, backend="gloo", device_type="cpu",
                   timeout_s=60)
data = np.load(root + "/bn.npz")
out = {}
for name, cls in (("2d", CrossReplicaBatchNorm2d), ("1d", CrossReplicaBatchNorm1d)):
    rows = process_row_slice(len(data["x" + name]), group)
    bn = cls(data["w" + name].shape[0], process_group=group).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["w" + name]))
        bn.bias.copy_(torch.from_numpy(data["b" + name]))
    x = torch.from_numpy(data["x" + name][rows]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(data["up" + name][rows])).sum().backward()
    out[name] = {"y": y.detach().numpy(), "gx": x.grad.numpy(),
                 "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
torch.save(out, f"{root}/bn_rank{rank}.pt")
dist.destroy_process_group()
"""


def _bn_inputs(root):
    rng = np.random.default_rng(21)
    data = {"x2d": rng.normal(0.5, 2.0, (6, 5, 4, 3)), "x1d": rng.normal(-1.0, 3.0, (8, 7))}
    for name, x in list(data.items()):
        c = x.shape[1]
        data["up" + name[1:]] = rng.normal(0, 1, x.shape)
        data["w" + name[1:]] = rng.normal(1, 0.3, c)
        data["b" + name[1:]] = rng.normal(0, 0.2, c)
    data = {k: v.astype(np.float32) for k, v in data.items()}
    np.savez(os.path.join(root, "bn.npz"), **data)
    return data


def test_cross_replica_batchnorm_two_ranks_equal_one_rank_and_jax(tmp_path):
    """Two Gloo ranks, each with half the batch, against torch's BatchNorm
    on the whole batch (outputs, input gradients of sum(y * upstream),
    running statistics; 1e-6) and against the JAX package's
    ``BatchNorm(axis_name='data')`` shard_mapped over a 2-device mesh (1e-5)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from crosstalk_tpu.models.layers import BatchNorm
    from crosstalk_tpu.parallel.mesh import data_mesh

    data = _bn_inputs(str(tmp_path))
    run_ok(lambda r, port: ["-c", BN_WORKER, str(r), str(port), str(tmp_path)])
    ranks = [load(tmp_path / f"bn_rank{r}.pt") for r in (0, 1)]
    mesh = data_mesh(2)
    for name, cls in (("2d", torch.nn.BatchNorm2d), ("1d", torch.nn.BatchNorm1d)):
        x, up = data["x" + name], data["up" + name]
        bn = cls(x.shape[1]).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(data["w" + name]))
            bn.bias.copy_(torch.from_numpy(data["b" + name]))
        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(up)).sum().backward()
        want = {"y": y.detach().numpy(), "gx": xt.grad.numpy(),
                "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
        for key in ("y", "gx"):
            got = np.concatenate([ranks[r][name][key] for r in (0, 1)])
            np.testing.assert_allclose(got, want[key], rtol=0, atol=1e-6, err_msg=f"{name} {key}")
        for key in ("mean", "var"):
            for r in (0, 1):
                np.testing.assert_allclose(ranks[r][name][key], want[key], rtol=0, atol=1e-6)

        # JAX: channels last, the statistics psum'd over the mesh's data axis
        to_last = (0, 2, 3, 1) if name == "2d" else (0, 1)
        from_last = (0, 3, 1, 2) if name == "2d" else (0, 1)
        c = x.shape[1]
        variables = {"params": {"scale": jnp.asarray(data["w" + name]),
                                "bias": jnp.asarray(data["b" + name])},
                     "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
        module = BatchNorm(axis_name="data")

        def shard(xs, ups):
            def loss(xs):
                y, mut = module.apply(variables, xs, use_running_average=False,
                                      mutable=["batch_stats"])
                return jnp.sum(y * ups), (y, mut["batch_stats"])
            (_, (y, stats)), gx = jax.value_and_grad(loss, has_aux=True)(xs)
            return y, gx, stats["mean"], stats["var"]

        fn = jax.shard_map(shard, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data"), P(), P()), check_vma=False)
        jy, jgx, jmean, jvar = fn(jnp.asarray(x.transpose(to_last)),
                                  jnp.asarray(up.transpose(to_last)))
        got = np.concatenate([ranks[r][name]["y"] for r in (0, 1)])
        np.testing.assert_allclose(got, np.asarray(jy).transpose(from_last), atol=1e-5)
        got = np.concatenate([ranks[r][name]["gx"] for r in (0, 1)])
        np.testing.assert_allclose(got, np.asarray(jgx).transpose(from_last), atol=1e-5)
        np.testing.assert_allclose(ranks[0][name]["mean"], np.asarray(jmean), atol=1e-5)
        np.testing.assert_allclose(ranks[0][name]["var"], np.asarray(jvar), atol=1e-5)


# --- train and validation steps --------------------------------------------

LR = 1e-5


def _batch(root, seed=7, b=8):
    rng = np.random.default_rng(seed)
    inputs = (rng.random((b, PX, PX, 2)) * 1800 + 100).astype(np.float32)
    labels = rng.uniform(0, 0.5, (b, 1)).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-3:] = 0.0  # padding rows, spread over rank 1's rows
    path = os.path.join(root, "batch.npz")
    np.savez(path, inputs=inputs, labels=labels, mask=mask)
    return inputs, labels, mask, path


def _assert_step_close(two, one, lr):
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    skip = shadowed_biases(one["state"])
    for k, g in one["grads"].items():
        if k in skip:
            continue
        bound = 1e-4 * float(g.abs().max()) + 1e-7
        assert float((two["grads"][k] - g).abs().max()) <= bound, k
    for k, v in one["state"].items():
        diff = float((two["state"][k].double() - v.double()).abs().max())
        if "running" in k:
            assert diff <= 1e-5 * float(v.abs().max()) + 1e-7, k
        elif k.endswith(("weight", "bias")):  # + the f32 rounding of p - lr * u
            assert diff <= 2 * lr + 2.0 ** -22 * float(v.abs().max()), k


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_and_val_step_two_ranks_equal_one_rank(tmp_path, grad_accum):
    """One f32 step at global batch 8 (4 per rank), dropout 0, then the
    validation step with 3 padding rows: two ranks against one process on
    the whole batch. With flips (drawn from the global example index) at
    ``grad_accum=1``. With ``grad_accum=2`` each rank splits its 4 rows in
    two, so microbatch i holds rows {2i, 2i+1} of every rank, with
    BatchNorm statistics over those 4 rows: the one-process run takes the
    batch in that order (so flips are off: they follow the position)."""
    inputs, labels, mask, path = _batch(str(tmp_path))
    augment = grad_accum == 1
    flags = ["--data", path, *SMALL, "--dropout", "0", "--lr", str(LR),
             "--grad_accum", str(grad_accum)] + (["--augment"] if augment else [])
    run_ok(tool("step", tmp_path / "out", *flags))
    two = [load(tmp_path / "out" / f"rank{r}.pt") for r in (0, 1)]
    assert two[0]["losses"] == two[1]["losses"] and two[0]["val"] == two[1]["val"]
    order = np.arange(8) if augment else np.array([0, 1, 4, 5, 2, 3, 6, 7])
    args = multirank._parser().parse_args(["step", "--rank", "0", "--world", "1",
                                           "--port", "0", "--out", "-", *flags])
    one = multirank.run_steps(multirank.model_config(args), PX,
                              torch.from_numpy(inputs[order]), torch.from_numpy(labels[order]),
                              LR, seed=0, augment=augment, grad_accum=grad_accum,
                              mask=torch.from_numpy(mask[order]))
    _assert_step_close(two[0], one, LR)
    np.testing.assert_allclose(two[0]["val"], one["val"], rtol=1e-5)
    assert one["val"][1] == 5.0


def test_float64_step_two_ranks_equal_one_rank_per_gradient_leaf(tmp_path):
    """float64 arrays make the ranks' model and step float64: there two
    ranks equal one process on the whole batch in every gradient leaf to
    1e-9 x its max |g| + 1e-15, and a rank that skips the all-reduces (one
    process on rank 0's rows) misses that bound in every leaf. In float32 a
    max-pool window whose two largest values round the other way routes a
    gradient elsewhere, so the leaves below it move by ~1e-3."""
    inputs, labels, _, _ = _batch(str(tmp_path))
    inputs, labels = inputs.astype(np.float64), labels.astype(np.float64)
    path = str(tmp_path / "batch64.npz")
    np.savez(path, inputs=inputs, labels=labels)
    run_ok(tool("step", tmp_path / "out", "--data", path, *SMALL, "--dropout", "0",
                "--lr", str(LR), "--augment"))
    two = load(tmp_path / "out" / "rank0.pt")
    args = multirank._parser().parse_args(["step", "--rank", "0", "--world", "1", "--port",
                                           "0", "--out", "-", *SMALL, "--dropout", "0"])
    cfg = multirank.model_config(args)

    def one_process(rows):
        return multirank.run_steps(cfg, PX, torch.from_numpy(inputs[rows]),
                                   torch.from_numpy(labels[rows]), LR, augment=True,
                                   dtype=torch.float64)

    one, alone = one_process(slice(None)), one_process(slice(0, 4))
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-12)
    skip = shadowed_biases(one["state"])
    for k, g in one["grads"].items():
        if k in skip:
            continue
        assert g.dtype == two["grads"][k].dtype == torch.float64
        bound = 1e-9 * float(g.abs().max()) + 1e-15
        assert float((two["grads"][k] - g).abs().max()) <= bound, k
        assert float((alone["grads"][k] - g).abs().max()) > bound, k


def _jax_single(seed, image_size):
    import jax

    from crosstalk_tpu.config import ModelConfig
    from crosstalk_tpu.models import build_model, init_model

    cfg = ModelConfig(variant="single", initial_filters=8, num_conv_blocks=3,
                      compute_dtype="f32", dropout_single=0.0)
    variables = init_model(build_model(cfg), jax.random.key(seed), image_size=image_size)
    return cfg, variables


def test_train_step_two_ranks_equal_the_jax_mesh_step(tmp_path):
    """The same weights (JAX's, carried across) and batch, flips off: the
    port's two Gloo ranks against JAX ``make_train_step(mesh=data_mesh(2))``."""
    import jax

    from crosstalk_tpu.config import OptimConfig
    from crosstalk_tpu.io.torch_convert import flax_to_torch
    from crosstalk_tpu.models import build_model
    from crosstalk_tpu.parallel.mesh import data_mesh
    from crosstalk_tpu.train.steps import (
        batch_sharding,
        init_train_state,
        make_optimizer,
        make_train_step,
        replicate_state,
    )

    inputs, labels, _, path = _batch(str(tmp_path), seed=9)
    cfg, variables = _jax_single(2, PX)
    weights = str(tmp_path / "w.pth")
    torch.save(from_jax_variables(variables, "single"), weights)
    run_ok(tool("step", tmp_path / "out", "--data", path, *SMALL, "--dropout", "0",
                "--lr", str(LR), "--weights", weights))
    two = load(tmp_path / "out" / "rank0.pt")

    model = build_model(cfg, axis_name="data")
    tx = make_optimizer(OptimConfig())
    mesh = data_mesh(2)
    state = replicate_state(init_train_state(model, variables, tx), mesh)
    step = make_train_step(model, tx, mesh=mesh, augment=False)
    sharding = batch_sharding(mesh)
    state, loss = step(state, jax.device_put(inputs, sharding),
                       jax.device_put(labels, sharding), np.float32(LR), jax.random.key(1))
    np.testing.assert_allclose(two["losses"][0], float(loss), rtol=1e-5)
    want = flax_to_torch({"params": state.params, "batch_stats": state.batch_stats}, "single")
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):  # JAX does not count them
            continue
        got = two["state"][k].double().numpy()
        if "running" in k:  # rtol 1e-4 of the leaf's largest value
            assert float(np.abs(got - v).max()) <= 1e-4 * float(np.abs(v).max()), k
        else:
            assert float(np.abs(got - v).max()) <= 2 * LR + 2.0 ** -22 * float(np.abs(v).max()), k


# --- the evaluation engine --------------------------------------------------

def test_eval_engine_two_ranks_equal_one_rank_and_the_jax_mesh_eval(tmp_path):
    """10 pairs of 64 px at batch 8, so the padded tail is in the test
    (tests/test_multihost.py:138): the rows every rank gathers against one
    process's rows (1e-6), and against JAX ``evaluate(mesh=data_mesh(2))``:
    row count, loss and the per-column sums (1e-5)."""
    from crosstalk_tpu.data.index import PairIndex as JPairIndex
    from crosstalk_tpu.data.pipeline import TileStore as JTileStore
    from crosstalk_tpu.eval.engine import evaluate as jax_evaluate
    from crosstalk_tpu.models import build_model as jax_build_model
    from crosstalk_tpu.parallel.mesh import data_mesh
    from crosstalk_tpu_torch.eval.engine import model_forward
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.config import ModelConfig

    mixed, source = make_synthetic_dataset(str(tmp_path / "data"), n=10, size=64, seed=13)
    cfg, variables = _jax_single(3, 64)
    ckpt = str(tmp_path / "m.pth")
    save_pth(ckpt, from_jax_variables(variables, "single"))
    run_ok(tool("eval", tmp_path / "out", "--checkpoint", ckpt, "-m", mixed, "-s", source,
                "--batch_size", "8"))
    ranks = [load(tmp_path / "out" / f"rank{r}.pt")["single"] for r in (0, 1)]

    model = build_model(ModelConfig(initial_filters=8, num_conv_blocks=3, compute_dtype="f32"),
                        image_size=64)
    model.load_state_dict(from_jax_variables(variables, "single"))
    one, one_loss = multirank.run_eval(model_forward(model, "f32"), mixed, source,
                                       torch.device("cpu"), 8)
    for r in (0, 1):
        assert list(ranks[r]["rows"]) == list(one)
        assert ranks[r]["rows"]["Image_ID"].tolist() == one["Image_ID"].tolist()
        for k, v in one.items():
            np.testing.assert_allclose(ranks[r]["rows"][k], v, rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(ranks[r]["loss"], one_loss, rtol=1e-6)

    rows, loss = jax_evaluate(jax_build_model(cfg), variables,
                              JTileStore(JPairIndex(mixed, source).samples, jobs=1),
                              batch_size=8, with_metrics=True, mesh=data_mesh(2))
    got = ranks[0]["rows"]
    assert len(rows) == len(got["Image_ID"]) == 10
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=1e-5)
    for k in rows[0]:
        want = np.sum([float(row[k]) for row in rows])
        np.testing.assert_allclose(float(np.sum(got[k].astype(np.float64))), want,
                                   rtol=1e-5, err_msg=k)


# --- the train CLI ----------------------------------------------------------

@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("multirank_cli")
    mixed, source = make_synthetic_dataset(str(root), n=24, size=PX, seed=5)
    return root, mixed, source


def _train_argv(mixed, source, out, *flags):
    return ["-m", "crosstalk_tpu_torch.cli.train", "-m", mixed, "-s", source, "-b", "8",
            "-n", "2", "-j", "2", *SMALL, "--compute_dtype", "f32", "--dropout", "0",
            "--device", "cpu", "--output_base", str(out), *flags]


def _losses(base):
    (path,) = glob.glob(os.path.join(base, "training_run_*", "training_log_*.csv"))
    with open(path) as f:
        rows = list(csv.reader(f))[5:]
    return np.array([[float(v) for v in r[1:3]] for r in rows])


def test_train_cli_two_local_ranks_equal_one(cli_data):
    """``--device cpu --num_devices 2`` (two local Gloo ranks) against
    ``--num_devices 1`` (f32, dropout 0, flips on, 2 epochs of 2 steps):
    the train-loss column of the training log, rtol 1e-5; the val-loss
    column, rtol 1e-4 (the running statistics it reads take in the biases
    a BatchNorm follows, whose Adam steps follow the sign of a gradient that
    is 0 up to rounding)."""
    root, mixed, source = cli_data
    for n in (1, 2):
        proc = subprocess.run(
            [sys.executable, *_train_argv(mixed, source, root / f"n{n}", "--num_devices", str(n))],
            cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=WORKER_TIMEOUT)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "x2, 2 processes" in proc.stdout
    one, two = _losses(root / "n1"), _losses(root / "n2")
    assert one.shape == two.shape == (2, 2)
    np.testing.assert_allclose(two[:, 0], one[:, 0], rtol=1e-5)
    np.testing.assert_allclose(two[:, 1], one[:, 1], rtol=1e-4)


def test_train_cli_multihost_rank0_owns_the_artifacts_and_a_desynced_resume_fails(
        cli_data, tmp_path):
    """Two ``--multihost`` processes (tests/test_multihost.py:185-251): rank
    0 writes the full artifact set and rank 1 nothing; a resume where rank
    1 sees a run directory without checkpoints fails on both ranks."""
    _, mixed, source = cli_data
    out = [tmp_path / "rank0", tmp_path / "rank1"]
    for d in out:
        d.mkdir()

    def argv(rank, port, *extra):
        return [*_train_argv(mixed, source, out[rank], *extra), "--multihost",
                "--coordinator_address", f"localhost:{port}", "--num_processes", "2",
                "--process_id", str(rank)]

    outs = run_ok(lambda r, port: argv(r, port, "-n", "1", "-r", "aggressive_plateau"))
    assert "2 processes" in outs[0]
    (run_dir,) = out[0].glob("training_run_*")
    for artifact in ("params.txt", "model_architecture.txt", "best_model_plateau.pth",
                     "checkpoints/train_ckpt.bin"):
        assert (run_dir / artifact).exists(), artifact
    assert list(run_dir.glob("training_log_*.csv"))
    assert list(run_dir.glob("crosstalk_regression_model_trained_*.pth"))
    assert len(list(run_dir.glob("*_predictions_*.csv"))) == 3
    assert list(out[1].iterdir()) == [], "rank 1 must write nothing"

    empty = out[1] / "training_run_fake"
    empty.mkdir()
    rcs, outs = run_ranks(lambda r, port: argv(r, port, "--resume",
                                               str(run_dir if r == 0 else empty)))
    assert all(rc != 0 for rc in rcs), list(zip(rcs, outs))
    assert any("resume desync" in o for o in outs), outs
