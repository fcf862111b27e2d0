"""The port's throughput benchmark (``crosstalk_tpu_torch/tools/bench.py``)
against the root ``bench.py``, on the CPU.

* The JSON line: the port prints the JAX program's keys plus
  ``power_limit``, with ``null`` on the same keys, at the flags of
  tests/test_bench.py; in mesh mode (two Gloo ranks and a ``[cpu, cpu]``
  replica set, a subprocess with a timeout) the JSON reports the
  per-device batches that ran and says the rates mean nothing; in
  process, each replica infers on its own rows of the one-device draw.
* The timed units: the inference unit's accumulated sum against the JAX
  loop's ``sum_i sum(forward(normalize_batch_nhwc(x + i * 1e-9)))`` on the
  same weights (JAX variables carried across by ``from_jax_variables``)
  and tiles. Tolerances: the per-prediction ones of
  tests/test_torch_port_fast_forward.py (5e-4, the ``--fast`` forward) and
  tests/test_torch_port_int8.py (1e-4, the int8 forward on the JAX
  package's scales), times steps x batch (3 x 4 here). Measured: 3.9e-4
  single-branch and 4.1e-5 two-branch over 12 predictions, int8 3.0e-8.
* The training unit calls the production step as the CLI does, with one
  step function for the warm and the timed unit.
* Out of memory: the batch halves down to the floors (16 inference, 8
  training), and the JSON reports the batch that ran.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import crosstalk_tpu.config as jcfg
import crosstalk_tpu.eval.int8_forward as J
from crosstalk_tpu.data.transforms import normalize_batch_nhwc as jax_normalize
from crosstalk_tpu.eval.fast_forward import make_fast_forward as jax_fast_forward
from crosstalk_tpu.models import registry as jreg
from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
from crosstalk_tpu_torch.eval.int8_forward import make_int8_forward
from crosstalk_tpu_torch.io.torch_convert import from_jax_variables
from crosstalk_tpu_torch.tools import bench

ROOT = Path(__file__).resolve().parents[1]
# the flags of tests/test_bench.py's single-device runs
SMOKE = ["--skip_double", "--infer_batch", "1", "--train_batch", "1", "--scan_len", "1",
         "--image_size", "64"]
SMALL = dict(initial_filters=8, num_conv_blocks=3, initial_filters_per_branch=4)
FAST_TOL = 5e-4   # per prediction, tests/test_torch_port_fast_forward.py
INT8_TOL = 1e-4   # per prediction, tests/test_torch_port_int8.py
MESH_TIMEOUT = 240


def _with_power_limit(keys):
    """The JAX program's keys with the port's ``power_limit`` after ``device``."""
    keys = list(keys)
    keys.insert(keys.index("device") + 1, "power_limit")
    return keys


def _last_json(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_results():
    """The root bench.py's JSON at the smoke flags, without and with
    --skip_int8."""
    return {name: _last_json(jax_bench.main, SMOKE + extra)
            for name, extra in (("skip_double", []), ("skip_int8", ["--skip_int8"]))}


@pytest.mark.parametrize("name,extra", [("skip_double", []), ("skip_int8", ["--skip_int8"])])
def test_json_line_has_the_jax_keys_and_nulls(jax_results, name, extra):
    want = jax_results[name]
    got = _last_json(bench.main, SMOKE + extra + ["--device", "cpu"])
    assert list(got) == _with_power_limit(want)
    nulls = [k for k in _with_power_limit(want) if k == "power_limit" or want[k] is None]
    assert [k for k, v in got.items() if v is None] == nulls
    assert got["device"] == "cpu" and got["metric"] == want["metric"]
    assert got["unit"] == want["unit"]
    for key in ("infer_tps", "train_tps") + (() if extra else ("int8_infer_tps",)):
        assert got[key] > 0
    for key in ("infer_batch", "train_batch", "int8_infer_batch"):
        assert got[key] == want[key]
    assert got["vs_baseline"] == round(got["value"] / 5000.0, 3)


def test_mesh_mode_reports_global_rates_and_the_cpu_note(jax_results):
    """--num_devices 2 on the CPU: two Gloo training ranks and a replica set
    of two CPU forwards, in a subprocess; its keys are the JAX program's
    mesh keys plus power_limit."""
    want = _last_json(jax_bench.main, ["--num_devices", "2"] + SMOKE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CROSSTALK_DIST_TIMEOUT="60", OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "crosstalk_tpu_torch.tools.bench", "--device", "cpu",
           "--num_devices", "2"] + SMOKE
    for attempt in range(2):  # once more if another process took the free port
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=MESH_TIMEOUT)
        if proc.returncode == 0 or attempt == 1 or "Address already in use" not in proc.stderr:
            break
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(got) == _with_power_limit(want)
    assert got["num_devices"] == 2 and got["int8_infer_tps"] is None
    # the per-device batches that ran: the replica set's and rank 0's report
    assert got["infer_batch"] == 1 and got["train_batch"] == 1
    for key in ("infer_tps_global", "train_tps_global"):
        assert got[key] > 0
    assert got["two_branch_infer_tps_global"] is None
    assert "NOT meaningful" in got["note"] and "not meaningful" in proc.stderr


@pytest.fixture(scope="module")
def models():
    """Per variant: JAX config and variables, port config and state_dict
    (small widths, 32 px, batch statistics moved off their init)."""
    out = {}
    for variant in ("single", "double"):
        jc = jcfg.ModelConfig(variant=variant, compute_dtype="bf16", **SMALL)
        v = jreg.init_model(jreg.build_model(jc), jax.random.key(4), image_size=32)
        rng = np.random.default_rng(4)
        v = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": jax.tree.map(
            lambda a: a + jnp.asarray(rng.normal(0, 0.01, a.shape), a.dtype) ** 2,
            v["batch_stats"])})
        out[variant] = (jc, v, ModelConfig(variant=variant, **SMALL),
                        from_jax_variables(v, variant))
    return out


def _raw_tiles(seed, batch):
    """Raw intensities that the unit's normalize moves (uniform [0, 1)
    tiles would pass through it almost unchanged)."""
    rng = np.random.default_rng(seed)
    return (rng.random((batch, 32, 32, 2)) * 3 + 0.5).astype(np.float32)


def _jax_unit(forward, x, steps):
    """The root bench.py's scan body as a Python loop of JAX calls."""
    acc = jnp.zeros(())
    for i in range(steps):
        xi = jnp.asarray(x) + jnp.float32(i) * 1e-9
        acc = acc + jnp.sum(forward(jax_normalize(xi)))
    return float(acc)


@pytest.mark.parametrize("variant", ["single", "double"])
def test_inference_unit_matches_the_jax_loop(models, variant):
    jc, v, pc, sd = models[variant]
    batch, steps = 4, 3
    x = _raw_tiles(5, batch)
    fwd = jax.jit(jax_fast_forward(jc, use_pallas=False))
    want = _jax_unit(lambda a: fwd(v, a), x, steps)
    (got,) = bench.infer_unit([make_fast_forward(pc, sd)], [torch.from_numpy(x)], steps)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=0, atol=FAST_TOL * steps * batch)
    # the same unit as two CPU replicas of two rows each sums the same rows
    halves = [torch.from_numpy(x[:2]), torch.from_numpy(x[2:])]
    parts = bench.infer_unit([make_fast_forward(pc, sd)] * 2, halves, steps)
    np.testing.assert_allclose(float(sum(parts)), float(got), rtol=0, atol=1e-5)


def test_each_replica_infers_on_its_own_rows(monkeypatch):
    """A replica set of two devices: replica r holds rows [r * B, (r + 1) * B)
    of the draw one device would make at 2B rows, with a forward of its
    own; each replica's sum is finite and equals the one-device unit on
    its rows."""
    seen = []
    real = bench.infer_unit

    def spy(forwards, xs, steps):
        seen.append((list(forwards), list(xs)))
        return real(forwards, xs, steps)
    monkeypatch.setattr(bench, "infer_unit", spy)
    cpu = torch.device("cpu")
    assert bench.infer_seconds("single", 2, 1, 64, [cpu, cpu]) > 0
    assert len(seen) == 4  # warm-up and best of 3
    forwards, xs = seen[0]
    assert len(forwards) == 2 and forwards[0] is not forwards[1]
    tiles = bench._tiles(0, 4, 64)
    for r, x in enumerate(xs):
        np.testing.assert_array_equal(x.numpy(), tiles[2 * r:2 * r + 2])
    with torch.inference_mode():
        parts = real(forwards, xs, 1)
        for r in range(2):
            (alone,) = real([forwards[r]], [xs[r]], 1)
            assert torch.isfinite(parts[r]) and float(parts[r]) == float(alone)


def test_int8_unit_matches_the_jax_loop_on_the_same_scales(models):
    jc, v, pc, sd = models["single"]
    batch, steps = 4, 3
    x = _raw_tiles(6, batch)
    scales = J.calibrate_int8(jc, v, np.asarray(jax_normalize(jnp.asarray(x))),
                              use_pallas=False)
    fwd = jax.jit(J.make_int8_forward(jc, scales, use_pallas=False))
    want = _jax_unit(lambda a: fwd(v, a), x, steps)
    quant = make_int8_forward(pc, sd, scales, use_kernel=False)
    (got,) = bench.infer_unit([quant], [torch.from_numpy(x)], steps)
    np.testing.assert_allclose(float(got), want, rtol=0, atol=INT8_TOL * steps * batch)


def test_training_unit_runs_the_production_step(monkeypatch):
    """One make_train_step per measure (bf16, augment, no process group),
    on a state built with OptimConfig()'s defaults; its one step function
    takes the warm and the timed unit at lr 1e-4."""
    made, calls, states = [], [], []
    real_make, real_init = bench.make_train_step, bench.init_train_state

    def init_spy(model, cfg):
        states.append((real_init(model, cfg), cfg))
        return states[-1][0]

    def make_spy(state, **kwargs):
        step = real_make(state, **kwargs)
        made.append((state, kwargs, step))

        def counted(x, y, lr):
            calls.append((x, y, lr))
            return step(x, y, lr)
        return counted

    monkeypatch.setattr(bench, "init_train_state", init_spy)
    monkeypatch.setattr(bench, "make_train_step", make_spy)
    seconds = bench.train_seconds("single", 2, 2, 64, torch.device("cpu"))
    assert seconds > 0
    assert len(made) == 1 and len(states) == 1
    state, kwargs, _ = made[0]
    assert states[0] == (state, OptimConfig())
    assert kwargs == {"compute_dtype": "bf16", "augment": True, "process_group": None}
    assert state.step == 4 and len(calls) == 4
    assert all(lr == 1e-4 and x is calls[0][0] and y is calls[0][1] for x, y, lr in calls)
    assert tuple(calls[0][0].shape) == (2, 64, 64, 2) and tuple(calls[0][1].shape) == (2, 1)
    group = state.optimizer.param_groups[0]
    cfg = OptimConfig()
    assert group["betas"] == (cfg.adam_b1, cfg.adam_b2) and group["eps"] == cfg.adam_eps
    assert group["weight_decay"] == cfg.weight_decay


def test_each_rank_trains_on_its_own_rows(monkeypatch):
    """Under a process group, rank r steps on rows [r * B, (r + 1) * B) of
    the global batch that one device would draw."""
    import torch.distributed as dist

    group, seen = object(), []
    monkeypatch.setattr(dist, "get_world_size", lambda g: 2)
    monkeypatch.setattr(dist, "get_rank", lambda g: 1)
    monkeypatch.setattr(dist, "barrier", lambda group: None)

    def make(state, **kwargs):
        assert kwargs["process_group"] is group
        return lambda x, y, lr: seen.append((x, y))
    monkeypatch.setattr(bench, "make_train_step", make)
    bench.train_seconds("single", 2, 1, 64, torch.device("cpu"), process_group=group)
    rng = np.random.default_rng(1)
    x = rng.random((4, 64, 64, 2)).astype(np.float32)
    y = rng.uniform(0, 0.5, (4, 1)).astype(np.float32)
    for got_x, got_y in seen:
        np.testing.assert_array_equal(got_x.numpy(), x[2:])
        np.testing.assert_array_equal(got_y.numpy(), y[2:])
    assert len(seen) == 2


def _oom_after(limit, tried):
    def measure(batch, *_a, **_k):
        tried.append(batch)
        if batch > limit:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return 0.5
    return measure


@pytest.mark.parametrize("floor", [bench.INFER_FLOOR, bench.TRAIN_FLOOR])
def test_halving_stops_at_the_floor(floor):
    tried = []
    assert bench.with_halving(_oom_after(floor, tried), 64, floor, []) == (0.5, floor)
    assert tried == [b for b in (64, 32, 16, 8) if b >= floor]
    tried.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench.with_halving(_oom_after(0, tried), 64, floor, [])
    assert tried[-1] == floor and tried == [b for b in (64, 32, 16, 8) if b >= floor]


def test_out_of_memory_halves_each_measure_and_reports_the_batch(monkeypatch, capsys):
    tried = {"infer": [], "train": [], "int8": []}
    infer, train = _oom_after(128, tried["infer"]), _oom_after(32, tried["train"])
    monkeypatch.setattr(bench, "infer_seconds", lambda variant, b, *a: infer(b))
    monkeypatch.setattr(bench, "train_seconds", lambda variant, b, *a: train(b))
    monkeypatch.setattr(bench, "int8_seconds", _oom_after(64, tried["int8"]))
    result = _last_json(bench.main, ["--device", "cpu", "--skip_double"])
    assert (result["infer_batch"], result["train_batch"], result["int8_infer_batch"]) == \
        (128, 32, 64)
    assert tried == {"infer": [512, 256, 128], "train": [128, 64, 32],
                     "int8": [512, 256, 128, 64]}
    assert result["infer_tps"] == round(32 * 128 / 0.5, 1)
    assert "retrying at 64" in capsys.readouterr().err

    tried["train"].clear()
    train = _oom_after(0, tried["train"])
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench.main(["--device", "cpu", "--skip_double", "--skip_int8"])
    assert tried["train"] == [128, 64, 32, 16, 8]


def test_without_device_a_cudaless_host_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(SMOKE)


@pytest.mark.parametrize("flags", [["--num_devices", "0"], ["--infer_batch", "0"],
                                   ["--train_batch", "-1"], ["--image_size", "0"],
                                   ["--scan_len", "0"]])
def test_flag_checks_match_the_jax_program(flags, capsys):
    messages = []
    for main, extra in ((jax_bench.main, []), (bench.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(flags + extra)
        assert e.value.code == 2
        messages.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
    assert messages[0] == messages[1]


def test_more_devices_than_visible_is_a_usage_error(capsys):
    n = os.cpu_count() + 1
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--num_devices", str(n)])
    assert e.value.code == 2
    assert f"only {n - 1} cpu device(s) visible" in capsys.readouterr().err


def test_head_batchnorm_trains_on_one_row_as_jax_does():
    """The bench trains at --train_batch 1 on the CPU: the head's
    BatchNorm1d takes one row in train mode as the JAX BatchNorm does
    (output = bias; running variance from the unbiased variance with its
    divisor held at 1), where torch's layer refuses the batch; two rows or
    more go through torch's layer unchanged."""
    from crosstalk_tpu.models.layers import BatchNorm
    from crosstalk_tpu_torch.models.layers import OneRowBatchNorm1d

    rng = np.random.default_rng(7)
    c = 6
    w, b = rng.normal(1, 0.2, c).astype(np.float32), rng.normal(0, 0.2, c).astype(np.float32)
    for rows in (1, 3):
        x = rng.normal(0.5, 2, (rows, c)).astype(np.float32)
        bn = OneRowBatchNorm1d(c).train()
        plain = torch.nn.BatchNorm1d(c).train()
        for m in (bn, plain):
            with torch.no_grad():
                m.weight.copy_(torch.from_numpy(w))
                m.bias.copy_(torch.from_numpy(b))
        y = bn(torch.from_numpy(x))
        variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                     "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
        want, upd = BatchNorm().apply(variables, jnp.asarray(x), use_running_average=False,
                                      mutable=["batch_stats"])
        # at one row JAX computes x * (scale / sqrt(eps)) - mean * (scale /
        # sqrt(eps)) + bias: two float32 terms of ~300 whose rounding it keeps
        atol = 2e-3 if rows == 1 else 1e-5
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0, atol=atol)
        np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"],
                                   rtol=0, atol=1e-6)
        if rows == 1:
            np.testing.assert_array_equal(y.detach().numpy()[0], b)
            with pytest.raises(ValueError, match="more than 1 value"):
                plain(torch.from_numpy(x))
        else:
            torch.testing.assert_close(y, plain(torch.from_numpy(x)), rtol=0, atol=0)
    assert repr(bn) == repr(plain)
