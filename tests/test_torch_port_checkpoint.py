"""The port's resume checkpoints and ``.pth`` interop (small single-branch
model, 32 px tiles, batch 8): round trip, async writer equal to the
synchronous one, fallback to the previous generation on a corrupt or
truncated file, and a port-trained ``.pth`` read by the JAX package."""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crosstalk_tpu.config as jcfg
from crosstalk_tpu.io import torch_convert as jconv
from crosstalk_tpu.models import registry as jreg
from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
from crosstalk_tpu_torch.io import checkpoint
from crosstalk_tpu_torch.io.torch_convert import load_pth
from crosstalk_tpu_torch.models.registry import build_model, init_model
from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

CFG = dict(variant="single", initial_filters=8, num_conv_blocks=3)
META = {"epoch": 2, "global_step": 4, "best_val_loss": float("inf"),
        "train_losses": [0.5, 0.25], "schedule": {"epoch": 2}}


def trained_state(steps=2, seed=0):
    model = build_model(ModelConfig(**CFG), image_size=32)
    init_model(model, torch.Generator().manual_seed(seed))
    state = init_train_state(model, OptimConfig())
    step = make_train_step(state, compute_dtype="f32", seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        step(torch.from_numpy(rng.random((8, 32, 32, 2), np.float32)),
             torch.from_numpy(rng.uniform(0, 0.5, (8, 1)).astype(np.float32)), 1e-3)
    return state, step


def assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        assert a == b


def test_round_trip_restores_the_state_exactly(tmp_path):
    state, step = trained_state()
    checkpoint.save_checkpoint(str(tmp_path), checkpoint.state_payload(state, 7), META)
    payload, meta = checkpoint.load_checkpoint(str(tmp_path))
    assert meta["epoch"] == 2 and meta["state_sha256"]
    assert payload["step"] == 2 and payload["rng"] == {"seed": 7}
    assert_trees_equal(payload, checkpoint.state_payload(state, 7))

    # a restored state takes the same next step as the one it was saved from
    other, _ = trained_state(steps=0, seed=1)
    checkpoint.restore_state(other, payload)
    other_step = make_train_step(other, compute_dtype="f32", seed=0)
    x = torch.rand(8, 32, 32, 2, generator=torch.Generator().manual_seed(3))
    y = torch.full((8, 1), 0.2)
    assert torch.equal(step(x, y, 1e-3), other_step(x, y, 1e-3))
    assert_trees_equal(other.model.state_dict(), state.model.state_dict())


def test_async_writer_equals_sync_and_snapshots_before_the_next_step(tmp_path):
    state, step = trained_state()
    before = checkpoint.state_payload(state, 1)
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    checkpoint.save_checkpoint(sync_dir, before, META)
    writer = checkpoint.AsyncCheckpointWriter()
    writer.submit_checkpoint(async_dir, checkpoint.state_payload(state, 1), META)
    writer.submit_pth(str(tmp_path / "best.pth"), state.model.state_dict())
    pth_weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    # the next step updates the parameters in place while the writer runs
    step(torch.rand(8, 32, 32, 2), torch.full((8, 1), 0.3), 1e-3)
    writer.close()
    (p_sync, m_sync), (p_async, m_async) = (checkpoint.load_checkpoint(d)
                                            for d in (sync_dir, async_dir))
    # torch.save stamps each file with a random serialization id, so the
    # digests differ; the metas agree otherwise and the payloads exactly
    assert m_sync.pop("state_sha256") != m_async.pop("state_sha256")
    assert m_sync == m_async
    assert_trees_equal(p_sync, p_async)
    assert_trees_equal(load_pth(str(tmp_path / "best.pth")), pth_weights)


def test_writer_error_surfaces_on_wait(tmp_path):
    writer = checkpoint.AsyncCheckpointWriter()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer.submit_checkpoint(str(blocker), {"x": torch.zeros(2)}, META)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.wait()
    writer.close()


@pytest.mark.parametrize("damage", ["flip_byte", "truncate", "missing"])
def test_falls_back_to_the_previous_generation(tmp_path, damage):
    run = str(tmp_path)
    for epoch in (1, 2):
        checkpoint.save_checkpoint(run, {"w": torch.full((4,), float(epoch))},
                                   dict(META, epoch=epoch))
    path = os.path.join(run, checkpoint.CKPT_DIR, checkpoint.CKPT_FILE)
    if damage == "missing":
        os.remove(path)
    else:
        data = bytearray(open(path, "rb").read())
        data = data[:-7] if damage == "truncate" else data
        if damage == "flip_byte":
            data[-3] ^= 0xFF
        open(path, "wb").write(bytes(data))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        payload, meta = checkpoint.load_checkpoint(run)
    assert meta["epoch"] == 1 and torch.equal(payload["w"], torch.ones(4))
    assert any("previous generation" in str(w.message) for w in caught)


def test_every_generation_corrupt_raises_and_none_is_none(tmp_path):
    assert checkpoint.load_checkpoint(str(tmp_path)) is None
    checkpoint.save_checkpoint(str(tmp_path), {"w": torch.ones(2)}, META)
    path = os.path.join(str(tmp_path), checkpoint.CKPT_DIR, checkpoint.CKPT_FILE)
    open(path, "wb").write(b"garbage")
    with pytest.raises(ValueError, match="unreadable"):
        checkpoint.load_checkpoint(str(tmp_path))


def test_port_trained_pth_loads_in_jax_with_the_same_predictions(tmp_path):
    state, _ = trained_state(steps=3)
    path = str(tmp_path / "model.pth")
    writer = checkpoint.AsyncCheckpointWriter()
    writer.submit_pth(path, state.model.state_dict())
    writer.close()

    variables = jconv.load_pth(path, "single")
    jmodel = jreg.build_model(jcfg.ModelConfig(compute_dtype="f32", **CFG))
    x = np.random.default_rng(4).random((4, 32, 32, 2)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = state.model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
