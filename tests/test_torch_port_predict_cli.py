"""The port's predict and remote-eval CLIs and its unlabeled pairing against
the JAX package's, on the CPU at small sizes (32 px tiles).

Alphas agree within 1e-5 between the two float32 paths and 5e-4 between
the two bf16 ``--fast`` paths (the tolerances of
tests/test_torch_port_serving.py); the CSV header, keys, file names,
``Num_Tiles`` and unmixed TIFF names must be the same.
"""

import csv
import glob
import os

import numpy as np
import pytest
import torch

from crosstalk_tpu.cli.predict import main as jax_predict
from crosstalk_tpu.cli.remote_eval import main as jax_remote_eval
from crosstalk_tpu.data.index import pair_unlabeled as jax_pair_unlabeled
from crosstalk_tpu_torch.cli.predict import main as port_predict
from crosstalk_tpu_torch.cli.remote_eval import main as port_remote_eval
from crosstalk_tpu_torch.data.index import pair_unlabeled
from crosstalk_tpu_torch.data.tiff import read_tile, write_tile
from tests.conftest import make_synthetic_dataset
from tests.torch_ref import TorchDouble, TorchSingle, burn_in_batch_stats

PX = 32
F32_TOL = 1e-5
FAST_TOL = 5e-4


# --- unlabeled pairing: the naming cases of tests/test_predict_cli.py ------

def _tile(path, value=None, seed=0):
    rng = np.random.default_rng(seed)
    write_tile(str(path), rng.random((16, 16)) if value is None else np.full((16, 16), value))


def _naming_case(root, name):
    mixed, source = root / "Mixed", root / "Source"
    mixed.mkdir()
    source.mkdir()
    pairs = {
        "suffixes": [("foo_mixed.tif", "foo_source.tif"),
                     ("scan3-bleed.tiff", "scan3-source.tiff"),
                     ("cell7.tif", "cell7.tif")],
        "reference_schema": [("image_42_alpha_0.25_mixed.tif",
                              "image_42_alpha_0.25_source.tif")],
        "case_insensitive": [("Foo_Mixed.tif", "foo_source.tif")],
        "ambiguous": [("foo_mixed.tif", "foo_source.tif")],
        "case_collision": [("Foo_Mixed.tif", "foo_source.tif")],
        "nothing_pairs": [],
    }[name]
    for i, (m, s) in enumerate(pairs):
        _tile(mixed / m, seed=i)
        _tile(source / s, seed=100 + i)
    if name == "suffixes":
        _tile(mixed / "lonely_mixed.tif", 0.5)
        _tile(source / "orphan_source.tif", 0.5)
        (mixed / "notes.txt").write_text("not a tif")
    elif name == "ambiguous":
        _tile(mixed / "foo_bleed.tif", 0.1)
    elif name == "case_collision":
        _tile(mixed / "FOO_mixed.tif", 0.1)
    elif name == "nothing_pairs":
        _tile(mixed / "a_mixed.tif", 0.1)
        _tile(source / "b_source.tif", 0.2)
    return str(mixed), str(source)


@pytest.mark.parametrize("name", ["suffixes", "reference_schema", "case_insensitive",
                                  "ambiguous", "case_collision", "nothing_pairs"])
def test_pair_unlabeled_matches_jax(tmp_path, name):
    mixed, source = _naming_case(tmp_path, name)

    def run(pair):
        try:
            index = pair(mixed, source)
        except ValueError as e:
            return f"ValueError: {e}"
        return ([(s.image_id, s.mixed_path, s.source_path) for s in index.samples],
                index.unpaired_mixed, index.unpaired_source,
                all(np.isnan(s.scalar_label) for s in index.samples))

    got, want = run(pair_unlabeled), run(jax_pair_unlabeled)
    assert got == want
    if name in ("ambiguous", "case_collision", "nothing_pairs"):
        assert got.startswith("ValueError")
    else:
        assert got[0] and got[3]


# --- predict CLI, port vs JAX ----------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Whole-image 70x70 pairs (each a 2x2 grid of 32 px tiles, 6 px
    margins) and a tiny checkpoint of each variant."""
    root = tmp_path_factory.mktemp("port_predict")
    mixed, source = root / "Mixed", root / "Source"
    mixed.mkdir()
    source.mkdir()
    rng = np.random.default_rng(21)
    for i in range(5):
        other, src = rng.random((70, 70)) * 1800 + 100, rng.random((70, 70)) * 1800 + 100
        write_tile(str(mixed / f"acq{i}_mixed.tif"), other + 0.3 * src)
        write_tile(str(source / f"acq{i}_source.tif"), src)
    ckpts = {}
    for variant, model in (
        ("single", TorchSingle(initial_filters=8, num_blocks=3, image_size=PX)),
        ("double", TorchDouble(filters_per_branch=4, image_size=PX)),
    ):
        torch.manual_seed(4)
        burn_in_batch_stats(model, PX, steps=2)
        ckpts[variant] = str(root / f"{variant}.pth")
        torch.save(model.state_dict(), ckpts[variant])
    return root, str(mixed), str(source), ckpts


def _run_predict(main, out, mixed, source, flags):
    assert main(["-m", mixed, "-s", source, "-j", "2", "--output_base", out,
                 "--unmix", *flags]) == 0
    (run_dir,) = glob.glob(os.path.join(out, "predict_run_*"))
    ts = os.path.basename(run_dir)[len("predict_run_"):]
    names = sorted(n.replace(ts, "TS") for n in os.listdir(run_dir))
    with open(os.path.join(run_dir, f"predictions_{ts}.csv")) as f:
        rows = list(csv.DictReader(f))
    unmixed = {n: read_tile(os.path.join(run_dir, "unmixed", n))
               for n in sorted(os.listdir(os.path.join(run_dir, "unmixed")))}
    return names, rows, unmixed


def _assert_same_predictions(port, jax_, mixed, source, tol):
    (names, rows, unmixed), (jnames, jrows, junmixed) = port, jax_
    assert names == jnames
    assert list(rows[0]) == list(jrows[0]) == [
        "Image_Key", "Mixed_File", "Source_File", "Predicted_Alpha", "Num_Tiles",
        "Alpha_Std"]
    for key in ("Image_Key", "Mixed_File", "Source_File", "Num_Tiles"):
        assert [r[key] for r in rows] == [r[key] for r in jrows]
    assert {r["Num_Tiles"] for r in rows} == {"4"}
    for key in ("Predicted_Alpha", "Alpha_Std"):
        got = np.array([float(r[key]) for r in rows])
        want = np.array([float(r[key]) for r in jrows])
        np.testing.assert_allclose(got, want, rtol=0, atol=tol + 1e-6, err_msg=key)
    assert sorted(unmixed) == sorted(junmixed) == sorted(
        f"{r['Image_Key']}_unmixed.tif" for r in rows)
    for r in rows:  # each unmixed image uses its own row's alpha
        m = read_tile(os.path.join(mixed, r["Mixed_File"]))
        s = read_tile(os.path.join(source, r["Source_File"]))
        want = np.clip(m - float(r["Predicted_Alpha"]) * s, 0.0, None)
        np.testing.assert_allclose(unmixed[f"{r['Image_Key']}_unmixed.tif"], want,
                                   rtol=0, atol=2e-3)


@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "fast"])
def test_port_predict_cli_matches_jax_cli(setup, variant, fast):
    root, mixed, source, ckpts = setup
    tag = f"{variant}_{'fast' if fast else 'f32'}"
    flags = ["-p", ckpts[variant], "-o", variant, "-b", "3"] + (["--fast"] if fast else [])
    port = _run_predict(port_predict, str(root / f"port_{tag}"), mixed, source,
                        flags + ["--device", "cpu"])
    jax_ = _run_predict(jax_predict, str(root / f"jax_{tag}"), mixed, source, flags)
    _assert_same_predictions(port, jax_, mixed, source, FAST_TOL if fast else F32_TOL)


@pytest.fixture(scope="module")
def port_server(setup):
    """The port's server (``--device cpu``, f32 parity, batch 4) on the
    single-branch checkpoint, built through the serve CLI."""
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server

    _, _, _, ckpts = setup
    server, _ = build_server(build_parser().parse_args(
        ["-p", ckpts["single"], "--device", "cpu", "--port", "0", "--parity",
         "--batch_size", "4", "--max_delay_ms", "2"]))
    try:
        server.start_background()
        yield "http://%s:%d" % server.address
    finally:
        server.shutdown()


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_port_predict_cli_url_matches_jax_cli(setup, port_server, dtype):
    root, mixed, source, ckpts = setup
    flags = ["--url", port_server, "--dtype", dtype, "--request_tiles", "3"]
    port = _run_predict(port_predict, str(root / f"port_url_{dtype}"), mixed, source, flags)
    jax_ = _run_predict(jax_predict, str(root / f"jax_url_{dtype}"), mixed, source, flags)
    _assert_same_predictions(port, jax_, mixed, source, 0.0)
    if dtype == "float32":  # the server's f32 path against the local one
        local = _run_predict(port_predict, str(root / "port_local_f32"), mixed, source,
                             ["-p", ckpts["single"], "--device", "cpu", "-b", "4"])
        _assert_same_predictions(port, local, mixed, source, F32_TOL)


def test_remote_eval_same_csv_from_both_packages(tmp_path, port_server):
    mixed, source = make_synthetic_dataset(str(tmp_path / "data"), n=7, size=PX)
    out = {}
    for tag, main in (("port", port_remote_eval), ("jax", jax_remote_eval)):
        base = tmp_path / tag
        base.mkdir()
        assert main(["-m", mixed, "-s", source, "--url", port_server,
                     "-o", str(base), "--request_tiles", "3", "-j", "1"]) == 0
        (run_dir,) = glob.glob(str(base / "eval_run_*"))
        ts = os.path.basename(run_dir)[len("eval_run_"):]
        names = sorted(n.replace(ts, "TS") for n in os.listdir(run_dir))
        with open(os.path.join(run_dir, f"test_predictions_{ts}.csv")) as f:
            out[tag] = (names, f.read())
    assert out["port"] == out["jax"]
    assert out["port"][1].splitlines()[0] == "Image_ID,Actual_Label,Predicted_Label"
    assert len(out["port"][1].splitlines()) == 8
    assert port_remote_eval(["-m", mixed, "-s", source, "--url", "http://127.0.0.1:9",
                             "-o", str(tmp_path)]) == 1


# --- flags -----------------------------------------------------------------

@pytest.mark.parametrize("flags,message", [
    (["--artifact", "m.ctkt", "-p", "m.pth"], "exactly one of"),
    (["-p", "m.pth", "--int8", "--fast"], "distinct serving tiers"),
    (["--url", "http://h:1", "--int8"], "--int8 requires a local checkpoint"),
    (["--artifact", "m.ctkt", "--int8"], "--int8 requires a local checkpoint"),
    (["-p", "m.pth", "--int8", "-o", "double"], "gated to the single-branch family"),
    (["--artifact", "m.ctkt", "--url", "http://h:1"], "exactly one of"),
    (["-p", "m.pth", "--num_devices", "2"], "--num_devices 2"),
    ([], "exactly one of"),
    (["-p", "m.pth", "--url", "http://h:1"], "exactly one of"),
    (["--url", "http://h:1", "--request_tiles", "0"], "--request_tiles must be positive"),
    (["-p", "m.pth", "-b", "0"], "--batch_size must be positive"),
])
def test_predict_cli_rejects_flags(tmp_path, flags, message, capsys):
    assert port_predict(["-m", str(tmp_path), "-s", str(tmp_path), "--device", "cpu",
                         "--output_base", str(tmp_path), *flags]) == 1
    out = capsys.readouterr().out
    assert out.startswith("Error") and message in out
    assert not list(tmp_path.glob("predict_run_*"))


def test_predict_cli_errors(setup, tmp_path, capsys):
    root, mixed, source, ckpts = setup
    assert port_predict(["-m", mixed, "-s", source, "-p", str(tmp_path / "no.pth"),
                         "--device", "cpu", "--output_base", str(tmp_path)]) == 1
    assert "Error loading model" in capsys.readouterr().out
    assert port_predict(["-m", mixed, "-s", source, "--url", "http://127.0.0.1:9",
                         "--output_base", str(tmp_path)]) == 1
    assert "not reachable" in capsys.readouterr().out
    small_m, small_s = tmp_path / "m", tmp_path / "s"
    small_m.mkdir()
    small_s.mkdir()
    _tile(small_m / "t_mixed.tif")
    _tile(small_s / "t_source.tif")
    assert port_predict(["-m", str(small_m), "-s", str(small_s), "-p", ckpts["single"],
                         "--device", "cpu", "--output_base", str(tmp_path)]) == 1
    assert "must be at least 32px" in capsys.readouterr().out


def test_predict_cli_without_device_raises_on_a_cudaless_host(setup, tmp_path, monkeypatch):
    _, mixed, source, ckpts = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_predict(["-m", mixed, "-s", source, "-p", ckpts["single"],
                      "--output_base", str(tmp_path)])
