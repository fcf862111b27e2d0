"""The port's native C++ TIFF decoder against the JAX package's native
decoder and its Python decoder, bitwise, on every flavour the dataset and
the JAX tests use: the ``uniform`` and ``microscopy`` synthetic sets,
float32 / uint16 / uint8 tiles, a tile of the right pixel count in the
transposed shape, a bad path, a wrong output shape, inline multistrip
offsets and the JAX fuzz cases. Then the build cache (a second process
loads the library the first built) and the decoder counter."""

import os
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from crosstalk_tpu.data import native_loader as jnative
from crosstalk_tpu.data import pipeline as jpipe
from crosstalk_tpu.data.index import PairIndex as JPairIndex
from crosstalk_tpu.data.index import Sample as JSample
from crosstalk_tpu.data.synthetic import generate_dataset as jax_generate_dataset
from crosstalk_tpu_torch.data import native_loader, pipeline
from crosstalk_tpu_torch.data.index import PairIndex, Sample
from crosstalk_tpu_torch.data.tiff import write_tile
from crosstalk_tpu_torch.ops import _build
from tests.test_native_loader import _write_two_strip_tiff

ROOT = Path(__file__).resolve().parents[1]


def _both_native(mixed, source, shape, threads=2):
    """-> ((accepted, out) of the port, (accepted, out) of the JAX decoder)."""
    results = []
    for load in (native_loader.load_pairs_native, jnative.load_pairs_native):
        out = np.full((len(mixed), *shape, 2), -7.0, np.float32)
        results.append((load(mixed, source, out, threads=threads), out))
    return results


def _assert_three_decoders_equal(mixed_dir, source_dir):
    samples = PairIndex(mixed_dir, source_dir).samples
    jsamples = JPairIndex(mixed_dir, source_dir).samples
    before = dict(pipeline.load_tiles.decoded)
    ours = pipeline.load_tiles(samples, jobs=4)
    assert pipeline.load_tiles.decoded["native"] == before["native"] + len(samples)
    assert pipeline.load_tiles.decoded["python"] == before["python"]
    jax_native = np.empty_like(ours)
    assert jnative.load_pairs_native([s.mixed_path for s in jsamples],
                                     [s.source_path for s in jsamples], jax_native, threads=4)
    jax_python = jpipe.load_tiles(jsamples, jobs=2, use_native=False)
    np.testing.assert_array_equal(ours, jax_native)
    np.testing.assert_array_equal(ours, jax_python)


@pytest.fixture(autouse=True)
def _built():
    assert native_loader.native_available(), native_loader.build_status()
    assert jnative.native_available()


@pytest.mark.parametrize("preset", ["uniform", "microscopy"])
def test_synthetic_sets_decode_bitwise_like_both_jax_decoders(preset, tmp_path):
    mixed, source = jax_generate_dataset(str(tmp_path), num_pairs=6, size=32, seed=3,
                                         progress_every=0, preset=preset)
    _assert_three_decoders_equal(mixed, source)


@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.uint8])
def test_integer_and_float32_tiles_decode_bitwise_like_both_jax_decoders(dtype, tmp_path):
    rng = np.random.default_rng(4)
    for d in ("Mixed", "Source"):
        (tmp_path / d).mkdir()
    for i in range(4):
        name = f"image_{10 + i}_alpha_0.{i + 1}"
        for d, role in (("Mixed", "mixed"), ("Source", "source")):
            if np.dtype(dtype).kind == "f":
                tile = rng.random((24, 40)).astype(dtype)
            else:
                tile = rng.integers(0, np.iinfo(dtype).max, (24, 40), dtype=dtype)
            write_tile(str(tmp_path / d / f"{name}_{role}.tif"), tile)
    _assert_three_decoders_equal(str(tmp_path / "Mixed"), str(tmp_path / "Source"))


def test_transposed_tile_of_the_same_pixel_count_is_rejected_alike(tmp_path):
    good, bad = str(tmp_path / "good.tif"), str(tmp_path / "bad.tif")
    write_tile(good, np.arange(256, dtype=np.float64).reshape(16, 16) / 256)
    write_tile(bad, np.arange(256, dtype=np.float64).reshape(8, 32) / 256)
    (ours, _), (jax, _) = _both_native([bad], [good], (16, 16), threads=1)
    assert not ours and not jax
    (ours, a), (jax, b) = _both_native([good], [good], (16, 16), threads=1)
    assert ours and jax and np.array_equal(a, b)

    # through load_tiles: the Python decoder raises the same clear error
    paths = {}
    for name, shape, value in (("a_mixed", (16, 16), 0.25), ("a_source", (16, 16), 0.5),
                               ("b_mixed", (8, 32), 0.75), ("b_source", (16, 16), 0.5)):
        paths[name] = str(tmp_path / f"{name}.tif")
        write_tile(paths[name], np.zeros(shape) + value)
    errors = []
    for load, sample in ((pipeline.load_tiles, Sample), (jpipe.load_tiles, JSample)):
        samples = [sample("a", 0.1, paths["a_mixed"], paths["a_source"]),
                   sample("b", 0.2, paths["b_mixed"], paths["b_source"])]
        with pytest.raises(ValueError, match="inconsistent tile size.*b_mixed") as e:
            load(samples, jobs=1)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_bad_path_falls_back_with_the_same_error(tmp_path):
    mixed, source = jax_generate_dataset(str(tmp_path), num_pairs=3, size=32,
                                         progress_every=0)
    samples = PairIndex(mixed, source).samples
    bad = ["/does/not/exist.tif"] * len(samples)
    (ours, _), (jax, _) = _both_native(bad, [s.source_path for s in samples], (32, 32))
    assert not ours and not jax
    # the first pair is readable (it sets the tile size); a later one is not
    errors = []
    for load, sample in ((pipeline.load_tiles, Sample), (jpipe.load_tiles, JSample)):
        pairs = [sample(s.image_id, s.scalar_label, s.mixed_path, s.source_path)
                 for s in samples]
        pairs[1] = sample("x", 0.1, "/does/not/exist.tif", samples[1].source_path)
        with pytest.raises(FileNotFoundError) as e:
            load(pairs, jobs=2)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("shape", [(16, 16), (32, 16), (16, 32)])
def test_wrong_output_shape_is_rejected_alike(shape, tmp_path):
    mixed, source = jax_generate_dataset(str(tmp_path), num_pairs=3, size=32,
                                         progress_every=0)
    samples = PairIndex(mixed, source).samples
    (ours, _), (jax, _) = _both_native([s.mixed_path for s in samples],
                                       [s.source_path for s in samples], shape)
    assert not ours and not jax


def test_inline_multistrip_offsets_decode_alike(tmp_path):
    rng = np.random.default_rng(7)
    mixed = rng.random((32, 32)).astype(np.float32)
    source = rng.random((32, 32)).astype(np.float32)
    mp, sp = str(tmp_path / "m.tif"), str(tmp_path / "s.tif")
    _write_two_strip_tiff(mp, mixed)
    _write_two_strip_tiff(sp, source)
    (ours, a), (jax, b) = _both_native([mp], [sp], (32, 32), threads=1)
    assert ours and jax
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[0, :, :, 0], mixed)
    np.testing.assert_array_equal(a[0, :, :, 1], source)


def _fuzz_cases(blob: bytes, rng) -> dict:
    """The JAX package's malformed files (tests/test_native_loader.py
    test_native_fuzz_malformed_tiffs) and 200 byte mutations of a valid one
    (test_native_fuzz_byte_mutations)."""
    cases = {
        "empty": b"",
        "short": b"II",
        "bad_magic": b"MM\x00\x2a" + blob[4:],
        "ifd_past_eof": blob[:4] + struct.pack("<I", 10**6) + blob[8:],
        "random_noise": bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
        "truncated_half": blob[: len(blob) // 2],
        "truncated_ifd": blob[:-20],
        "counts_past_eof": blob[:-40] + b"\xff" * 40,
    }
    for k in range(200):
        mut = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            mut[int(rng.integers(0, len(mut)))] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            mut = mut[: int(rng.integers(1, len(mut)))]
        cases[f"mutation_{k}"] = bytes(mut)
    return cases


def test_fuzzed_files_are_accepted_and_rejected_alike(tmp_path):
    rng = np.random.default_rng(1)
    good = rng.random((32, 32)).astype(np.float32)
    gp = str(tmp_path / "good.tif")
    _write_two_strip_tiff(gp, good)
    blob = Path(gp).read_bytes()
    p = str(tmp_path / "case.tif")
    verdicts = {True: 0, False: 0}
    for name, payload in _fuzz_cases(blob, rng).items():
        Path(p).write_bytes(payload)
        (ours, a), (jax, b) = _both_native([p], [gp], (32, 32), threads=1)
        assert ours == jax, name
        if ours:
            np.testing.assert_array_equal(a, b, err_msg=name)
        verdicts[ours] += 1
    assert verdicts[True] > 0 and verdicts[False] > 8, verdicts
    # no sticky state after the failures
    (ours, a), _ = _both_native([gp], [gp], (32, 32), threads=1)
    assert ours and np.array_equal(a[0, :, :, 0], good)


def test_exotic_flavour_falls_back_to_python_and_is_counted(tmp_path):
    """int16 tiles are outside the native decoder's flavours: load_tiles
    serves them with the Python decoder (JAX's pixels) and counts them."""
    rng = np.random.default_rng(5)
    for d in ("Mixed", "Source"):
        (tmp_path / d).mkdir()
        for i in range(3):
            write_tile(str(tmp_path / d / f"image_{i}_alpha_0.1_{d.lower()}.tif"),
                       rng.integers(-300, 300, (16, 16), dtype=np.int16))
    mixed, source = str(tmp_path / "Mixed"), str(tmp_path / "Source")
    before = dict(pipeline.load_tiles.decoded)
    ours = pipeline.load_tiles(PairIndex(mixed, source).samples, jobs=2)
    assert pipeline.load_tiles.decoded["python"] == before["python"] + 3
    assert pipeline.load_tiles.decoded["native"] == before["native"]
    np.testing.assert_array_equal(ours, jpipe.load_tiles(JPairIndex(mixed, source).samples))


def test_decoder_counter_is_exact_under_concurrent_callers(tmp_path):
    mixed, source = jax_generate_dataset(str(tmp_path), num_pairs=2, size=16,
                                         progress_every=0)
    samples = PairIndex(mixed, source).samples
    before = dict(pipeline.load_tiles.decoded)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for k in range(25):
                pipeline.load_tiles(samples, use_native=k % 2 == 0)

        threads = [threading.Thread(target=work) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert pipeline.load_tiles.decoded["native"] - before["native"] == 12 * 13 * 2
    assert pipeline.load_tiles.decoded["python"] - before["python"] == 12 * 12 * 2


_STATUS = (
    "import sys, json\n"
    "from pathlib import Path\n"
    "from crosstalk_tpu_torch.ops import _build\n"
    "_build.NATIVE_BUILD_DIR = Path(sys.argv[1])\n"
    "from crosstalk_tpu_torch.data import native_loader\n"
    "print(json.dumps(native_loader.build_status()))\n"
)


def test_build_cache_second_process_loads_without_rebuilding(tmp_path):
    import json

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _STATUS, str(tmp_path)], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first, second = runs
    assert first["error"] is None and first["built"] is True
    assert second["error"] is None and second["built"] is False
    assert first["path"] == second["path"]
    assert [p.name for p in tmp_path.iterdir()] == [Path(first["path"]).name]


def test_library_is_the_ports_own_and_keyed_on_source_flags_and_cpu(monkeypatch):
    path = _build.native_library("tile_loader")
    assert path.parent == ROOT / ".cache" / "crosstalk_tpu_torch" / "native"
    assert path.name.startswith("libtile_loader_")
    assert native_loader.build_status()["path"] == str(path)
    monkeypatch.setattr(_build, "_host_cpu", lambda: "another cpu")
    assert _build.native_library("tile_loader") != path
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-g",))
    assert _build.native_library("tile_loader") != path
