"""The port's serving stack (``crosstalk_tpu_torch.serve`` and
``cli/serve.py``) against the JAX package's, on the CPU at small sizes.

Tolerances: 1e-5 between the two float32 paths, 5e-4 between the two bf16
fast paths, the fast forward's JAX-parity tolerance
(tests/test_torch_port_fast_forward.py): both keep the head's products in
f32, and round the trunk in bf16 in two conv libraries (measured up to
2.7e-4 on raw-intensity tiles). Wire transforms and request decoding are
the same numpy code in both packages, so they are held to bit equality.
"""

import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import crosstalk_tpu.serve.batcher as jax_batcher
import crosstalk_tpu.serve.server as jax_server
import crosstalk_tpu_torch.serve.batcher as port_batcher
import crosstalk_tpu_torch.serve.server as port_server
from crosstalk_tpu.io.torch_convert import load_pth as jax_load_pth
from crosstalk_tpu.io.torch_convert import model_config_for_checkpoint as jax_cfg_for
from crosstalk_tpu.serve.client import CrosstalkClient as JaxClient
from crosstalk_tpu.serve.predictor import make_predictor as jax_make_predictor
from crosstalk_tpu.serve.wire import to_f16_wire as jax_to_f16_wire
from crosstalk_tpu_torch.io.torch_convert import load_pth, model_config_for_checkpoint
from crosstalk_tpu_torch.serve.client import CrosstalkClient as PortClient
from crosstalk_tpu_torch.serve.predictor import make_predictor
from crosstalk_tpu_torch.serve.wire import to_f16_wire
from tests.torch_ref import TorchDouble, TorchSingle, burn_in_batch_stats

ROOT = Path(__file__).resolve().parents[1]
TILE = (8, 8, 2)
PX = 32
F32_TOL = 1e-5
FAST_TOL = 5e-4
BATCHERS = {"jax": jax_batcher.DynamicBatcher, "port": port_batcher.DynamicBatcher}


def _mean_predict(batch):
    return batch.mean(axis=(1, 2, 3))


@pytest.fixture(params=sorted(BATCHERS))
def Batcher(request):
    return BATCHERS[request.param]


# --- the batcher cases of tests/test_serving.py, for both packages ---------

def test_batcher_sizes_and_padding(Batcher):
    b = Batcher(_mean_predict, batch_size=4, tile_shape=TILE, max_delay_ms=1.0)
    try:
        rng = np.random.default_rng(0)
        for n in (1, 3, 4, 7, 11):
            tiles = rng.random((n,) + TILE, np.float32)
            got = b.submit(tiles).result(timeout=30)
            np.testing.assert_allclose(got, _mean_predict(tiles), rtol=1e-6)
        stats = b.stats()
        assert stats["requests"] == 5
        assert stats["tiles"] == 26
        assert stats["batches"] >= 7
    finally:
        b.close()


def test_batcher_buckets_dispatch_smallest_fit(Batcher):
    calls = []

    def predict(batch):
        calls.append(batch.shape[0])
        return _mean_predict(batch)

    b = Batcher(predict, batch_size=8, tile_shape=TILE, max_delay_ms=1.0,
                bucket_sizes=[2, 4])
    try:
        rng = np.random.default_rng(7)
        for n in (1, 3, 9):
            tiles = rng.random((n,) + TILE, np.float32)
            got = b.submit(tiles).result(timeout=30)
            np.testing.assert_allclose(got, _mean_predict(tiles), rtol=1e-6)
        assert calls == [2, 4, 8, 2]
        stats = b.stats()
        assert stats["bucket_sizes"] == [2, 4, 8]
        assert stats["capacity_rows"] == 16
        assert stats["padded_rows"] == 3
        assert stats["mean_batch_occupancy"] == pytest.approx(13 / 16)
    finally:
        b.close()
    with pytest.raises(ValueError):
        Batcher(_mean_predict, batch_size=4, tile_shape=TILE, bucket_sizes=[8])
    with pytest.raises(ValueError):
        Batcher(_mean_predict, batch_size=4, tile_shape=TILE, bucket_sizes=[0])


def test_batcher_coalesces_concurrent_requests(Batcher):
    calls = []

    def predict(batch):
        calls.append(batch.shape[0])
        time.sleep(0.01)
        return _mean_predict(batch)

    b = Batcher(predict, batch_size=8, tile_shape=TILE, max_delay_ms=200.0)
    try:
        rng = np.random.default_rng(1)
        tiles = [rng.random((1,) + TILE, np.float32) for _ in range(16)]
        results = [None] * 16

        def worker(i):
            results[i] = b.submit(tiles[i]).result(timeout=30)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i in range(16):
            np.testing.assert_allclose(results[i], _mean_predict(tiles[i]), rtol=1e-6)
        assert b.stats()["batches"] < 16
    finally:
        b.close()


def test_batcher_error_propagates_and_recovers(Batcher):
    state = {"fail": True}

    def predict(batch):
        if state["fail"]:
            raise RuntimeError("boom")
        return _mean_predict(batch)

    b = Batcher(predict, batch_size=2, tile_shape=TILE, max_delay_ms=1.0)
    try:
        bad = b.submit(np.zeros((3,) + TILE, np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            bad.result(timeout=30)
        state["fail"] = False
        tiles = np.random.default_rng(2).random((2,) + TILE, np.float32)
        np.testing.assert_allclose(
            b.submit(tiles).result(timeout=30), _mean_predict(tiles), rtol=1e-6)
    finally:
        b.close()


def test_batcher_assembly_failure_resolves_futures(Batcher):
    b = Batcher(_mean_predict, batch_size=4, tile_shape=TILE, max_delay_ms=200.0)
    try:
        fut = b.submit(np.ones((2,) + TILE, np.float32))
        b._tile_shape = (-1,) + TILE[1:]
        with pytest.raises(Exception):
            fut.result(timeout=30)
        b._tile_shape = TILE
        tiles = np.random.default_rng(3).random((2,) + TILE).astype(np.float32)
        np.testing.assert_allclose(
            b.submit(tiles).result(timeout=30), _mean_predict(tiles), rtol=1e-6)
    finally:
        b.close()


@pytest.mark.parametrize("bucket_sizes", [None, [3, 5]])
def test_batcher_randomized_stress(Batcher, bucket_sizes):
    processed = []
    lock = threading.Lock()

    def predict(batch):
        with lock:
            processed.append(batch.shape[0])
        return _mean_predict(batch)

    b = Batcher(predict, batch_size=8, tile_shape=TILE, max_delay_ms=3.0,
                bucket_sizes=bucket_sizes)
    try:
        n_threads, per_thread = 12, 6
        results = [[None] * per_thread for _ in range(n_threads)]
        tiles = [
            [np.random.default_rng(100 + 17 * t + k).random(
                (int(np.random.default_rng(7 * t + k).integers(1, 20)),) + TILE,
                np.float32)
             for k in range(per_thread)]
            for t in range(n_threads)
        ]

        def worker(t):
            rng = np.random.default_rng(1000 + t)
            for k in range(per_thread):
                time.sleep(float(rng.random()) * 0.004)
                results[t][k] = b.submit(tiles[t][k]).result(timeout=60)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        for t in range(n_threads):
            for k in range(per_thread):
                np.testing.assert_allclose(
                    results[t][k], _mean_predict(tiles[t][k]), rtol=1e-6)
        total = sum(x.shape[0] for row in tiles for x in row)
        stats = b.stats()
        assert stats["tiles"] == total
        shapes = {8} if bucket_sizes is None else set(bucket_sizes) | {8}
        assert set(processed) <= shapes
        assert stats["capacity_rows"] - stats["padded_rows"] == total
    finally:
        b.close()


def test_batcher_validates_and_closes(Batcher):
    b = Batcher(_mean_predict, batch_size=2, tile_shape=TILE, max_delay_ms=1.0)
    with pytest.raises(ValueError):
        b.submit(np.zeros((2, 8, 8, 3), np.float32))
    with pytest.raises(ValueError):
        b.submit(np.zeros((0,) + TILE, np.float32))
    pending = b.submit(np.zeros((5,) + TILE, np.float32))
    b.close()
    assert pending.result(timeout=30).shape == (5,)
    with pytest.raises(RuntimeError):
        b.submit(np.zeros((1,) + TILE, np.float32))


@pytest.mark.parametrize("spec", ["8,32", "32, 8,8", "x,2", "0", "64", ""])
def test_parse_batch_buckets_matches_jax(spec):
    def run(parse):
        try:
            return parse(spec, 32)
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(port_batcher.parse_batch_buckets) == run(jax_batcher.parse_batch_buckets)


# --- wire transform and request decoding: bit-identical to JAX -------------

def _wire_case(name):
    rng = np.random.default_rng(3)
    if name == "random":
        return (rng.random((3, 8, 8, 2)) * 87000.0 - 1000.0).astype(np.float32), (1, 2)
    if name == "constant":
        a = rng.random((3, 8, 8, 2)).astype(np.float32)
        a[1, :, :, 0] = 70000.0
        a[2, :, :, 1] = 5.0
        return a, (1, 2)
    if name == "saturated_uint16":
        a = (rng.random((2, 8, 8, 2)) * 65535).astype(np.uint16)
        a[:, :4] = 65535
        return a, (1, 2)
    if name == "single_plane":
        return rng.random((8, 8)) * 1e5, (0, 1)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "constant", "saturated_uint16", "single_plane"])
def test_to_f16_wire_bit_identical_to_jax(name):
    arr, axes = _wire_case(name)
    got, want = to_f16_wire(arr, axes), jax_to_f16_wire(arr, axes)
    assert got.dtype == want.dtype == np.float16
    assert np.isfinite(got.astype(np.float32)).all()
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _body(name) -> bytes:
    rng = np.random.default_rng(5)
    if name == "float32":
        return _npz(tiles=(rng.random((2, 8, 8, 2)) * 1e5).astype(np.float32))
    if name == "float16":
        return _npz(tiles=rng.random((2, 8, 8, 2)).astype(np.float16))
    if name == "uint16":
        t = (rng.random((2, 8, 8, 2)) * 65535).astype(np.uint16)
        t[0, 0, 0, 0] = 65535
        return _npz(tiles=t)
    if name == "float64":
        return _npz(tiles=rng.random((2, 8, 8, 2)) * 1800 + 100)
    if name == "mixed_source":
        return _npz(mixed=rng.random((3, 8, 8)), source=rng.random((3, 8, 8)))
    if name == "one_2d_tile":
        return _npz(mixed=rng.random((8, 8)), source=rng.random((8, 8)))
    raise KeyError(name)


@pytest.mark.parametrize("transport", ["float32", "float16"])
@pytest.mark.parametrize("name", ["float32", "float16", "uint16", "float64",
                                  "mixed_source", "one_2d_tile"])
def test_decode_request_same_arrays_as_jax(name, transport):
    body = _body(name)
    got = port_server._decode_request(body, (8, 8), 16, np.dtype(transport))
    want = jax_server._decode_request(body, (8, 8), 16, np.dtype(transport))
    assert got.dtype == want.dtype == np.dtype(transport)
    assert got.shape == want.shape and got.shape[1:] == TILE
    np.testing.assert_array_equal(got, want)


def _bad_body(name):
    """-> (body, max_tiles, transport dtype)"""
    if name == "not_a_zip":
        return b"garbage" * 100, 16, "float32"
    if name == "empty":
        return b"", 16, "float32"
    if name == "truncated":
        ok = _npz(tiles=np.zeros((1, 8, 8, 2), np.float32))
        return ok[: len(ok) // 2], 16, "float32"
    if name == "non_npy_member":
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            zf.writestr("tiles.npy", b"this is not numpy data")
        return buf.getvalue(), 16, "float32"
    if name == "zip_bomb":
        buf = io.BytesIO()
        np.savez_compressed(buf, tiles=np.zeros((100_000, 8, 8, 2), np.float32))
        return buf.getvalue(), 4096, "float32"
    if name == "wide_dtype":
        buf = io.BytesIO()
        np.savez_compressed(buf, tiles=np.zeros((4, 8, 8, 2), dtype=[("v", "V256")]))
        return buf.getvalue(), 4, "float32"
    if name == "object_dtype":
        obj = np.empty((2, 2), dtype=object)
        buf, member = io.BytesIO(), io.BytesIO()
        np.lib.format.write_array(member, obj, allow_pickle=True)
        with zipfile.ZipFile(buf, "w") as zf:
            zf.writestr("tiles.npy", member.getvalue())
        return buf.getvalue(), 4, "float32"
    if name == "non_finite":
        return _npz(tiles=np.full((1, 8, 8, 2), np.inf, np.float32)), 4, "float32"
    if name == "non_finite_f16_transport":
        return _npz(tiles=np.full((1, 8, 8, 2), np.nan, np.float64)), 4, "float16"
    if name == "overflowing":
        return _npz(tiles=np.full((1, 8, 8, 2), 1e39)), 4, "float32"
    if name == "wrong_size":
        return _npz(tiles=np.zeros((1, 16, 16, 2), np.float32)), 4, "float32"
    if name == "too_many_tiles":
        return _npz(tiles=np.zeros((3, 8, 8, 2), np.float16)), 2, "float32"
    if name == "mismatched_pair":
        return _npz(mixed=np.zeros((2, 8, 8)), source=np.zeros((1, 8, 8))), 4, "float32"
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "not_a_zip", "empty", "truncated", "non_npy_member", "zip_bomb", "wide_dtype",
    "object_dtype", "non_finite", "non_finite_f16_transport", "overflowing",
    "wrong_size", "too_many_tiles", "mismatched_pair",
])
def test_decode_request_same_errors_as_jax(name):
    body, max_tiles, transport = _bad_body(name)
    msgs = []
    for decode in (port_server._decode_request, jax_server._decode_request):
        with pytest.raises(ValueError) as info:
            decode(body, (8, 8), max_tiles, np.dtype(transport))
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


# --- predictor and servers on the same .pth --------------------------------

@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_serving")
    out = {}
    for variant, model in (
        ("single", TorchSingle(initial_filters=8, num_blocks=3, image_size=PX)),
        ("double", TorchDouble(filters_per_branch=4, image_size=PX)),
    ):
        torch.manual_seed(3)
        burn_in_batch_stats(model, PX, steps=2)
        path = str(root / f"{variant}.pth")
        torch.save(model.state_dict(), path)
        out[variant] = path
    return out


def _predictors(path, variant, fast, input_dtype, buckets):
    dt = "bf16" if fast else "f32"
    jv = jax_load_pth(path, variant)
    jp = jax_make_predictor(jv, jax_cfg_for(variant, jv, compute_dtype=dt), buckets,
                            image_size=PX, fast=fast, input_dtype=input_dtype)
    sd = load_pth(path)
    pp = make_predictor(sd, model_config_for_checkpoint(variant, sd, compute_dtype=dt),
                        buckets, image_size=PX, fast=fast, input_dtype=input_dtype,
                        device="cpu")
    return pp, jp


@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("fast,input_dtype", [
    (False, np.float32), (True, np.float32), (True, np.float16)],
    ids=["f32", "fast", "fast_f16_input"])
def test_make_predictor_matches_jax(ckpts, variant, fast, input_dtype):
    port, jax_ = _predictors(ckpts[variant], variant, fast, input_dtype, (1, 3, 4))
    rng = np.random.default_rng(8)
    raw = (rng.random((4, PX, PX, 2)) * 1800 + 100).astype(np.float32)
    if input_dtype == np.float16:
        raw = to_f16_wire(raw, (1, 2))
    tol = FAST_TOL if fast else F32_TOL
    for n in (1, 3, 4):
        got = port(raw[:n])
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, jax_(raw[:n]), rtol=0, atol=tol)
    with pytest.raises(ValueError, match="with n in"):
        port(raw[:2])  # not a bucket
    with pytest.raises(ValueError):
        port(raw[:, :16])


def test_make_predictor_without_device_raises_on_a_cudaless_host(ckpts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = load_pth(ckpts["single"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_predictor(sd, model_config_for_checkpoint("single", sd), 4, image_size=PX)


def _start(server):
    server.start_background()
    return "http://%s:%d" % server.address


@pytest.fixture(scope="module", params=["f32", "fast"])
def both_servers(request, ckpts):
    """The port's server and the JAX server on the same tiny single-branch
    checkpoint, same path and buckets."""
    fast = request.param == "fast"
    port_predict, jax_predict = _predictors(ckpts["single"], "single", fast,
                                            np.float32, (2, 4))
    servers = [
        port_server.CrosstalkServer(port_predict, batch_size=4, image_size=PX,
                                    port=0, max_delay_ms=2.0, bucket_sizes=[2],
                                    model_info={"model": "single"}),
        jax_server.CrosstalkServer(jax_predict, batch_size=4, image_size=PX,
                                   port=0, max_delay_ms=2.0, bucket_sizes=[2],
                                   model_info={"model": "single"}),
    ]
    try:
        urls = [_start(s) for s in servers]
        yield urls, (FAST_TOL if fast else F32_TOL)
    finally:
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("wire", [None, "float32", "float16"])
def test_clients_and_servers_cross_match(both_servers, wire):
    (port_url, jax_url), tol = both_servers
    rng = np.random.default_rng(11)
    mixed = rng.random((5, PX, PX)) * 1800 + 100
    source = rng.random((5, PX, PX)) * 1800 + 100
    jax_to_port = JaxClient(port_url).predict(mixed, source, dtype=wire, chunk=3)
    port_to_port = PortClient(port_url).predict(mixed, source, dtype=wire, chunk=3)
    port_to_jax = PortClient(jax_url).predict(mixed, source, dtype=wire, chunk=3)
    jax_to_jax = JaxClient(jax_url).predict(mixed, source, dtype=wire, chunk=3)
    np.testing.assert_array_equal(jax_to_port, port_to_port)
    np.testing.assert_array_equal(port_to_jax, jax_to_jax)
    np.testing.assert_allclose(jax_to_port, port_to_jax, rtol=0, atol=tol)
    stacked = PortClient(port_url).predict(np.stack([mixed, source], -1), dtype=wire, chunk=3)
    np.testing.assert_array_equal(stacked, port_to_port)


def test_health_stats_and_metrics_match_jax_layout(both_servers):
    (port_url, jax_url), _ = both_servers
    for url in (port_url, jax_url):
        PortClient(url).predict(np.random.default_rng(2).random((3, PX, PX, 2)))
    health = [PortClient(u).health() for u in (port_url, jax_url)]
    assert health[0] == health[1] == {"status": "ok", "model": "single"}
    stats = [PortClient(u).stats() for u in (port_url, jax_url)]
    assert sorted(stats[0]) == sorted(stats[1])
    assert stats[0]["bucket_sizes"] == [2, 4] and stats[0]["batches"] >= 1

    def metrics(url):
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            lines = resp.read().decode().splitlines()
        return lines, {ln.rsplit(" ", 1)[0] for ln in lines if not ln.startswith("#")}

    (port_lines, port_names), (jax_lines, jax_names) = metrics(port_url), metrics(jax_url)
    assert port_names == jax_names
    assert [ln for ln in port_lines if ln.startswith("#")] == \
        [ln for ln in jax_lines if ln.startswith("#")]


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=body)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.load(resp)


def test_port_server_error_paths(both_servers):
    (port_url, _), _ = both_servers
    for body in (b"not-an-npz", _npz(tiles=np.zeros((1, 16, 16, 2)))):
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(port_url, "/predict", body)
        assert info.value.code == 400 and "error" in json.load(info.value)
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(port_url + "/nope", timeout=30)
    assert info.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as info:  # reload is off
        PortClient(port_url).reload("other.pth")
    assert info.value.code == 403
    host, port = port_url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", "banana")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read())["error"]
    finally:
        conn.close()
    assert PortClient(port_url).health()["status"] == "ok"


def test_port_server_reload_and_io_timeout():
    """/reload swaps the model (400 keeps the old one); a body that never
    arrives gets a 408 once ``io_timeout`` passes."""
    def model(value):
        return lambda batch: np.full((batch.shape[0],), value, np.float32)

    def reload_fn(path):
        if path != "b.pth":
            raise FileNotFoundError(path)
        return model(2.0), {"checkpoint": path}

    server = port_server.CrosstalkServer(model(1.0), batch_size=2, image_size=8,
                                         port=0, max_delay_ms=1.0, io_timeout=1.0,
                                         model_info={"checkpoint": "a.pth"},
                                         reload_fn=reload_fn)
    url = _start(server)
    try:
        client = PortClient(url)
        tiles = np.zeros((3,) + TILE, np.float32)
        np.testing.assert_array_equal(client.predict(tiles), [1.0] * 3)
        with pytest.raises(urllib.error.HTTPError) as info:
            client.reload("missing.pth")
        assert info.value.code == 400
        assert "still serving" in json.load(info.value)["error"]
        assert client.reload("b.pth")["status"] == "reloaded"
        np.testing.assert_array_equal(client.predict(tiles), [2.0] * 3)
        assert client.stats()["reloads"] == 1 and client.health()["checkpoint"] == "b.pth"

        host, port = server.address
        s = socket.create_connection((host, port), timeout=10)
        try:
            s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Length: 50\r\n\r\n")
            resp = b""
            while b"\r\n\r\n" not in resp:
                chunk = s.recv(4096)
                if not chunk:
                    break
                resp += chunk
        finally:
            s.close()
        assert b"408" in resp.split(b"\r\n", 1)[0], resp[:200]
        np.testing.assert_array_equal(client.predict(tiles), [2.0] * 3)
    finally:
        server.shutdown()


def test_port_server_shutdown_before_start_returns():
    server = port_server.CrosstalkServer(_mean_predict, batch_size=2, image_size=8, port=0)
    t = threading.Thread(target=server.shutdown, daemon=True)
    t.start()
    t.join(timeout=15)
    assert not t.is_alive()


# --- the serve CLI ---------------------------------------------------------

@pytest.mark.parametrize("flags,message", [
    (["--artifact", "m.ctkt"], "exactly one of"),
    (["--quantize", "int8"], "requires --calibration_mixed_dir"),
    (["--calibration_mixed_dir", "m"], "only apply with --quantize"),
    (["--calibration_source_dir", "s"], "only apply with --quantize"),
    (["--quantize", "int8", "--parity"], "mutually exclusive"),
    (["--quantize", "int8", "-o", "double"], "gated to the single-branch family"),
    (["--quantize", "int8", "--calibration_mixed_dir", "m", "--calibration_source_dir", "s",
      "--calibration_tiles", "0"], "--calibration_tiles must be positive"),
    (["--num_devices", "0"], "--num_devices 0 requested but only"),
    (["--port", "99999"], "--port must be in 0-65535"),
    (["--image_size", "0"], "--image_size must be positive"),
    (["--batch_buckets", "x,2"], "comma-separated integers"),
    (["--batch_size", "8", "--batch_buckets", "16"], "must be in 1..batch_size"),
])
def test_serve_cli_rejects_flags(flags, message, capsys):
    from crosstalk_tpu_torch.cli.serve import main

    assert main(["-p", "a.pth", "--device", "cpu", *flags]) == 1
    out = capsys.readouterr().out
    assert out.startswith("Error") and message in out


def test_serve_cli_checkpoint_errors(ckpts, tmp_path, capsys):
    from crosstalk_tpu_torch.cli.serve import main

    assert main(["--device", "cpu"]) == 1
    assert "exactly one of" in capsys.readouterr().out
    assert main(["-p", str(tmp_path / "nope.pth"), "--device", "cpu"]) == 1
    assert "Error loading model" in capsys.readouterr().out
    assert main(["-p", ckpts["single"], "--device", "cpu", "--image_size", "64"]) == 1
    assert "compatible tile sizes: 32-39px" in capsys.readouterr().out
    assert main(["-p", ckpts["single"], "--device", "cpu", "-o", "double"]) == 1
    assert "Error loading model" in capsys.readouterr().out


def test_serve_cli_without_device_raises_on_a_cudaless_host(ckpts, monkeypatch):
    from crosstalk_tpu_torch.cli.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-p", ckpts["single"], "--port", "0"])


def test_serve_cli_subprocess_serves_reloads_and_drains_on_sigterm(ckpts, tmp_path):
    """``--device cpu --port 0``: the JAX client gets the JAX predictor's
    alphas from it, /reload swaps checkpoints, and SIGTERM exits 0."""
    torch.manual_seed(5)
    other = burn_in_batch_stats(TorchSingle(initial_filters=8, num_blocks=3,
                                            image_size=PX), PX, steps=2, seed=1)
    ckpt2 = str(tmp_path / "other.pth")
    torch.save(other.state_dict(), ckpt2)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "crosstalk_tpu_torch.cli.serve", "-p", ckpts["single"],
         "--device", "cpu", "--port", "0", "--batch_size", "4", "--batch_buckets", "2",
         "--parity", "--transport_dtype", "float16", "--allow_reload"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=tmp_path, env=env,
    )
    try:
        url, seen = None, []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and url is None:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            seen.append(line)
            if line.startswith("Serving on "):
                url = line.split()[2]
        assert url, "never saw the 'Serving on' line:\n" + "".join(seen)

        client = JaxClient(url, timeout=60)
        health = client.health()
        assert health["path"] == "f32-parity" and health["transport_dtype"] == "float16"
        rng = np.random.default_rng(9)
        mixed, source = rng.random((5, PX, PX)), rng.random((5, PX, PX))
        raw = np.stack([mixed, source], -1)
        got = client.predict(mixed, source)
        _, jax_f16 = _predictors(ckpts["single"], "single", False, np.float16, 4)
        want = np.concatenate([jax_f16(to_f16_wire(raw[:4], (1, 2))),
                               jax_f16(to_f16_wire(np.concatenate(
                                   [raw[4:], np.zeros((3, PX, PX, 2))]), (1, 2)))[:1]])
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
        assert client.stats()["capacity_rows"] == 6  # a full 4 + the 2-bucket

        info = client.reload(ckpt2)
        assert info["status"] == "reloaded" and info["checkpoint"] == ckpt2
        assert not np.allclose(client.predict(mixed, source), got)

        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0, rest
        assert "Shutting down" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
