"""Doctor CLI (port of crosstalk_tpu/cli/doctor.py): verify an installation
or deployment of the PyTorch/CUDA port end to end, in one pass.

    python -m crosstalk_tpu_torch doctor                  # environment only
    python -m crosstalk_tpu_torch doctor -p model.pth     # + checkpoint load
    python -m crosstalk_tpu_torch doctor --url http://gpu-host:8000   # + server
    python -m crosstalk_tpu_torch doctor --device cpu     # a host without a card

Checks: the imports and versions (torch, CUDA, numpy, the port) and that
neither JAX nor the JAX package was imported; the CUDA card (a host without
one FAILS unless ``--device cpu`` is given: the port never falls back); the
kernel build cache (``ops/_build.BUILD_DIR`` writable, the fused input-block
kernel K1 built or loaded with nvcc); the native C++ TIFF decoder (built
with g++, a round trip on one written pair, and the pairs decoded natively
and in Python so far in this process); a TIFF write/read round trip; the
``--fast`` forward of a small model at ``--image_size`` on the device, K1
launched on the card, with its first-call time (build and first launch)
and second-call time; optionally a ``.pth`` load (structure-derived size
detection) and a serving-endpoint probe. Exit code 0 = deployable; 1 = at
least one FAIL.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

# the JAX package is `crosstalk_tpu` followed by a dot or the end of the name
_FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|crosstalk_tpu)(\.|$)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Check this machine's crosstalk_tpu_torch deployment health."
    )
    parser.add_argument("-p", "--model_path", type=str, default=None,
                        help="Optionally verify a .pth checkpoint loads")
    parser.add_argument("--url", type=str, default=None,
                        help="Optionally probe a running serving endpoint")
    parser.add_argument("--image_size", type=int, default=64,
                        help="Tile size for the forward smoke test "
                             "(small by default so the check is quick)")
    parser.add_argument("--timeout", type=float, default=10.0,
                        help="Server-probe timeout, seconds")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Check the CUDA card (default) or, explicitly, "
                             "a CPU-only deployment")
    return parser


class _Report:
    def __init__(self):
        self.failures = 0

    def ok(self, name: str, detail: str = "") -> None:
        print(f"  ok    {name}" + (f" — {detail}" if detail else ""))

    def warn(self, name: str, detail: str) -> None:
        print(f"  warn  {name} — {detail}")

    def fail(self, name: str, detail: str) -> None:
        self.failures += 1
        print(f"  FAIL  {name} — {detail}")


def _check_imports(rep: _Report) -> bool:
    try:
        import numpy
        import torch

        import crosstalk_tpu_torch
    except Exception as e:
        rep.fail("imports", f"{type(e).__name__}: {e}")
        return False
    rep.ok("imports", f"crosstalk_tpu_torch {crosstalk_tpu_torch.__version__}, "
                      f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
                      f"numpy {numpy.__version__}")
    bad = sorted(m for m in sys.modules if _FORBIDDEN.match(m))
    if bad:
        rep.fail("no JAX", f"imported in this process: {', '.join(bad[:5])}")
    else:
        rep.ok("no JAX", "neither jax nor crosstalk_tpu is imported")
    return True


def _check_devices(rep: _Report, device_name: str):
    """-> the torch.device to check on, or None."""
    import torch

    if device_name == "cpu":
        rep.ok("devices", "cpu (explicit --device cpu); the CUDA kernel is not "
                          "built and its plain version runs")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        rep.fail("devices", "CUDA is not available on this host; pass "
                            "--device cpu to check a CPU-only deployment")
        return None
    n = torch.cuda.device_count()
    names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
    rep.ok("devices", f"{n}x {'/'.join(names)} (CUDA {torch.version.cuda})")
    return torch.device("cuda")


def _check_kernel_cache(rep: _Report, device) -> None:
    import os
    import tempfile

    from crosstalk_tpu_torch.ops import _build

    try:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=_build.BUILD_DIR):
            pass
    except OSError as e:
        rep.fail("kernel build cache", f"{_build.BUILD_DIR} not writable "
                                       f"({type(e).__name__}: {e})")
        return
    if device.type != "cuda":
        rep.ok("kernel build cache", f"{_build.BUILD_DIR} writable "
                                     "(K1 is not built for --device cpu)")
        return
    try:
        t0 = time.perf_counter()
        path = _build.build("input_block")
        _build.load("input_block")
        rep.ok("kernel build cache", f"K1 {os.path.basename(path)} built or loaded in "
                                     f"{time.perf_counter() - t0:.2f}s under "
                                     f"{_build.BUILD_DIR}")
    except Exception as e:
        rep.fail("kernel build cache", f"K1 did not build or load "
                                       f"({type(e).__name__}: {e})")


def _check_decoder(rep: _Report) -> None:
    import os
    import tempfile

    import numpy as np

    from crosstalk_tpu_torch.data import native_loader
    from crosstalk_tpu_torch.data.pipeline import load_tiles
    from crosstalk_tpu_torch.data.tiff import read_tile, write_tile

    status = native_loader.build_status()
    if status["error"] is not None:
        rep.fail("native TIFF decoder", f"not built ({status['error']}); "
                 "every decode would run in the Python decoder")
        return
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.default_rng(0)
            paths = [os.path.join(tmp, f"{c}.tif") for c in ("mixed", "source")]
            for p in paths:
                write_tile(p, rng.random((16, 16)))
            out = np.empty((1, 16, 16, 2), np.float32)
            decoded = native_loader.load_pairs_native(paths[:1], paths[1:], out, threads=2)
            want = np.stack([read_tile(p) for p in paths], axis=-1)
        if decoded and np.array_equal(out[0], want):
            counts = load_tiles.decoded
            rep.ok("native TIFF decoder",
                   f"C++ thread-pool decoder {'built' if status['built'] else 'loaded'} "
                   f"in {status['seconds']:.2f}s, "
                   f"pair round trip bit-exact; pairs decoded in this process: "
                   f"native {counts['native']}, Python {counts['python']}")
        else:
            rep.fail("native TIFF decoder", "the pair round trip did not match "
                                            "the Python decoder")
    except Exception as e:
        rep.fail("native TIFF decoder", f"{type(e).__name__}: {e}")


def _check_tiff_roundtrip(rep: _Report) -> None:
    import os
    import tempfile

    import numpy as np

    from crosstalk_tpu_torch.data.tiff import read_tile, write_tile

    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "probe.tif")
            tile = np.random.default_rng(0).random((16, 16)).astype(np.float32)
            write_tile(path, tile)
            back = read_tile(path)
        if np.array_equal(np.asarray(back, np.float32), tile):
            rep.ok("TIFF round-trip", "write_tile/read_tile bit-exact")
        else:
            rep.fail("TIFF round-trip", "values changed across write/read")
    except Exception as e:
        rep.fail("TIFF round-trip", f"{type(e).__name__}: {e}")


def _check_forward(rep: _Report, image_size: int, device) -> None:
    import torch

    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.ops.input_block import fused_input_block

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    try:
        cfg = ModelConfig(variant="single", initial_filters=8, num_conv_blocks=3)
        model = init_model(build_model(cfg, image_size=image_size),
                           torch.Generator().manual_seed(0))
        launches = fused_input_block.launches
        forward = make_fast_forward(cfg, {k: v.to(device)
                                          for k, v in model.state_dict().items()})
        x = torch.zeros((2, image_size, image_size, 2), device=device)
        times = []
        with torch.inference_mode():
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                out = forward(x)
                sync()
                times.append(time.perf_counter() - t0)
        if tuple(out.shape) != (2, 1) or not bool(torch.isfinite(out).all()):
            rep.fail("--fast forward", f"output {tuple(out.shape)} not finite (2, 1)")
            return
        k1 = fused_input_block.launches - launches
        if device.type == "cuda" and k1 != 2:
            rep.fail("--fast forward", f"K1 launched {k1} times in 2 calls")
            return
        where = (f"K1 launched {k1}x on the card" if device.type == "cuda"
                 else "block 0 in K1's plain version on the CPU")
        rep.ok("--fast forward", f"{image_size}px on {device.type}, {where}; first "
                                 f"call {times[0]:.2f}s (with the device's warmup), "
                                 f"second {times[1] * 1e3:.1f}ms")
    except Exception as e:
        rep.fail("--fast forward", f"{type(e).__name__}: {e}")


def _check_checkpoint(rep: _Report, path: str) -> None:
    from crosstalk_tpu_torch.io.torch_convert import (
        infer_image_size,
        infer_model_size,
        load_pth,
    )

    try:
        sd = load_pth(path)
    except (FileNotFoundError, ValueError) as e:
        rep.fail("checkpoint", f"{type(e).__name__}: {e}")
        return
    for variant in ("single", "double"):
        try:
            size = infer_model_size(sd, variant)
            px = infer_image_size(sd, variant)
        except (KeyError, ValueError):
            continue  # try the other variant
        detail = ", ".join(f"{k}={v}" for k, v in size.items())
        rep.ok("checkpoint", f"{path}: {variant}, {detail}, native {px}px")
        return
    rep.fail("checkpoint", f"{path} matches neither model family's schema")


def _check_server(rep: _Report, url: str, timeout: float) -> None:
    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    try:
        client = CrosstalkClient(url, timeout=timeout)
        health = client.health()
        stats = client.stats()
        rep.ok("serving endpoint",
               f"{url}: {health.get('model', '?')} model, "
               f"batch {stats.get('batch_size', '?')}, "
               f"{stats.get('requests', 0)} requests served")
    except Exception as e:
        rep.fail("serving endpoint", f"{url} not healthy "
                                     f"({type(e).__name__}: {e})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.image_size < 8 or args.image_size % 2:
        print(f"Error: --image_size must be even and >= 8, got {args.image_size}")
        return 1

    print("crosstalk_tpu_torch doctor")
    rep = _Report()
    if not _check_imports(rep):
        print("\n1 check failed — environment is not usable.")
        return 1
    device = _check_devices(rep, args.device)
    if device is not None:
        _check_kernel_cache(rep, device)
    _check_decoder(rep)
    _check_tiff_roundtrip(rep)
    if device is not None:
        _check_forward(rep, args.image_size, device)
    if args.model_path is not None:
        _check_checkpoint(rep, args.model_path)
    if args.url is not None:
        _check_server(rep, args.url, args.timeout)

    if rep.failures:
        print(f"\n{rep.failures} check(s) FAILED — see above.")
        return 1
    print("\nAll checks passed — this machine can run crosstalk_tpu_torch.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
