"""Time edited copies of K1's CUDA source on the card, to see what its time
is made of.

    python -m crosstalk_tpu_torch.tools.k1_variants [NAME=EDITS ...]

EDITS is a comma-separated list applied to ``csrc/input_block.cu``:
``kRows:8`` sets ``constexpr int kRows`` (any of the source's ``k*``
constants), and ``ablate:<name>`` removes one part of the work, making the
result wrong on purpose to show what that part costs:

  nostore   the output stores (kept behind a condition that never holds)
  nomma     the tensor-core products (a cheap stand-in keeps the data flow)
  noitems   the whole compute loop (leaves staging, barriers and launch)

With no arguments it runs the source as it is and each ablation. Every
variant is built with nvcc (``-Xptxas -v``: registers and spills) into the
kernel cache and timed with CUDA events at the main path's single-branch
shape (B=64, 256x256, C=2 -> 128), beside ``fill_`` of an output-sized bf16
tensor (what the card's writes alone take). Unablated variants are checked
against the plain version. Needs a CUDA card and nvcc; imports nothing of
the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import subprocess

import torch

_MMA16 = '''asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
_MMA8 = '''asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));'''
_STORE = "*reinterpret_cast<uint4*>(dst + 32 * r) ="
ABLATIONS = {
    "nostore": [(_STORE, "if (res[0] == 0x12345679u) " + _STORE)],
    "nomma": [
        (_MMA16, "d[0] += __uint_as_float(a[0] ^ b0); d[1] += __uint_as_float(a[1] ^ b1);"
                 " d[2] += __uint_as_float(a[2]); d[3] += __uint_as_float(a[3]);"),
        (_MMA8, "d[0] += __uint_as_float(a[0] ^ b0); d[2] += __uint_as_float(a[1]);"),
    ],
    "noitems": [("for (int q = warp / kSpans;", "for (int q = warp / kSpans + kGroups;")],
}
DEFAULT = ["source=", "nostore=ablate:nostore", "nomma=ablate:nomma",
           "nomma_nostore=ablate:nomma,ablate:nostore", "noitems=ablate:noitems"]


def edit_source(src: str, edits: str) -> str:
    for edit in filter(None, edits.split(",")):
        key, value = edit.split(":")
        if key == "ablate":
            for old, new in ABLATIONS[value]:
                if old not in src:
                    raise ValueError(f"ablation {value}: source text not found")
                src = src.replace(old, new)
        else:
            src, n = re.subn(rf"constexpr int {key} = [^;]+;",
                             f"constexpr int {key} = {value};", src)
            if n != 1:
                raise ValueError(f"no constant {key} in the source")
    return src


def build_variant(name: str, src: str) -> tuple:
    """-> (library path, ptxas line of the C=2 kernel)."""
    from crosstalk_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    at = next((i for i, line in enumerate(lines) if "ILi2E" in line), 0)
    picked = [next((line.split(":", 1)[-1].strip() for line in lines[at:]
                    if key in line), "") for key in ("spill", "Used")]
    return lib, " | ".join(picked)


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", default=DEFAULT, metavar="NAME=EDITS")
    args = parser.parse_args(argv)

    from crosstalk_tpu_torch.device import resolve_device, set_parity_numerics
    from crosstalk_tpu_torch.ops import _build
    from crosstalk_tpu_torch.ops.input_block import (
        fused_input_block_reference,
        pack_input_block,
    )

    resolve_device("cuda")
    set_parity_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}, torch {torch.__version__}", flush=True)

    source = (_build.CSRC / "input_block.cu").read_text()
    specs = dict(v.split("=", 1) for v in args.variants)
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        built = dict(zip(specs, pool.map(
            lambda kv: build_variant(kv[0], edit_source(source, kv[1])), specs.items())))

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, size, c, f = 64, 256, 2, 128
    x = torch.rand(b, size, size, c, device="cuda", generator=gen)
    kernel = torch.randn(3, 3, c, f, device="cuda", generator=gen) * 0.3
    scale = torch.randn(f, device="cuda", generator=gen) * 0.3 + 1.0
    scale[::5] = -scale[::5]
    bias = torch.randn(f, device="cuda", generator=gen) * 0.2
    packed = pack_input_block(kernel, scale, bias)
    want = fused_input_block_reference(x, kernel, scale, bias).float()
    out = torch.empty(b, size // 2, size // 2, f, dtype=torch.bfloat16, device="cuda")
    print(f"fill_ of the {out.numel() * 2} B output: {time_ms(lambda: out.fill_(1.0)):.4f} ms",
          flush=True)

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, ptxas) in built.items():
        fn = ctypes.CDLL(str(lib)).fused_input_block_launch
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ctypes.c_float, ptr]
        fn.restype = i32

        def launch():
            rc = fn(x.data_ptr(), packed.gemm.data_ptr(), packed.bias.data_ptr(),
                    out.data_ptr(), b, size, size, c, f, 0.01, stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

        out.zero_()
        launch()
        torch.cuda.synchronize()
        note = "ablated, result not checked"
        if "ablate:" not in specs[name]:
            diff = (out.float() - want).abs()
            big = want.abs() > 1e-3
            note = (f"max rel {(diff[big] / want.abs()[big]).max().item():.3e} "
                    f"where |y| > 1e-3")
        times = " / ".join(f"{time_ms(launch):.4f}" for _ in range(3))
        print(f"{name} [{specs[name] or 'as is'}]: {times} ms; {note}; {ptxas}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
