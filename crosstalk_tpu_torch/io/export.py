"""The serving semantics, defined once, and the AOT serving artifact (port of
crosstalk_tpu/io/export.py).

``make_forward`` is per-tile min-max normalize, then the forward, then the
``(B,)`` alphas; the online predictor (serve/predictor.py), the predict CLI
and the export below build on it.

The artifact is the port's own: the JAX package's ``.ctkx`` holds StableHLO,
which torch cannot load. ``export_serving_model`` traces the serving
program once with ``torch.export`` (normalization included, a symbolic batch
dimension by default, one static batch when pinned) and ``load_exported``
runs it with torch alone, with no model code and no checkpoint at the
deployment site:

    python -m crosstalk_tpu_torch.tools.export_model -p model.pth --out m.ctkt
    fn, meta = load_exported("m.ctkt"); alphas = fn(tiles)

File format: the 8-byte magic, a u32 little-endian JSON length, the JSON
metadata, a u64 little-endian weights length, the weights (``torch.save`` of
the checkpoint's state_dict), then the program (``torch.export.save``). The
weights travel as an ARGUMENT of the program, as in the JAX format, so the
checkpoint's BN folds and the int8 tier's weight quantization run inside
it; the calibrated int8 activation clips are constants of the program. The
metadata records the image size, the batch (``"dynamic"`` or an int), the
tier (``path``: ``fast``, ``parity`` or ``int8``), the model, the device
type the program was traced for and the sha256 of both sections.

The fused input-block kernel is deliberately NOT in exported programs, as
the JAX export leaves its Pallas kernel out: the program must load with
torch alone, and a hand-built kernel is not part of torch. Block 0 runs on
the bf16 conv path of ``eval/fast_forward._conv_block_eval`` and the
metadata says so (``block0``).

Loading needs torch alone: this module imports nothing of the port at its
top, so ``read_exported`` and ``load_exported`` work when it is loaded by
file path in a process without the package.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

_MAGIC = b"CTKT0001"
BLOCK0_NOTE = ("bf16 conv path (the fused input-block kernel is left out of "
               "exported programs)")


def make_forward(
    model_cfg,
    state_dict,
    fast: bool = True,
    image_size: int = 256,
    device="cpu",
    use_kernel: bool = True,
    int8_scales: Optional[Dict[str, float]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """-> fn(raw (B, H, W, 2) float32 on ``device``) -> (B,) float32.

    ``fast`` runs the folded-BN bf16 forward (``eval/fast_forward.py``: the
    fused input-block kernel on block 0 when ``device`` is a card and
    ``use_kernel``); otherwise the ``nn.Module`` in the config's compute
    dtype, sized for ``image_size`` tiles. ``int8_scales`` (from
    ``eval.int8_forward.calibrate_int8``) selects the opt-in int8 tier
    instead of the bf16 one, OUTSIDE the 1e-4 parity budget. The weights are
    moved to ``device`` once, here. ``use_kernel=False`` is the export's.
    """
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc

    device = torch.device(device)
    if int8_scales is not None:
        if not fast:
            raise ValueError("int8_scales requires the fast serving path")
        from crosstalk_tpu_torch.eval.int8_forward import make_int8_forward

        forward = make_int8_forward(
            model_cfg, {k: v.to(device) for k, v in state_dict.items()},
            int8_scales, use_kernel=use_kernel)
    elif fast:
        from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward

        forward = make_fast_forward(
            model_cfg, {k: v.to(device) for k, v in state_dict.items()},
            use_kernel=use_kernel)
    else:
        from crosstalk_tpu_torch.eval.engine import model_forward
        from crosstalk_tpu_torch.models.registry import build_model

        model = build_model(model_cfg, image_size=image_size, device=device)
        model.load_state_dict(state_dict)
        forward = model_forward(model, model_cfg.compute_dtype)

    def serve(raw: torch.Tensor) -> torch.Tensor:
        return forward(normalize_batch_nhwc(raw))[:, 0].float()

    return serve


class _Program(torch.nn.Module):
    """forward(raw, weights) -> (B,) alphas: the serving function with the
    checkpoint's state_dict as an argument (what ``torch.export`` traces)."""

    def __init__(self, model_cfg, fast, image_size, device, int8_scales):
        super().__init__()
        self.cfg, self.fast, self.device = model_cfg, fast, device
        self.int8_scales = int8_scales
        if not fast:
            from crosstalk_tpu_torch.models.registry import build_model

            # storage-less: functional_call supplies every parameter and
            # buffer, so the program holds no second copy of the weights
            self._shell = [build_model(model_cfg, image_size=image_size, device="meta")]

    def forward(self, raw, weights):
        if self.fast:
            return make_forward(self.cfg, weights, device=self.device, use_kernel=False,
                                int8_scales=self.int8_scales)(raw)
        from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc

        x = normalize_batch_nhwc(raw).permute(0, 3, 1, 2)
        with torch.autocast(raw.device.type, dtype=torch.bfloat16,
                            enabled=self.cfg.compute_dtype == "bf16"):
            out = torch.func.functional_call(self._shell[0], weights, (x,))
        return out[:, 0].float()


def export_serving_model(
    state_dict,
    model_cfg,
    batch_size: Optional[int] = None,
    image_size: int = 256,
    fast: bool = True,
    device="cuda",
    int8_scales: Optional[Dict[str, float]] = None,
) -> Tuple[bytes, bytes]:
    """-> (program bytes, weights bytes), traced on ``device`` (``'cuda'``
    raises without a card; ``'cpu'`` exports for the CPU).

    ``batch_size=None`` (the default) exports a SYMBOLIC batch dimension:
    the artifact accepts any batch size; an int pins one static shape.
    ``int8_scales`` exports the opt-in int8 tier; its calibrated clips are
    constants of the program, so the deployment site needs no calibration
    data. The weights section holds the state_dict as float tensors, in
    the order the program takes them."""
    from crosstalk_tpu_torch.device import resolve_device

    if int8_scales is not None and not fast:
        raise ValueError("int8_scales requires the fast serving path")
    device = resolve_device(str(device))
    weights = {k: v.detach().to(device) for k, v in state_dict.items()}
    raw = torch.zeros((batch_size or 2, image_size, image_size, 2), device=device)
    dims = None if batch_size is not None else (
        {0: torch.export.Dim("batch", min=1, max=1 << 20)}, {k: None for k in weights})
    program = _Program(model_cfg, fast, image_size, device, int8_scales)
    with torch.no_grad():
        exported = torch.export.export(program, (raw, weights), dynamic_shapes=dims)
    exported.example_inputs = None  # else the weights would be saved twice
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    wbuf = io.BytesIO()
    torch.save({k: v.cpu() for k, v in weights.items()}, wbuf)
    return buf.getvalue(), wbuf.getvalue()


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def save_exported(path: str, program: bytes, weights: bytes, meta: Dict) -> None:
    """Write the artifact; ``meta`` gains the sections' sha256 digests."""
    payload = json.dumps({**meta, "sha256": {"program": _sha256(program),
                                             "weights": _sha256(weights)}}).encode()
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
        f.write(struct.pack("<Q", len(weights)))
        f.write(weights)
        f.write(program)
    os.replace(tmp, path)  # atomic: no truncated artifact at the final path


def read_exported(path: str) -> Tuple[bytes, bytes, Dict]:
    """-> (program bytes, weights bytes, metadata). Raises ValueError on a
    bad file: wrong magic, truncation, corrupt metadata or a section whose
    digest does not match."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a crosstalk torch export (magic {magic!r})")
        header = f.read(4)
        if len(header) < 4:
            raise ValueError(f"{path}: truncated export header")
        (n,) = struct.unpack("<I", header)
        payload = f.read(n)
        if len(payload) < n:
            raise ValueError(f"{path}: truncated export metadata")
        try:
            meta = json.loads(payload.decode())
            digests = meta["sha256"]
        except (UnicodeDecodeError, json.JSONDecodeError, KeyError, TypeError) as e:
            raise ValueError(f"{path}: corrupt export metadata: {e}")
        wheader = f.read(8)
        if len(wheader) < 8:
            raise ValueError(f"{path}: truncated weights header")
        (wn,) = struct.unpack("<Q", wheader)
        weights = f.read(wn)
        if len(weights) < wn:
            raise ValueError(f"{path}: truncated weights section")
        program = f.read()
    if not program:
        raise ValueError(f"{path}: export contains no program")
    for name, section in (("weights", weights), ("program", program)):
        if _sha256(section) != digests.get(name):
            raise ValueError(f"{path}: corrupt {name} section (sha256 mismatch)")
    return program, weights, meta


def load_exported(path: str, device: Optional[str] = None):
    """-> (fn(raw (B, H, W, 2) numpy or tensor) -> (B,) float32 numpy,
    metadata dict).

    Needs torch alone. The program runs on the device type it was traced
    for; ``device`` names it (default: the artifact's), and another type
    raises ValueError, as does a CUDA artifact on a host without a card: an
    artifact is never moved silently. The weights are placed once, here.
    ``fn.forward`` is the program on device tensors (raw -> (B,) tensor),
    for callers that keep the batch on the card."""
    program, weights, meta = read_exported(path)
    traced_for = meta.get("device")
    want = traced_for if device is None else str(device)
    if want != traced_for:
        raise ValueError(f"{path}: exported for device type {traced_for!r}, not "
                         f"{want!r}; export it again for {want!r}")
    if want == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"{path}: exported for 'cuda' and this host has no usable "
                         "CUDA card")
    try:
        state = torch.load(io.BytesIO(weights), map_location=want, weights_only=True)
    except Exception as e:  # the digest matched: a writer fault, reported as such
        raise ValueError(f"{path}: corrupt weights section: {type(e).__name__}: {e}")
    try:
        module = torch.export.load(io.BytesIO(program)).module()
    except Exception as e:
        raise ValueError(f"{path}: corrupt program section: {type(e).__name__}: {e}")

    @torch.inference_mode()
    def forward(raw: torch.Tensor) -> torch.Tensor:
        return module(raw, state)

    def fn(raw) -> np.ndarray:
        x = torch.as_tensor(np.asarray(raw, np.float32)).to(want)
        return forward(x).cpu().numpy()

    fn.forward = forward
    return fn, meta
