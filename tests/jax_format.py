"""The JAX package's checkpoint format written without JAX, flax or msgpack.

``write_jax_checkpoint(path, jax_train_state(sd, exp_avg, exp_avg_sq,
step), meta)`` writes the file the JAX package's ``save_checkpoint``
writes for a single-branch model's train state: so a run dir "trained by
the JAX package" can be made where JAX is not installed (the card's
host). ``tests/test_torch_port_jax_resume.py`` holds these bytes equal to
JAX's own; ``tests/test_torch_port_cuda_cli.py`` resumes such a run dir on
the card. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
import struct

import numpy as np

JAX_MAGIC = b"CTPUCKPT1\n"     # crosstalk_tpu/io/checkpoint.py's header magic


def _mp_head(n: int, fix: int, fix_max: int, c8, c16: int, c32: int) -> bytes:
    """msgpack's length prefix: the fix form, else 8, 16 or 32 bits."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    if c8 is not None and n < 1 << 8:
        return bytes([c8, n])
    if n < 1 << 16:
        return bytes([c16]) + struct.pack(">H", n)
    return bytes([c32]) + struct.pack(">I", n)


def _mp_uint(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                           (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} does not fit msgpack's uint64")


def _mp_str(text: str) -> bytes:
    raw = text.encode("utf-8")
    return _mp_head(len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB) + raw


def _mp_ndarray(arr: np.ndarray) -> bytes:
    """flax's ext 1: a packed (shape, dtype name, C-order bytes)."""
    data = arr.tobytes("C")
    payload = (bytes([0x93]) + _mp_head(arr.ndim, 0x90, 15, None, 0xDC, 0xDD)
               + b"".join(_mp_uint(d) for d in arr.shape) + _mp_str(arr.dtype.name)
               + _mp_head(len(data), None, 0, 0xC4, 0xC5, 0xC6) + data)
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixext[n]]) if n in fixext
            else _mp_head(n, None, 0, 0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", 1) + payload


def flax_msgpack_bytes(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a tree
    of str-keyed dicts (in their insertion order) and numpy arrays under 1
    GiB each (flax chunks bigger ones): what the JAX package's
    ``save_checkpoint`` writes for a train state."""
    if isinstance(tree, dict):
        return (_mp_head(len(tree), 0x80, 15, None, 0xDE, 0xDF)
                + b"".join(_mp_str(k) + flax_msgpack_bytes(v) for k, v in tree.items()))
    if isinstance(tree, np.ndarray):
        if tree.nbytes > 1 << 30:
            raise ValueError("flax chunks arrays above 1 GiB; not written here")
        return _mp_ndarray(tree)
    raise TypeError(f"not a train-state leaf: {type(tree).__name__}")


def write_jax_checkpoint(path: str, tree: dict, meta: dict) -> bytes:
    """A checkpoint file as the JAX package's ``save_checkpoint`` writes it:
    magic, ``<Q`` meta length, meta JSON with the state's sha256, state.
    -> the file's bytes."""
    data = flax_msgpack_bytes(tree)
    meta_bytes = json.dumps({**meta, "state_sha256": hashlib.sha256(data).hexdigest()}
                            ).encode("utf-8")
    blob = JAX_MAGIC + struct.pack("<Q", len(meta_bytes)) + meta_bytes + data
    with open(path, "wb") as f:
        f.write(blob)
    return blob


def _sorted_tree(tree):
    """A nested dict with its keys sorted at every level, as jax.tree
    rebuilds the dicts of a jitted train state."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def jax_single_params(named: dict) -> dict:
    """Single-branch torch parameters (reference key schema) -> the flax
    ``params`` tree: HWIO conv kernels, (in, out) dense kernels, the first
    dense kernel's rows in the (H, W, C) flatten order."""
    def a(name):
        return np.ascontiguousarray(named[name].detach().cpu().numpy())

    tree, k = {}, 0
    while f"conv_layers.{4 * k}.weight" in named:
        conv, bn = f"conv_layers.{4 * k}", f"conv_layers.{4 * k + 1}"
        tree[f"ConvBlock_{k}"] = {
            "Conv_0": {"kernel": np.ascontiguousarray(a(f"{conv}.weight").transpose(2, 3, 1, 0)),
                       "bias": a(f"{conv}.bias")},
            "BatchNorm_0": {"scale": a(f"{bn}.weight"), "bias": a(f"{bn}.bias")},
        }
        channels = named[f"{conv}.weight"].shape[0]
        k += 1
    w1 = a("fc_layers.1.weight")
    out, flat = w1.shape
    side = int(math.isqrt(flat // channels))
    dense0 = w1.reshape(out, channels, side, side).transpose(2, 3, 1, 0).reshape(flat, out)
    for i, (lin, bn, kernel) in enumerate(((1, 2, dense0), (5, 6, a("fc_layers.5.weight").T))):
        tree[f"DenseBNBlock_{i}"] = {
            "Dense_0": {"kernel": np.ascontiguousarray(kernel), "bias": a(f"fc_layers.{lin}.bias")},
            "BatchNorm_0": {"scale": a(f"fc_layers.{bn}.weight"), "bias": a(f"fc_layers.{bn}.bias")},
        }
    tree["Dense_0"] = {"kernel": np.ascontiguousarray(a("fc_layers.9.weight").T),
                       "bias": a("fc_layers.9.bias")}
    return _sorted_tree(tree)


def jax_single_stats(sd: dict) -> dict:
    """The single-branch model's BN running statistics -> flax ``batch_stats``."""
    prefixes = {}
    k = 0
    while f"conv_layers.{4 * k}.weight" in sd:
        prefixes[f"ConvBlock_{k}"] = f"conv_layers.{4 * k + 1}"
        k += 1
    prefixes.update({"DenseBNBlock_0": "fc_layers.2", "DenseBNBlock_1": "fc_layers.6"})
    return _sorted_tree({
        block: {"BatchNorm_0": {"mean": sd[f"{p}.running_mean"].cpu().numpy(),
                                "var": sd[f"{p}.running_var"].cpu().numpy()}}
        for block, p in prefixes.items()})


def jax_train_state(sd: dict, exp_avg: dict, exp_avg_sq: dict, step: int) -> dict:
    """The state dict of the JAX package's ``TrainState`` (its field order,
    jitted dicts sorted) for a single-branch model, its Adam moments and
    its step count (optax's ``count`` equals the step)."""
    params = {k: v for k, v in sd.items() if not k.split(".")[-1].startswith(
        ("running_", "num_batches"))}
    return {
        "params": jax_single_params(params),
        "batch_stats": jax_single_stats(sd),
        "opt_state": {"0": {}, "1": {"count": np.asarray(step, np.int32),
                                     "mu": jax_single_params(exp_avg),
                                     "nu": jax_single_params(exp_avg_sq)}},
        "step": np.asarray(step, np.int32),
    }
