"""Tracing and debug switches (port of crosstalk_tpu/utils/profiling.py).

  * :func:`maybe_trace` records a ``torch.profiler`` trace (host and, on a
    card, CUDA activity) of a code region behind a flag, written as a
    Chrome trace JSON (view it in Perfetto or chrome://tracing);
  * :func:`enable_debug_checks` is the counterpart of the JAX package's
    ``jax_debug_nans`` / ``jax_debug_infs``: autograd's anomaly mode (a
    backward that makes a NaN raises and names the forward op) and a
    forward hook on every module that raises on the first non-finite
    output. Paths that run no ``nn.Module`` (the folded ``--fast`` forward,
    the eval metrics) call :func:`check_finite` on their results.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

_debug_checks = False


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """Record a profiler trace of the enclosed region when a dir is given:
    ``<trace_dir>/trace_<pid>.json`` (one file per process, so every rank
    of a multi-process run writes its own)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))
    print(f"Profiler trace written to {trace_dir}")


def _finite_hook(module, inputs, output) -> None:
    # every module of the two regressors returns one tensor
    if isinstance(output, torch.Tensor) and output.is_floating_point() and not bool(
            torch.isfinite(output).all()):
        raise FloatingPointError(
            f"non-finite value in the output of {module._get_name()} (--debug_nans)")


def enable_debug_checks() -> None:
    """Fail fast on NaN/Inf: anomaly mode for every backward, and a check
    of every module's forward output (each one syncs with the device)."""
    global _debug_checks
    if _debug_checks:
        return
    _debug_checks = True
    torch.autograd.set_detect_anomaly(True)
    torch.nn.modules.module.register_module_forward_hook(_finite_hook)


def check_finite(what: str, tensors) -> None:
    """Under ``enable_debug_checks``: raise FloatingPointError when any of
    ``tensors`` (a tensor or a dict of them) holds a NaN or an Inf."""
    if not _debug_checks:
        return
    items = tensors.items() if isinstance(tensors, dict) else [(what, tensors)]
    for name, t in items:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite value in {what}: {name} (--debug_nans)")
