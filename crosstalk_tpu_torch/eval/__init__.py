"""Evaluation: the batched eval engine, the fast bf16 forward and the int8
serving tier (the JAX package's names)."""

from crosstalk_tpu_torch.eval.engine import evaluate, evaluate_and_save
from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8, make_int8_forward

__all__ = [
    "evaluate",
    "evaluate_and_save",
    "make_fast_forward",
    "calibrate_int8",
    "make_int8_forward",
]
