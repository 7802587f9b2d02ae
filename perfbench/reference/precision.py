"""The precision a reference computation runs at.

"exact" is what the configuration states: float32 with TF32 off for the
models and the decode, float64 for the CFP front-end. "control" is one step
below at every stage (TF32 for the models, float32 for the CFP, bfloat16 for
the observation model); it stands in for the program in the check that the
comparison can fail.
"""

from __future__ import annotations

import contextlib

import torch

EXACT = "exact"
CONTROL = "control"


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 off ("exact") or on ("control") for cuDNN convolutions and
    matrix products, restored on exit."""
    tf32 = precision == CONTROL
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
