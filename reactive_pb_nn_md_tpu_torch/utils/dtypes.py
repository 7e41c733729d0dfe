"""Precision policy: the deck's ``precision`` key picks the float dtype.

fp64 is native on the H100, so both keys run the same code on the card;
there is no process-wide policy, the dtype travels with the tensors.
"""

import torch

_DTYPES = {"fp64": torch.float64, "fp32": torch.float32,
           "mixed": torch.float32}


def float_dtype(precision: str) -> torch.dtype:
    try:
        return _DTYPES[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None
