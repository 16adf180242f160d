"""What the kinds' readings (``kinds/<kind>.py``'s ``readings``, run by
``calibrate.py``) share. The control is the reference computed in float32
with TF32 products, put in the program's place; each kind plants its own
faults the same way."""
from __future__ import annotations


def control_mode(device):
    """The control's TF32 products: the card's own (cuBLAS with TF32 on),
    or on the CPU, which has none, operands rounded to TF32 to nearest."""
    return "cublas" if device.type == "cuda" else "rn"


def as_program(ref):
    """A reference's training steps in the form the program's check
    takes."""
    return {"losses": [ref["initial"],
                       sum(ref["losses"]) / len(ref["losses"])],
            "exp_avg": ref["exp_avg"], "step": ref["step"]}


def row(reading, gaps):
    """One reading's line: each number and where it was worst."""
    return {"reading": reading,
            **{k: float(v[0]) for k, v in gaps.items()},
            "where": {k: str(v[1]) for k, v in gaps.items()}}
