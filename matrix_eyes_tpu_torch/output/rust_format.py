"""Rust ``{}`` Display formatting of f64 values (the port's own copy of
``matrix_eyes_tpu/output/rust_format.py``).

The reference writes OBJ floats with Rust's Display (output.rs:577-598):
the shortest decimal string that round-trips, as Python's repr gives it,
but never in exponent notation and without a trailing ``.0`` (``1.0`` ->
``1``, ``1e-7`` -> ``0.0000001``). Both languages pick the same shortest
round-trip digits, so Python's repr rewritten positionally is Rust's output.
"""

from __future__ import annotations

import math


def format_f64(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    s = repr(float(v))
    if "e" in s or "E" in s:
        mant, exp = s.replace("E", "e").split("e")
        exp = int(exp)
        neg = mant.startswith("-")
        if neg:
            mant = mant[1:]
        ip, _, fp = mant.partition(".")
        digits = ip + fp
        point = len(ip) + exp
        if point <= 0:
            out = "0." + "0" * (-point) + digits
        elif point >= len(digits):
            out = digits + "0" * (point - len(digits))
        else:
            out = digits[:point] + "." + digits[point:]
        s = "-" + out if neg else out
    if s.endswith(".0"):
        s = s[:-2]
    return s
