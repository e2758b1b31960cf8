"""Java's ``String.format("%f", w)``: ROUND HALF UP on the exact binary
value of the double (KmerGutsJava.java:398-404), which Python's own ``%f``
(half to even) does not give."""
from __future__ import annotations

import math
from decimal import ROUND_HALF_UP, Context, Decimal

_CTX = Context(prec=800)


def jformat(value: float, precision: int = 6) -> str:
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "Infinity" if value > 0 else "-Infinity"
    d = Decimal(value).quantize(Decimal(1).scaleb(-precision),
                                rounding=ROUND_HALF_UP, context=_CTX)
    return f"{d:.{precision}f}"
