"""Java-compatible float formatting.

The reference emits hit weights via Java's ``String.format("%f", w)`` (CALL
lines, ref KmerGutsJava.java:398-404) and ``%1.3f`` (debug HIT lines, ref
:473-474). Java's Formatter documents ROUND HALF UP on the exact binary value
of the double; C/Python printf rounds half to even. The two differ whenever
the exact binary expansion of the value terminates exactly halfway at the
requested precision (e.g. 0.0078125 at 6 digits), so we format through
``decimal`` with explicit HALF_UP to be bit-identical with the reference.
"""
from __future__ import annotations

import math
from decimal import Context, Decimal, ROUND_HALF_UP

# a float64's exact decimal expansion has up to ~767 significant digits;
# the default context (28) would raise InvalidOperation quantizing values
# beyond ~1e21
_CTX = Context(prec=800)


def jformat(value: float, precision: int = 6) -> str:
    """Format like Java ``String.format("%.<p>f", value)``.

    ``value`` may be a float32 weight promoted to double; callers must do the
    float32->float64 promotion exactly as Java does (it is exact).
    """
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "Infinity" if value > 0 else "-Infinity"
    quantum = Decimal(1).scaleb(-precision)
    d = Decimal(value).quantize(quantum, rounding=ROUND_HALF_UP, context=_CTX)
    # Decimal prints "-0.000000" for negative zero, same as Java.
    return f"{d:.{precision}f}"
