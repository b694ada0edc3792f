"""Kubernetes resource-quantity parsing.

Copy of ``tpu_scheduler/api/quantity.py`` (the port imports nothing of the
JAX package).  Quantities normalise eagerly to integers — cpu in
*millicores*, memory in *bytes* — so resources pack into integer tensors for
device evaluation.  Exact arithmetic is
done with ``fractions.Fraction`` so "0.1" cpu or "1.5Gi" memory never lose
precision before the final ceil.

Grammar (Kubernetes apimachinery `Quantity`):

    quantity     := <sign>? <digits> ('.' <digits>)? <suffix>?
    suffix       := binarySI | decimalSI | decimalExponent
    binarySI     := Ki | Mi | Gi | Ti | Pi | Ei
    decimalSI    := n | u | m | '' | k | M | G | T | P | E
    decimalExponent := ('e'|'E') <sign>? <digits>
"""

from __future__ import annotations

import math
import re
from fractions import Fraction
from functools import lru_cache

__all__ = [
    "QuantityError",
    "parse_quantity",
    "cpu_to_millis",
    "memory_to_bytes",
]


class QuantityError(ValueError):
    """Raised for an unparseable Kubernetes quantity string."""


_SUFFIX_MULTIPLIERS: dict[str, Fraction] = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
    "Ki": Fraction(2**10),
    "Mi": Fraction(2**20),
    "Gi": Fraction(2**30),
    "Ti": Fraction(2**40),
    "Pi": Fraction(2**50),
    "Ei": Fraction(2**60),
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)"
    r"(?P<digits>\d+(?:\.\d*)?|\.\d+)"
    r"(?:"
    r"(?P<suffix>[numkMGTPE]|Ki|Mi|Gi|Ti|Pi|Ei)"
    r"|(?:[eE](?P<exp>[+-]?\d+))"
    r")?$"
)


def parse_quantity(s: str | int | float) -> Fraction:
    """Parse a Kubernetes quantity into an exact Fraction of base units.

    Accepts ints/floats for convenience (synthetic workload generators).
    """
    if isinstance(s, int):
        return Fraction(s)
    if isinstance(s, float):
        return Fraction(str(s))
    if not isinstance(s, str):
        raise QuantityError(f"quantity must be str/int/float, got {type(s)!r}")
    m = _QUANTITY_RE.match(s.strip())
    if not m:
        raise QuantityError(f"invalid quantity: {s!r}")
    value = Fraction(m.group("digits"))
    if m.group("sign") == "-":
        value = -value
    suffix = m.group("suffix")
    exp = m.group("exp")
    if suffix is not None:
        value *= _SUFFIX_MULTIPLIERS[suffix]
    elif exp is not None:
        e = int(exp)
        value *= Fraction(10) ** e
    return value


@lru_cache(maxsize=65536)
def cpu_to_millis(s: str | int | float) -> int:
    """Parse a cpu quantity to integer millicores, rounding up.

    "500m" -> 500, "2" -> 2000, "0.5" -> 500, "1n" -> 1 (ceil).
    Kubernetes canonicalises fractional requests upward; matching that keeps
    fit-decisions conservative (never admit a pod the reference would reject).
    """
    return math.ceil(parse_quantity(s) * 1000)


@lru_cache(maxsize=65536)
def memory_to_bytes(s: str | int | float) -> int:
    """Parse a memory quantity to integer bytes, rounding up.

    "2Gi" -> 2147483648, "1G" -> 1000000000, "129e6" -> 129000000.
    """
    return math.ceil(parse_quantity(s))
