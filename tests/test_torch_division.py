"""The stencil kernels' reciprocal division (scale_letkf_torch/csrc/stencil.cuh
div_rcp) gives the correctly rounded quotient that IEEE division gives.

div_rcp(a, b, y) with y = 1/b rounded is Markstein's correction of a·y:
q = a·y, r = fma(−b, q, a), result fma(r, y, q) with the sign of q. The
kernels use it for the divisors that are the same at every point (the UD3
denominator 6, dx, dy, the level metric), so that a zero dividend does not
send CUDA's division down its slow path. This test runs the same sequence
in exact rational arithmetic, rounded to float32 at each step as the card
rounds, and holds it bit for bit to numpy's float32 division, for the
divisors of the shipped configurations and dividends from 2^-100 to 2^100
of both signs, and for ±0.
"""

from fractions import Fraction

import numpy as np
import pytest

F32 = np.float32


def _rn32(x: Fraction) -> F32:
    """x rounded to the nearest float32, ties to even (normal range)."""
    if x == 0:
        return F32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    m = x / Fraction(2) ** (e - 23)          # in [2^23, 2^24)
    n = m.numerator // m.denominator
    rem = m - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    return F32(sign * float(n * Fraction(2) ** (e - 23)))


def _fma32(a: F32, b: F32, c: F32) -> F32:
    return _rn32(Fraction(float(a)) * Fraction(float(b))
                 + Fraction(float(c)))


def div_rcp(a: F32, b: F32, y: F32) -> F32:
    q = F32(a * y)
    r = _fma32(-b, q, a)
    return np.copysign(_fma32(r, y, q), q)


def _dividends(rng, n):
    mant = rng.uniform(1.0, 2.0, n)
    exp = rng.integers(-100, 101, n)
    sign = rng.choice([-1.0, 1.0], n)
    a = (sign * np.ldexp(mant, exp)).astype(F32)
    # next to powers of two, and the zeros
    edges = np.asarray([1.0, 2.0 ** -100, 2.0 ** 100, 0.75, 1.5], F32)
    return np.concatenate([a, edges, np.nextafter(edges, F32(0)),
                           np.nextafter(edges, F32(4)), -edges,
                           np.asarray([0.0, -0.0], F32)])


# 18-km levels: 300 m × 1.04^k (the metric of gpu_check.metrics); the 1-km
# radar configuration's spacing is 1000 m
DIVISORS = {
    "ud3": [6.0],
    "horizontal": [18000.0, 1000.0, 500.0],
    "levels": [float(F32(300.0 * 1.04 ** k)) for k in range(0, 36, 5)]
              + [150.0, 612.5],
}


@pytest.mark.parametrize("family", sorted(DIVISORS))
def test_div_rcp_is_ieee_division(family):
    rng = np.random.default_rng(len(family))
    for b in DIVISORS[family]:
        b = F32(b)
        y = F32(1.0) / b
        for a in _dividends(rng, 300):
            got = div_rcp(a, b, y)
            want = a / b
            assert got.view(np.uint32) == want.view(np.uint32), (a, b, got,
                                                                want)
