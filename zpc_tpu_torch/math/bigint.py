"""Batched fixed-width exact integers and their fractions (counterpart of
``zpc_tpu/math/bigint.py``).

``BigInt`` is sign-magnitude: ``sign`` in {-1, 0, 1} and ``L`` little-endian
limbs of 12 bits (radix 4096) in int32 lanes, so every partial sum of the
schoolbook product stays below 2^31 for L <= 32.  ``L`` is the width of the
``mag`` tensor, 16 (192 bits) by default: exact for any product of two
int64 values.  ``RationalW`` is a fraction of two BigInts, normalised on
request by a fixed-trip binary gcd.  The limbs are the JAX package's, so
results equal its limb for limb; ``to_pyints``, ``to_fractions`` and
building from Python ints are host code.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["BigInt", "bigint", "bigint_gcd", "RationalW", "rational_w",
           "LIMB_BITS"]

LIMB_BITS = 12
_RADIX = 1 << LIMB_BITS
_MASK = _RADIX - 1
DEFAULT_LIMBS = 16  # 192 bits


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32, exactly, for int32 e in [-126, 127] (built from its
    bits: no exp2 rounding)."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _ldexp(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """x * 2^e for e in [-252, 254], in two exact power-of-two steps."""
    e1 = torch.div(e, 2, rounding_mode="floor")
    return x * _pow2(e1) * _pow2(e - e1)


@dataclasses.dataclass(frozen=True)
class BigInt:
    """Sign-magnitude batched integer: ``sign`` int32 ``[...]`` in
    {-1, 0, 1}, ``mag`` int32 ``[..., L]`` limbs in [0, 4096)."""

    sign: torch.Tensor
    mag: torch.Tensor

    @property
    def limbs(self) -> int:
        return self.mag.shape[-1]

    def _canon_sign(self) -> "BigInt":
        return BigInt(torch.where((self.mag != 0).any(-1), self.sign, 0),
                      self.mag)

    def __neg__(self) -> "BigInt":
        return BigInt(-self.sign, self.mag)

    def __add__(self, o: "BigInt") -> "BigInt":
        ge = _mag_ge(self.mag, o.mag)
        same = self.sign == o.sign
        # same sign: add magnitudes; else subtract the smaller
        big = torch.where(ge[..., None], self.mag, o.mag)
        small = torch.where(ge[..., None], o.mag, self.mag)
        mag = torch.where(same[..., None], _mag_add(self.mag, o.mag),
                          _mag_sub(big, small))
        sgn = torch.where(same | ge, self.sign, o.sign)
        return BigInt(sgn, mag)._canon_sign()

    def __sub__(self, o: "BigInt") -> "BigInt":
        return self + (-o)

    def __mul__(self, o: "BigInt") -> "BigInt":
        return BigInt(self.sign * o.sign,
                      _mag_mul(self.mag, o.mag))._canon_sign()

    def compare(self, o: "BigInt") -> torch.Tensor:
        """sign(self - o) as int32, exactly."""
        mc = _mag_cmp(self.mag, o.mag)
        s, t = self.sign, o.sign
        return torch.where(s != t, torch.sign(s - t),
                           torch.where(s >= 0, mc, -mc)).to(torch.int32)

    def is_zero(self) -> torch.Tensor:
        return self.sign == 0

    def shift_right1(self) -> "BigInt":
        """Halve the magnitude (floor)."""
        m = self.mag
        lo = torch.cat([m[..., 1:] & 1, torch.zeros_like(m[..., :1])], -1)
        return BigInt(self.sign,
                      (m >> 1) | (lo << (LIMB_BITS - 1)))._canon_sign()

    def shift_left1(self) -> "BigInt":
        m = self.mag
        hi = torch.cat([torch.zeros_like(m[..., :1]),
                        m[..., :-1] >> (LIMB_BITS - 1)], -1)
        return BigInt(self.sign, ((m << 1) & _MASK) | hi)

    def is_even(self) -> torch.Tensor:
        return (self.mag[..., 0] & 1) == 0

    def to_float_scaled(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(mantissa, exponent)`` with value = mantissa * 2^exponent: the
        limbs are summed relative to the top nonzero one, so magnitudes past
        float32's range stay finite here.  Limbs more than 126 bits below
        the top one are dropped (they are below float32's precision)."""
        k = torch.arange(self.limbs, dtype=torch.int32,
                         device=self.mag.device)
        top = torch.where(self.mag > 0, k, 0).amax(-1)
        shift = (k - top[..., None]) * LIMB_BITS
        scale = torch.where((shift <= 0) & (shift >= -126),
                            _pow2(shift.clamp(-126, 0)), 0.0)
        mant = (self.mag.to(torch.float32) * scale).sum(-1)
        return mant * self.sign.to(torch.float32), top * LIMB_BITS

    def to_float(self) -> torch.Tensor:
        """Approximate float32 value (exact where it fits a float32
        mantissa; inf past float32's range)."""
        mant, exp = self.to_float_scaled()
        return _ldexp(mant, exp)

    def to_pyints(self):
        """Host: exact Python ints (flattened)."""
        sign = self.sign.detach().cpu().reshape(-1).tolist()
        mag = self.mag.detach().cpu().reshape(-1, self.limbs).tolist()
        out = []
        for s, row in zip(sign, mag):
            v = 0
            for limb in reversed(row):
                v = (v << LIMB_BITS) + limb
            out.append(s * v)
        return out


# -- magnitude kernels (loops over the static limb count) ---------------

def _mag_add(a, b):
    """a + b, truncated to L limbs (widths are chosen so that nothing is
    lost)."""
    digs = []
    carry = torch.zeros_like(a[..., 0])
    for k in range(a.shape[-1]):
        t = a[..., k] + b[..., k] + carry
        digs.append(t & _MASK)
        carry = t >> LIMB_BITS
    return torch.stack(digs, -1)


def _mag_sub(a, b):
    """a - b for a >= b (otherwise it wraps)."""
    digs = []
    borrow = torch.zeros_like(a[..., 0])
    for k in range(a.shape[-1]):
        t = a[..., k] - b[..., k] - borrow
        borrow = (t < 0).to(t.dtype)
        digs.append(t + borrow * _RADIX)
    return torch.stack(digs, -1)


def _mag_cmp(a, b):
    """-1/0/+1 from the most significant differing limb."""
    res = torch.zeros_like(a[..., 0])
    for k in range(a.shape[-1] - 1, -1, -1):
        res = torch.where(res == 0, torch.sign(a[..., k] - b[..., k]), res)
    return res


def _mag_ge(a, b):
    return _mag_cmp(a, b) >= 0


def _mag_mul(a, b):
    """Schoolbook product truncated to L limbs: each column sum is at most
    L (2^12 - 1)^2 + carry < 2^31 for L <= 32."""
    L = a.shape[-1]
    cols = [torch.zeros_like(a[..., 0]) for _ in range(L)]
    for i in range(L):
        for j in range(L - i):
            cols[i + j] = cols[i + j] + a[..., i] * b[..., j]
    digs = []
    carry = torch.zeros_like(a[..., 0])
    for k in range(L):
        t = cols[k] + carry
        digs.append(t & _MASK)
        carry = t >> LIMB_BITS
    return torch.stack(digs, -1)


def bigint(x, limbs: int = DEFAULT_LIMBS, device=None) -> BigInt:
    """From a host list of Python ints (on ``device``, default the card),
    or from an int32/int64 tensor on its own device."""
    if isinstance(x, (list, tuple)):
        sign = np.sign(np.asarray(x, dtype=object)).astype(np.int32) \
            if x else np.zeros(0, np.int32)
        mags = np.zeros((len(x), limbs), np.int32)
        for r, v in enumerate(x):
            v = abs(int(v))
            for k in range(limbs):
                mags[r, k] = v & _MASK
                v >>= LIMB_BITS
            if v:
                raise OverflowError("value does not fit limb width")
        if device is None:
            from ..core.executor import cuda_device
            device = cuda_device()
        return BigInt(torch.from_numpy(sign).to(device),
                      torch.from_numpy(mags).to(device))
    v = x.abs()
    digs = []
    for _ in range(limbs):
        digs.append((v & _MASK).to(torch.int32))
        v = v >> LIMB_BITS
    return BigInt(torch.sign(x).to(torch.int32), torch.stack(digs, -1))


def _bsel(cond, a: BigInt, b: BigInt) -> BigInt:
    return BigInt(torch.where(cond, a.sign, b.sign),
                  torch.where(cond[..., None], a.mag, b.mag))


def _one_like(b: BigInt) -> BigInt:
    mag = torch.zeros_like(b.mag)
    mag[..., 0] = 1
    return BigInt(torch.ones_like(b.sign), mag)


def bigint_gcd(a: BigInt, b: BigInt, bits: int | None = None) -> BigInt:
    """Binary gcd of the magnitudes (shift and subtract only) in ``bits``
    trips, by default twice the width: enough for any pair.  gcd(0, 0) is
    1."""
    L = a.limbs
    bits = bits if bits is not None else 2 * L * LIMB_BITS
    one = torch.ones_like(a.sign)
    u = BigInt(torch.where(a.is_zero(), 0, one), a.mag)
    v = BigInt(torch.where(b.is_zero(), 0, one), b.mag)
    shift = torch.zeros_like(a.sign)
    for _ in range(bits):
        # frozen once either side is zero: the survivor is the gcd
        live = ~u.is_zero() & ~v.is_zero()
        ue = u.is_even() & live
        ve = v.is_even() & live
        shift = shift + (ue & ve).to(torch.int32)
        u = _bsel(ue, u.shift_right1(), u)
        v = _bsel(ve, v.shift_right1(), v)
        # both odd: subtract the smaller from the larger
        odd = ~u.is_even() & ~v.is_even() & ~u.is_zero() & ~v.is_zero()
        ge = _mag_ge(u.mag, v.mag)
        du = BigInt(u.sign, _mag_sub(u.mag, v.mag))._canon_sign()
        dv = BigInt(v.sign, _mag_sub(v.mag, u.mag))._canon_sign()
        u = _bsel(odd & ge, du, u)
        v = _bsel(odd & ~ge, dv, v)
    g = _bsel(u.is_zero(), v, u)
    for _ in range(L * LIMB_BITS):
        g = _bsel(shift > 0, g.shift_left1(), g)
        shift = torch.clamp(shift - 1, min=0)
    return _bsel(g.is_zero(), _one_like(g), BigInt(g.sign.abs(), g.mag))


@dataclasses.dataclass(frozen=True)
class RationalW:
    """Exact fraction of BigInts, ``den > 0`` by construction."""

    num: BigInt
    den: BigInt

    def __add__(self, o: "RationalW") -> "RationalW":
        return RationalW(self.num * o.den + o.num * self.den,
                         self.den * o.den)

    def __sub__(self, o: "RationalW") -> "RationalW":
        return RationalW(self.num * o.den - o.num * self.den,
                         self.den * o.den)

    def __mul__(self, o: "RationalW") -> "RationalW":
        return RationalW(self.num * o.num, self.den * o.den)

    def __truediv__(self, o: "RationalW") -> "RationalW":
        num = self.num * o.den
        den = self.den * o.num
        flip = den.sign < 0
        return RationalW(BigInt(torch.where(flip, -num.sign, num.sign),
                                num.mag), BigInt(den.sign.abs(), den.mag))

    def __neg__(self) -> "RationalW":
        return RationalW(-self.num, self.den)

    def sign(self) -> torch.Tensor:
        return self.num.sign

    def compare(self, o: "RationalW") -> torch.Tensor:
        """Exact sign(self - o)."""
        return (self.num * o.den).compare(o.num * self.den)

    def to_float(self) -> torch.Tensor:
        """num / den from the mantissas and exponents, so pairs past
        float32's range still give their ratio."""
        mn, en = self.num.to_float_scaled()
        md, ed = self.den.to_float_scaled()
        return _ldexp(mn / md, en - ed)

    def normalized(self) -> "RationalW":
        g = bigint_gcd(self.num, self.den)
        return RationalW(_bigint_div_exact(self.num, g),
                         _bigint_div_exact(self.den, g))

    def to_fractions(self):
        from fractions import Fraction
        return [Fraction(n, d) for n, d in zip(self.num.to_pyints(),
                                               self.den.to_pyints())]


def _bigint_div_exact(a: BigInt, d: BigInt) -> BigInt:
    """a / d where d divides a: restoring long division over every bit."""
    L = a.limbs
    rem = BigInt(torch.zeros_like(a.sign), torch.zeros_like(a.mag))
    quo = BigInt(torch.zeros_like(a.sign), torch.zeros_like(a.mag))
    dmag = d.mag
    for i in range(L * LIMB_BITS):
        k = L * LIMB_BITS - 1 - i
        topbit = (a.mag[..., k // LIMB_BITS] >> (k % LIMB_BITS)) & 1
        rem = rem.shift_left1()
        rmag = rem.mag.clone()
        rmag[..., 0] += topbit
        rem = BigInt(torch.maximum(rem.sign, topbit), rmag)
        ge = _mag_ge(rem.mag, dmag)
        rem = _bsel(ge, BigInt(rem.sign, _mag_sub(rem.mag, dmag)),
                    rem)._canon_sign()
        quo = quo.shift_left1()
        qmag = quo.mag.clone()
        qmag[..., 0] += ge.to(torch.int32)
        quo = BigInt(quo.sign, qmag)
    sgn = a.sign * torch.where(d.sign < 0, -1, 1).to(a.sign.dtype)
    return BigInt(sgn, quo.mag)._canon_sign()


def rational_w(num, den=1, limbs: int = DEFAULT_LIMBS) -> RationalW:
    """From BigInts or int tensors; the sign moves to the numerator.  A
    ``den`` of 1 is ones of ``num``'s shape."""
    n = num if isinstance(num, BigInt) else bigint(num, limbs)
    if isinstance(den, int) and den == 1:
        d = bigint(torch.ones_like(n.sign), n.limbs)
    else:
        d = den if isinstance(den, BigInt) else bigint(den, limbs)
    flip = d.sign < 0
    return RationalW(BigInt(torch.where(flip, -n.sign, n.sign), n.mag),
                     BigInt(d.sign.abs(), d.mag))
