"""JAX's threefry PRNG in torch integer arithmetic.

Reproduces the bits of ``jax.random`` under the default partitionable
threefry implementation (``jax_threefry_partitionable=True``): ``PRNGKey``,
``fold_in``, ``split``, the 32-bit ``random_bits`` and the bit transforms of
``uniform``, ``randint`` and ``normal``.  u32 words are carried in int64
tensors masked with ``& 0xFFFFFFFF`` after every add (torch's ``uint32``
lacks most ops).  A key is a pair ``(k1, k2)`` of int64 tensors of one
shape: a batch of keys draws for all of them at once, the counters running
along a trailing axis, which stands in for ``jax.vmap`` over keys.

``normal`` goes through XLA's f32 ``erf_inv`` polynomial, and the generator
through XLA's f32 ``log``, ``log1p`` and ``exp``: each is ported op by op
from the LLVM IR that XLA's CPU backend emits, with the fused multiply-adds
its code generator contracts (:func:`fma`), the correctly rounded square
root and the flush of subnormal results to zero, so it gives XLA's bits on
any device.  ``torch.erfinv``, ``torch.log1p``, ``torch.exp`` and torch's
f32 ``sqrt`` on the CPU round differently in some lanes.  XLA's ``pow``
(a libm call) is not always correctly rounded; :func:`pow_f32` is.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> Key:
    """The threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key ``(k1, k2)``: u32 values in broadcastable int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def prng_key(seed: int, device="cpu") -> Key:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**32``."""
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return t((seed >> 32) & M32), t(seed & M32)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: ``data`` (an int or an int tensor that
    broadcasts against the key) is hashed as the counter ``(0, data)``."""
    k1, k2 = key
    data = torch.as_tensor(data, dtype=torch.int64, device=k1.device) & M32
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def split(key: Key, num: int) -> list[Key]:
    """``jax.random.split(key, num)``: key ``i`` is the hash of ``(0, i)``."""
    k1, k2 = key
    out1, out2 = threefry2x32(k1[..., None], k2[..., None], 0,
                              torch.arange(num, dtype=torch.int64, device=k1.device))
    return [(out1[..., i], out2[..., i]) for i in range(num)]


def random_bits(key: Key, n: int) -> torch.Tensor:
    """32-bit ``random_bits`` of shape ``key.shape + (n,)``: the hash of
    counters ``(0, i)``, its two words xored (``n < 2**32``)."""
    k1, k2 = key
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], 0,
                          torch.arange(n, dtype=torch.int64, device=k1.device))
    return b1 ^ b2


def _f32(x: float) -> float:
    """``x`` rounded to f32 (a Python float that f32 holds exactly)."""
    return float(np.float32(x))


def uniform(key: Key, n: int, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: 23
    mantissa bits under the exponent of 1.0, less 1, scaled to the range
    by one fused multiply-add."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(fma(floats, float(hi - lo), float(lo)), float(lo))


def randint(key: Key, n: int, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` for int32 bounds
    with ``minval < maxval``: two words per value, reduced by ``span`` in
    wrapping u32 arithmetic; int64 values."""
    k_hi, k_lo = split(key, 2)
    hi, lo = random_bits(k_hi, n), random_bits(k_lo, n)
    span = (maxval - minval) & M32
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    off = (((hi % span) * mult + lo % span) & M32) % span
    return minval + off


# XLA's f32 erf_inv (chlo.erf_inv), coefficients of its two branches,
# highest power first: w < 5 on (w - 2.5), else on (sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


_FLT_MIN = 1.1754943508222875e-38
# log(m) on [sqrt(1/2), sqrt(2)): Cephes' logf polynomial as XLA emits it
_LOG_A = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958)
_LOG_B = (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426)
_LOG_C = (0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
# log1p below |x| < sqrt(2) - 1: a rational function of x (Cephes log1p)
_LOG1P_DEN = (15.062909126281738, 83.04756927490234, 221.7624053955078, 309.0987243652344,
              216.42788696289062, 60.11865997314453)
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551, 29.91191864013672,
              60.949668884277344, 57.11296463012695, 20.039552688598633)
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)


def _f32v(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.float32)


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as the FMA that XLA's CPU backend
    contracts a multiply and its one add into: the product is exact in
    float64, the sum rounds to float64 and then to f32 (the two roundings
    differ from one only when the float64 sum falls exactly on an f32
    midpoint)."""
    a = a.to(torch.float64)
    return (a * (b.to(torch.float64) if torch.is_tensor(b) else b) + c).to(torch.float32)


def xla_log(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log``: ``v = m * 2^e`` with ``m`` in ``[0.5, 1)``, folded
    into ``[sqrt(1/2), sqrt(2))``, then a polynomial in ``m - 1``."""
    bits = torch.where(v > _FLT_MIN, v, _FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = _f32v((bits & 0x7FFFFF) | 0x3F000000)
    lt = m < 0.7071067690849304
    e = e - torch.where(lt, 1.0, 0.0)
    r = (m - 1.0) + torch.where(lt, m, 0.0)
    r2 = r * r
    r3 = r2 * r
    a, b, c = (fma(fma(r, k[0], k[1]), r, k[2]) for k in (_LOG_A, _LOG_B, _LOG_C))
    t = fma(fma(fma(a, r3, b), r3, c), r3, e * _LN2_LO)
    y = fma(e, _LN2_HI, (r - r2 * 0.5) + t)
    y = torch.where(v > 0.0, y, float("nan"))
    # subnormal inputs read as zero, as under XLA's CPU flush-to-zero mode
    return torch.where(v.abs() < _FLT_MIN, float("-inf"), torch.where(v == float("inf"), v, y))


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p``: ``xla_log(x + 1)``, or for ``|x| < sqrt(2) - 1``
    ``x - x^2/2 + x^3 P(x)/Q(x)``."""
    x2 = x * x
    den = torch.ones_like(x)
    for k in _LOG1P_DEN:
        den = fma(den, x, k)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for k in _LOG1P_NUM[1:]:
        num = fma(num, x, k)
    small = x + fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < 0.4142135679721832, small, xla_log(x + 1.0))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``exp``: ``2^n * exp(r)``, ``n = floor(x log2(e) + 1/2)``
    clamped to ``[-127, 127]``, ``r`` reduced by ln 2 in two parts."""
    x = x.clamp(-87.80000305175781, 88.80000305175781)
    n = torch.floor(fma(x, 1.4426950216293335, 0.5)).clamp(-127.0, 127.0)
    r = fma(n, -_LN2_LO, fma(n, -_LN2_HI, x))
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for k in _EXP_P[2:]:
        p = fma(p, r, k)
    y = (1.0 + fma(p, r * r, r)) * _f32v((n.to(torch.int32) + 127) << 23)
    return torch.where(y < _FLT_MIN, 0.0, y)  # XLA's CPU flushes subnormals to zero


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's ``sqrt`` gives it
    (torch's f32 ``sqrt`` on the CPU is off by an ulp in some lanes): the
    float64 root rounded to f32, which double rounding cannot spoil."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def pow_f32(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** e`` in f32 (``e`` rounded to f32), computed in float64 and
    rounded once.  XLA's ``pow`` is off by an ulp from this in some lanes
    (594 of 2^20 at x^-10)."""
    return (x.to(torch.float64) ** _f32(e)).to(torch.float32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``, op for op: ``w = -log1p(x * -x)``, a degree-8
    polynomial by Horner's rule in ``w - 2.5`` or ``sqrt(w) - 3``, times
    ``x``; ``x * inf`` at ``|x| == 1``."""
    w = -xla_log1p(x * -x)
    small = w < 5.0
    t = torch.where(small, w - 2.5, sqrt_f32(w) - 3.0)
    coef = lambda j: torch.where(small, _f32(_ERFINV_LT5[j]), _f32(_ERFINV_GE5[j]))
    p = coef(0)
    for j in range(1, 9):
        p = fma(p, t, coef(j))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: Key, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)``: ``sqrt(2) *
    erf_inv(uniform(lo=nextafter(-1, 0), hi=1))``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, n, float(lo), 1.0)
    return _f32(np.sqrt(2)) * erf_inv(u)
