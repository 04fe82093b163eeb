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
f32 ``sqrt`` on the CPU round differently in some lanes.  XLA's CPU
``pow`` is an external call to glibc's ``powf``, which :func:`pow_f32`
ports to float64 torch ops.
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


def split_keys(key: Key, num: int) -> Key:
    """The keys of ``jax.random.split(key, num)`` as one key batch of shape
    ``key.shape + (num,)``, as ``jax.vmap`` over the split keys sees them:
    key ``i`` is the hash of ``(0, i)``."""
    k1, k2 = key
    return threefry2x32(k1[..., None], k2[..., None], 0,
                        torch.arange(num, dtype=torch.int64, device=k1.device))


def split(key: Key, num: int) -> list[Key]:
    """``jax.random.split(key, num)``: key ``i`` is the hash of ``(0, i)``."""
    out1, out2 = split_keys(key, num)
    return [(out1[..., i], out2[..., i]) for i in range(num)]


def random_bits(key: Key, n: int, offset: int = 0) -> torch.Tensor:
    """32-bit ``random_bits`` of shape ``key.shape + (n,)``: the hash of
    counters ``(0, i)``, its two words xored (``n < 2**32``).  With
    ``offset`` the lanes ``offset .. offset + n - 1`` of a longer draw."""
    k1, k2 = key
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], 0,
                          torch.arange(offset, offset + n, dtype=torch.int64, device=k1.device))
    return b1 ^ b2


def _f32(x: float) -> float:
    """``x`` rounded to f32 (a Python float that f32 holds exactly)."""
    return float(np.float32(x))


def uniform(key: Key, n: int, minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: 23
    mantissa bits under the exponent of 1.0, less 1, scaled to the range
    by one fused multiply-add (lanes from ``offset``, as ``random_bits``)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, n, offset) >> 9) | 0x3F800000
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


# glibc's powf (sysdeps/ieee754/flt-32/e_powf.c, from ARM's optimized
# routines).  log2(x) on 16 subintervals of [0x3f330000, 2 * 0x3f330000):
# {1/c, log2(c)} per subinterval and the degree-5 polynomial of
# log1p(r)/ln 2, read from the read-only data of glibc's libm.so.6
# (__powf_log2_data, the 16-entry table followed by its polynomial).
_POWF_INVC = tuple(float.fromhex(h) for h in (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010b0p+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8ea0p+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1.0p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aa0p-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1"))
_POWF_LOGC = tuple(float.fromhex(h) for h in (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7af0p-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2"))
_POWF_LOG2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
# exp2 on x = k/32 + r: 2^(k/32) from the table below times a cubic in r
# (__exp2f_data: the polynomial and the shift 0x1.8p+52 / 32 from libm.so.6;
# its table holds 2^(i/32) rounded to double, less i << 47, which is
# written here as 2^(i/32) itself)
_EXP2F_TAB = tuple(float.fromhex(h) for h in (
    "0x1.0p+0", "0x1.059b0d3158574p+0", "0x1.0b5586cf9890fp+0", "0x1.11301d0125b51p+0",
    "0x1.172b83c7d517bp+0", "0x1.1d4873168b9aap+0", "0x1.2387a6e756238p+0",
    "0x1.29e9df51fdee1p+0", "0x1.306fe0a31b715p+0", "0x1.371a7373aa9cbp+0",
    "0x1.3dea64c123422p+0", "0x1.44e086061892dp+0", "0x1.4bfdad5362a27p+0",
    "0x1.5342b569d4f82p+0", "0x1.5ab07dd485429p+0", "0x1.6247eb03a5585p+0",
    "0x1.6a09e667f3bcdp+0", "0x1.71f75e8ec5f74p+0", "0x1.7a11473eb0187p+0",
    "0x1.82589994cce13p+0", "0x1.8ace5422aa0dbp+0", "0x1.93737b0cdc5e5p+0",
    "0x1.9c49182a3f090p+0", "0x1.a5503b23e255dp+0", "0x1.ae89f995ad3adp+0",
    "0x1.b7f76f2fb5e47p+0", "0x1.c199bdd85529cp+0", "0x1.cb720dcef9069p+0",
    "0x1.d5818dcfba487p+0", "0x1.dfc97337b9b5fp+0", "0x1.ea4afa2a490dap+0",
    "0x1.f50765b6e4540p+0"))
_EXP2F_POLY = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")
_POWF_OFF = 0x3F330000
_SPLIT = 134217729.0  # 2^27 + 1, Dekker's splitter for float64


def _fma64(a, b, c) -> torch.Tensor:
    """float64 ``a * b + c`` rounded once, from plain float64 ops: Dekker's
    exact product ``p + e`` of ``a`` and ``b``, Knuth's exact sum ``s + t``
    of ``p`` and ``c``, then ``s + (t + e)``.  Each op is a torch op of its
    own, so neither the host nor the card contracts it into another FMA."""
    if not torch.is_tensor(a):
        a, b = b, a
    p = a * b
    t = a * _SPLIT
    ah = t - (t - a)
    al = a - ah
    if torch.is_tensor(b):
        t = b * _SPLIT
        bh = t - (t - b)
    else:
        bh = (b * _SPLIT) - ((b * _SPLIT) - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def pow_f32(x, e) -> torch.Tensor:
    """f32 ``x ** e`` as XLA's CPU computes it: by glibc's ``powf``, under
    XLA's flush-to-zero and denormals-are-zero modes (a subnormal result is
    0, a subnormal ``x`` reads as zero where glibc rescales it).  ``x`` and
    ``e`` are tensors or Python floats (rounded to f32), broadcast together.
    ``log2(x)`` by the 16-entry table and a polynomial in float64, times
    ``e``, then ``exp2`` by the 32-entry table and a cubic, rounded once to
    f32.  The multiply-adds are those that glibc's x86-64 ``__powf_fma``
    variant fuses, each rounded once (:func:`_fma64`).  Where the result is
    a special value, the float64 power gives it exactly: at a zero,
    infinite or NaN ``x`` or ``e``, and NaN at a negative ``x`` under a
    fractional ``e``.  A negative ``x`` under an integer ``e`` takes the
    main path on ``|x|`` and keeps its sign where ``e`` is odd, as glibc
    does."""
    dev = next((t.device for t in (x, e) if torch.is_tensor(t)), None)
    x = torch.as_tensor(x, device=dev).to(torch.float32)
    y = torch.as_tensor(e, device=dev).to(torch.float32).to(torch.float64)
    ax = x.abs()
    # glibc rescales a subnormal x by 2^23, which XLA's denormals-are-zero
    # mode makes 0: its bits less 23 << 23
    ix = torch.where(ax < _FLT_MIN, -(23 << 23), ax.view(torch.int32).to(torch.int64))
    tmp = ix - _POWF_OFF
    i = (tmp >> 19) & 15
    k = tmp >> 23
    z = (ix - (k << 23)).to(torch.int32).view(torch.float32).to(torch.float64)
    f64 = dict(dtype=torch.float64, device=x.device)
    invc = torch.tensor(_POWF_INVC, **f64)[i]
    logc = torch.tensor(_POWF_LOGC, **f64)[i]
    A = _POWF_LOG2_POLY
    r = _fma64(z, invc, -1.0)
    y0 = logc + k.to(torch.float64)
    r2 = r * r
    q = _fma64(A[4], r, y0)
    q = _fma64(_fma64(A[2], r, A[3]), r2, q)
    logx = _fma64(_fma64(A[0], r, A[1]), r2 * r2, q)
    ylogx = y * logx
    kd = (ylogx + _EXP2F_SHIFT) - _EXP2F_SHIFT  # k/32, rounded to nearest
    rr = ylogx - kd
    kk = (kd * 32.0).nan_to_num(0.0).clamp(-8192.0, 8192.0).to(torch.int64)
    scale = (((kk >> 5) + 1023) << 52).view(torch.float64)  # 2^(k >> 5)
    s = torch.tensor(_EXP2F_TAB, **f64)[kk & 31] * scale
    C = _EXP2F_POLY
    p = _fma64(_fma64(C[0], rr, C[1]), rr * rr, _fma64(C[2], rr, 1.0))
    out = (p * s).to(torch.float32)
    out = torch.where(ylogx > float.fromhex("0x1.fffffffd1d571p+6"), float("inf"), out)
    out = torch.where((ylogx <= -150.0) | (out < _FLT_MIN), 0.0, out)  # and flush to zero
    y_int = y == torch.floor(y)
    odd = y_int & (torch.remainder(y, 2.0) == 1.0)  # an odd integer power keeps x's sign
    out = torch.where(odd & (x < 0), -out, out)
    special = ~torch.isfinite(x) | (x == 0) | ~torch.isfinite(y) | ((x < 0) & ~y_int)
    return torch.where(special, (x.to(torch.float64) ** y).to(torch.float32), out)


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


def normal(key: Key, n: int, offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)``: ``sqrt(2) *
    erf_inv(uniform(lo=nextafter(-1, 0), hi=1))`` (lanes from ``offset``,
    as ``random_bits``).  A draw of shape ``(a, b, ...)`` is this draw of
    ``a * b * ...`` lanes, reshaped."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, n, float(lo), 1.0, offset)
    return _f32(np.sqrt(2)) * erf_inv(u)
