"""``jax.random``'s threefry-2x32 stream, bit for bit, in plain PyTorch.

The chain engine of ``mh_tpu`` draws every random number through
``jax.random`` with the default threefry implementation and the
partitionable layout (``jax_threefry_partitionable=True``). This module
reproduces that stream, so the port's engine consumes exactly the uniforms
``mh_tpu``'s engine consumes:

- ``key(seed)`` is the word pair ``(0, seed mod 2^32)``;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- ``split(k, n)[i]`` is ``threefry2x32(k, (hi(i), lo(i)))``, which equals
  ``fold_in(k, i)``;
- ``uniform(k, shape)`` hashes each flat index ``i`` of ``shape`` as the
  counter ``(hi(i), lo(i))``, takes ``out0 ^ out1``, keeps its top 23 bits
  as the mantissa of a float in [1, 2) and subtracts 1;
- ``normal(k, shape)`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  (nextafter(-1, 0), 1), ``erf_inv`` as XLA computes it on the CPU.

``fma`` rounds a multiply-add once, as XLA's fused multiply-add does, so
the gradient samplers' leapfrog and step-size updates follow ``mh_tpu``'s.

A key is an int64 tensor ``[..., 2]`` holding two 32-bit words; every
function is batched over the leading dims of its key. The words are int64
with every result masked to 32 bits (PyTorch has no full uint32
arithmetic), so the same code runs on CPU and CUDA tensors, reads nothing
back to the host and can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash (20 rounds), as ``jax._src.prng`` computes it.

    Every argument is an int64 tensor (or int) of 32-bit words; they
    broadcast. Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device=None) -> Tensor:
    """``jax.random.key(seed)`` as its two words, ``(0, seed mod 2^32)``."""
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def key_data(k: Tensor) -> np.ndarray:
    """The key words as uint32, the layout of ``jax.random.key_data``."""
    return k.detach().cpu().numpy().astype(np.uint32)


def wrap_key_data(words, device=None) -> Tensor:
    """A key from its uint32 words (e.g. ``jax.random.key_data(k)``)."""
    return torch.as_tensor(np.asarray(words, np.uint32).astype(np.int64), device=device)


def fold_in(k: Tensor, data) -> Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and data (int or int tensor,
    taken mod 2^32) broadcast over the leading dims."""
    if isinstance(data, Tensor):
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    out0, out1 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(out0, out1), -1)


def split(k: Tensor, n: int = 2) -> Tensor:
    """``jax.random.split(k, n)``: ``[..., n, 2]``; entry ``i`` is
    ``fold_in(k, i)`` (counters below 2^32 have a zero high word)."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    return fold_in(k[..., None, :], idx)


def random_bits(k: Tensor, shape: tuple[int, ...]) -> Tensor:
    """32 random bits (int64 in [0, 2^32)) per element: ``[..., *shape]``."""
    shape = tuple(shape)
    n = math.prod(shape)
    flat = torch.arange(n, dtype=torch.int64, device=k.device)
    out0, out1 = threefry2x32(k[..., 0, None], k[..., 1, None], flat >> 32, flat & M32)
    return (out0 ^ out1).reshape(tuple(k.shape[:-1]) + shape)


def f32(v: float) -> float:
    """``v`` rounded to float32, as JAX rounds a Python scalar operand. The
    result is exact in float32, so a PyTorch op on a float32 tensor uses
    the same value on either device."""
    return float(np.float32(v))


def reciprocal(n: int) -> float:
    """``1 / n`` in float32. XLA turns a division by a constant into a
    multiply by its float32 reciprocal, and so does PyTorch on CUDA for a
    host scalar; the port multiplies by it explicitly on both devices."""
    return float(np.float32(1.0) / np.float32(n))


def uniform(k: Tensor, shape: tuple[int, ...] = (), minval=0.0, maxval=1.0) -> Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: ``[..., *shape]``.

    Bounds are Python numbers (rounded to float32, as JAX rounds them) or
    float32 tensors that broadcast against the result. XLA contracts the
    scaling ``f * (maxval - minval) + minval`` into one fused multiply-add;
    here the product is exact in float64 and the sum is rounded once more
    to float32, which gives the fused result on both devices (the two can
    part only where the float64 sum lands on a float32 rounding midpoint).
    """
    bits = random_bits(k, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if not isinstance(minval, Tensor) and not isinstance(maxval, Tensor):
        lo, hi = f32(minval), f32(maxval)
        if (lo, hi) == (0.0, 1.0):
            return f  # f * 1 + 0, floored at 0: f itself
        span = f32(np.float32(hi) - np.float32(lo))
        return torch.clamp_min((f.double() * span + lo).float(), lo)
    lo = torch.as_tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=f.device)
    scaled = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())


# XLA's float32 erf_inv (Giles' single-precision approximation): the
# Horner coefficients for w < 5 and for w >= 5, highest power first
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p below |x| = sqrt(2) - 1: Cephes' rational approximation
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's float32 log on the CPU (Cephes' logf): mantissa polynomial, then
# the exponent times log(2) split in two
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
           1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
           3.3333331174e-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375


def fma(a: Tensor, b, c) -> Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add: the
    float64 product of two floats is exact. Operands are float32 tensors
    or Python numbers exact in float32; they broadcast. XLA contracts a
    multiply feeding an add into one, on the CPU and on GPUs; where the
    port must round as ``mh_tpu`` does, it calls this."""
    b = b.double() if isinstance(b, Tensor) else b
    c = c.double() if isinstance(c, Tensor) else c
    return (a.double() * b + c).float()


def _logf(x: Tensor) -> Tensor:
    """XLA's float32 ``log`` on the CPU, for positive normal ``x``: ``x =
    2^e m`` with m in [sqrt(1/2), sqrt(2)), a degree-8 polynomial in ``m -
    1`` and the multiply-adds fused as LLVM contracts them."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = m < f32(0.707106781186547524)
    e = e - low.float()
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    p = [f32(c) for c in _LOGF_P]
    x2 = t * t
    x3 = x2 * t
    y = fma(fma(t, p[0], p[1]), t, p[2])
    y1 = fma(fma(t, p[3], p[4]), t, p[5])
    y2 = fma(fma(t, p[6], p[7]), t, p[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * f32(_LOGF_Q1))
    t = fma(x2, -0.5, t) + y
    return fma(e, f32(_LOGF_Q2), t)


def _log1p(x: Tensor) -> Tensor:
    """XLA's float32 ``log1p`` on the CPU, for ``x`` in (-1, 0]: the Cephes
    rational approximation below |x| = sqrt(2) - 1, ``log(1 + x)`` above."""
    def poly(coeffs):
        p = torch.full_like(x, f32(coeffs[0]))
        for c in coeffs[1:]:
            p = fma(p, x, f32(c))
        return p

    x2 = x * x
    small = (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))
    small = x + fma(x2, -0.5, small)
    big = _logf(torch.clamp_min(1.0 + x, f32(np.finfo(np.float32).tiny)))
    return torch.where(torch.abs(x) < f32(math.sqrt(2.0) - 1.0), small, big)


def _sqrt(x: Tensor) -> Tensor:
    """The correctly rounded float32 square root of ``x >= 0``, as XLA's
    and CUDA's ``sqrt`` give it: two Newton steps in float64. PyTorch's
    vectorised CPU ``torch.sqrt`` on float32 is not correctly rounded: on
    an AVX-512 build it is 1 ulp off in about 0.6% of elements once a
    tensor holds 32 or more (``test_sqrt_is_correctly_rounded``)."""
    xd = x.double()
    s = torch.sqrt(xd)
    for _ in range(2):
        s = torch.where(s > 0, 0.5 * (s + xd / s), s)
    return s.float()


def erf_inv(x: Tensor) -> Tensor:
    """``jax.lax.erf_inv`` on float32 as XLA computes it on the CPU:
    ``w = -log1p(-x^2)``, a nine-term Horner polynomial in ``w - 2.5`` (w <
    5) or ``sqrt(w) - 3``, each step one fused multiply-add, times ``x``;
    +-inf at +-1. Every step is a float32 operation rounded once, so the
    bits are the same on the CPU and on CUDA and follow XLA's on the CPU
    (the tests hold them within 2 ulps); ``torch.erfinv`` parts by many
    ulps in most inputs."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, f32(_ERF_INV_LT5[i]), f32(_ERF_INV_GE5[i]))

    p = coeff(0)
    for i in range(1, len(_ERF_INV_LT5)):
        p = fma(p, w, coeff(i))
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = f32(math.sqrt(2.0))


def normal(k: Tensor, shape: tuple[int, ...] = ()) -> Tensor:
    """``jax.random.normal(k, shape, float32)``: ``[..., *shape]``, batched
    over the leading dims of the key like :func:`uniform`."""
    return _SQRT2 * erf_inv(uniform(k, shape, _NORMAL_LO, 1.0))
