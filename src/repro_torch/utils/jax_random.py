"""The ``jax.random`` draws the reference makes, replayed in PyTorch.

The reference derives every random number from Threefry-2x32 keys
(``jax.random.PRNGKey``, ``fold_in``) and draws normals with
``jax.random.normal``.  The reference runs with
``jax_threefry_partitionable=True``: element ``i`` of a draw hashes the
counter pair ``(i >> 32, i & 0xffffffff)`` and its 32 random bits are the
XOR of the two output words.  An f32 normal is a uniform on
``[nextafter(-1, 0), 1)`` built from the top 23 bits, mapped through
``sqrt(2)·erfinv`` with XLA's single-precision Giles polynomial.

A key is a pair of Python ints (two uint32 words).  Keys depend only on
the seed, the step, the probe and the leaf path, so they are derived on the
host and never need the device.  Draws run in torch on the device they are
asked for, in int64 arithmetic masked to 32 bits (torch's uint32 support is
partial).  Nothing in a draw copies from the host but the keys themselves
(pinned, non-blocking) and nothing reads back, so a draw on the card never
waits for it; :class:`NormalDraws` keeps, per layout of sizes, the
per-element segment and index tensors it gathers the keys with.  The
integer parts (keys, bits, uniforms) equal the reference's bit for bit.  The normals replay XLA:CPU's own f32 ``log``/``log1p``
polynomials and the multiply-adds its backend fuses (emulated in f64), and
take the correctly rounded square root XLA takes (torch's own f32 ``sqrt``
on the CPU is an ulp off on about 1 in 140 inputs), so they equal the
reference's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# one normal() call draws at most this many elements per int64 pass, which
# bounds its transient memory (about 10 int64 temporaries per element)
_CHUNK = 1 << 23

# uniform's range [nextafter(-1, 0), 1) and its f32 width, as XLA forms them
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_SPAN = float(np.float32(1.0) - _LO)
_SQRT2 = float(np.float32(np.sqrt(2)))

# XLA's ErfInv32 coefficients (Giles, "Approximating the erfinv function")
_ERFINV_SMALL = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_LARGE = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds.  Works on Python ints and on torch
    int64 tensors holding values in [0, 2**32); tensors are worked in
    place on fresh copies (broadcast to one shape), one temporary in all."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    if torch.is_tensor(x1) or torch.is_tensor(x2):
        device = (x1 if torch.is_tensor(x1) else x2).device
        x1, x2 = (t.contiguous() for t in torch.broadcast_tensors(
            torch.as_tensor(x1, device=device), torch.as_tensor(x2, device=device)))
        tmp = torch.empty_like(x2)

        def add(a, b):
            return a.add_(b).bitwise_and_(MASK)

        def rotl_xor(a, d, b):
            torch.bitwise_left_shift(a, d, out=tmp).bitwise_and_(MASK)
            return a.bitwise_right_shift_(32 - d).bitwise_or_(tmp).bitwise_xor_(b)
    else:
        def add(a, b):
            return (a + b) & MASK

        def rotl_xor(a, d, b):
            return _rotl(a, d) ^ b
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x1 = add(x1, x2)
            x2 = rotl_xor(x2, rot, x1)
        x1 = add(x1, ks[(i + 1) % 3])
        x2 = add(x2, ks[(i + 2) % 3] + (i + 1))
    return x1, x2


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (x64 off)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside int32, as the reference requires")
    return (0, seed & MASK)


def as_key(key) -> tuple[int, int]:
    """A key as two Python ints, from a pair or a uint32[2] array."""
    k1, k2 = (int(x) for x in np.asarray(key, dtype=np.uint64).reshape(2))
    return k1, k2


def key_data(key) -> np.ndarray:
    """The key as the reference stores it: ``uint32[2]``."""
    return np.asarray(as_key(key), dtype=np.uint32)


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: hash the counter pair (0, data)."""
    k1, k2 = as_key(key)
    return threefry2x32(k1, k2, 0, int(data) & MASK)


def _bits(k1, k2, start: int, count: int, device) -> torch.Tensor:
    """32 random bits for flat indices [start, start + count) of a draw,
    as int64.  ``k1``/``k2`` are ints or int64 tensors of length ``count``
    (one key per element)."""
    idx = torch.arange(start, start + count, dtype=torch.int64, device=device)
    x1, x2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return x1 ^ x2


def _fma(a, b, c):
    """f32 fused multiply-add, as XLA:CPU's backend contracts a multiply
    into the add that consumes it: the f64 product of two f32 values is
    exact, so one f64 add and one f32 rounding give the fused result (the
    two roundings differ from one only on exact f64 ties, which f32 inputs
    cannot produce here)."""
    a = a.double() if torch.is_tensor(a) else a
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a * b + c).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


# XLA's f32 log (Cephes' logf) and log1p (Cephes' rational form below
# sqrt(2) - 1, log(1 + x) above), with the multiply-adds its CPU backend fuses
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_LOG1P_DEN = tuple(_f32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_NUM = tuple(_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log for x > 0."""
    bits = torch.clamp_min(x, _f32(1.17549435e-38)).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    below = m < _f32(0.707106781186547524)
    e = e - below.float()
    x = (m + -1.0) + torch.where(below, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    x = (x - x2 * 0.5) + y
    return _fma(e, _LOG_Q2, x)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log1p for x > -1."""
    x2 = x * x
    den = torch.full_like(x, _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, c)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, _xla_log(x + 1.0))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's, formed in f64 (a
    double square root rounds once more to f32 without a double-rounding
    error)."""
    return torch.sqrt(x.double()).float()


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ErfInv (Giles' polynomial, Horner steps fused) for |x| < 1.
    The coefficients enter as f32-valued scalars, so a draw on the card
    copies nothing from the host."""
    w = -_xla_log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, sqrt_rn(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for lo, hi in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, torch.where(small, lo, hi))
    return p * x


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    u = torch.clamp_min(floats * _SPAN + float(_LO), float(_LO))
    return erfinv_f32(u) * _SQRT2


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device``."""
    k1, k2 = as_key(key)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, _CHUNK):
        count = min(_CHUNK, n - start)
        out[start:start + count] = _normal_from_bits(_bits(k1, k2, start, count, device))
    return out.reshape(shape)


# f32 and bf16 share the smallest normal, 2**-126 (``finfo(dtype).tiny``)
_TINY = float(np.finfo(np.float32).tiny)


def _key_words(keys, device) -> tuple:
    """A key, or ``[R, 2]`` keys, as two int64 values to broadcast over a
    draw: ints for one key, ``[R, 1]`` tensors for one key per row."""
    arr = np.asarray(keys, dtype=np.uint64)
    if arr.shape == (2,):
        return int(arr[0]), int(arr[1])
    arr = arr.reshape(-1, 2).astype(np.int64)
    t = torch.from_numpy(arr).to(device)
    return t[:, :1], t[:, 1:]


def uniform(key, shape, dtype=torch.float32, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for f32 and
    bf16: the dtype's mantissa bits of the draw (the low 8 bits for bf16,
    whose 7-bit mantissa jax draws from 8-bit words) under exponent 0, less
    one, then ``floats * (maxval - minval) + minval`` and ``max(minval,
    .)`` in ``dtype``, each op rounded to it (a bf16 op runs in f32 and
    rounds once, as XLA:CPU's does).  ``key`` may be ``[R, 2]`` keys for a
    draw of shape ``[R, ...]``: row i is ``uniform(key[i], shape[1:])``."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _key_words(key, device)
    per_key = math.prod(shape[1:]) if torch.is_tensor(k1) else math.prod(shape)
    idx = torch.arange(per_key, dtype=torch.int64, device=device)
    x1, x2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    bits = (x1 ^ x2).reshape(shape)
    if dtype == torch.float32:
        fbits = (bits >> 9) | 0x3F800000
    elif dtype == torch.bfloat16:
        fbits = ((bits & 0xFF) >> 1) << 16 | 0x3F800000
    else:
        raise TypeError(f"uniform draws f32 or bf16, not {dtype}")
    floats = fbits.to(torch.int32).view(torch.float32).to(dtype) - 1.0
    lo, hi = (torch.tensor(v, dtype=dtype) for v in (minval, maxval))
    span = (hi.float() - lo.float()).to(dtype)
    out = (floats.float() * span.float()).to(dtype)
    out = (out.float() + lo.float()).to(dtype)
    return torch.maximum(out, lo.to(device))


def gumbel(key, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` in its default ``mode="low"``:
    ``-log(-log(uniform(key, minval=tiny, maxval=1)))`` with XLA:CPU's f32
    log, each op rounded to ``dtype``.  ``key`` as :func:`uniform`'s."""
    u = uniform(key, shape, dtype, _TINY, 1.0, device)
    inner = (-_xla_log(u.float())).to(dtype)
    return (-_xla_log(inner.float())).to(dtype)


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the argmax along
    ``axis`` of ``gumbel(key, logits.shape, logits.dtype) + logits`` (the
    first maximum on ties, as ``jnp.argmax``).  ``key`` may be ``[R, 2]``
    keys for ``logits`` of shape ``[R, ...]``, one key per row, which is
    ``vmap`` of the one-key draw over the rows."""
    g = gumbel(key, logits.shape, logits.dtype, logits.device)
    z = (g.float() + logits.float()).to(logits.dtype)
    return torch.argmax(z, dim=axis)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: one pinned, non-blocking copy on the
    card (a pageable copy would wait on the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class NormalDraws:
    """Vectorized normal draws on one device: ``draws(keys, sizes)`` is the
    concatenation of ``normal(keys[i], (sizes[i],)).ravel()``, ``keys``
    ``[N, 2]`` ints.  Per call only the keys go to the device; the
    per-element segment and index tensors are formed on the device once
    per layout of sizes and kept by this object (one per training run)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._layouts: dict = {}

    def _layout(self, sizes: np.ndarray) -> tuple:
        """Each element's segment and index in it, formed on the device from
        the sizes (``output_size`` keeps ``repeat_interleave`` from waiting
        on the device for the total)."""
        key = sizes.tobytes()
        if key not in self._layouts:
            if int(sizes.max()) > MASK:
                raise ValueError("a draw of 2**32 elements or more is not supported")
            total = int(sizes.sum())
            seg = torch.repeat_interleave(
                torch.arange(len(sizes), device=self.device), to_device(sizes, self.device),
                output_size=total)
            starts = to_device(np.cumsum(sizes) - sizes, self.device)
            idx = torch.arange(total, device=self.device) - starts.index_select(0, seg)
            self._layouts[key] = (seg, idx)
        return self._layouts[key]

    def __call__(self, keys, sizes) -> torch.Tensor:
        sizes = np.asarray(sizes, dtype=np.int64).reshape(-1)
        if int(sizes.sum()) == 0:
            return torch.empty(0, dtype=torch.float32, device=self.device)
        seg, idx = self._layout(sizes)
        keys_t = to_device(np.asarray(keys, dtype=np.int64).reshape(-1, 2).T.copy(), self.device)
        x1, x2 = threefry2x32(keys_t[0].index_select(0, seg), keys_t[1].index_select(0, seg),
                              0, idx)
        return _normal_from_bits(x1 ^ x2)


def normal_many(keys, sizes, device="cpu") -> torch.Tensor:
    """Many draws in one vectorized pass on ``device``: the concatenation of
    ``normal(keys[i], (sizes[i],)).ravel()`` (a one-off
    :class:`NormalDraws`)."""
    return NormalDraws(device)(keys, sizes)
