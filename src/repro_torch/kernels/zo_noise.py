"""Dense-noise ZO passes of the MeZO family: the counter stream, the two
hand-written CUDA kernels' wrappers and their plain PyTorch versions
(counterpart of ``repro.kernels.zo_noise`` and the noise wrappers of
``repro.kernels.ops``).

Each element's z is a pure function of (leaf key, probe, row, col): one
20-round Threefry-2x32 block on key ``(key_t[0] ^ path_hash, key_t[1])``
(:func:`leaf_seed`) and counter ``(col, row | probe << 24)``, then
Box–Muller on the top 24 bits of each output word, one normal per element.
Slice i of a stacked leaf ``[L, m, n]`` draws under the key
``threefry2x32(seed, (i, 0x5EED51CE))`` (:func:`batch_seeds`), one leading
dim per level.  Nothing is stored: every pass regenerates z.

The stream's f32 functions are the ones the reference computes it with on
the CPU: XLA:CPU's own ``log`` (replayed in ``utils.jax_random``) and
glibc's ``cosf``, which XLA:CPU calls (replayed here in f64, checked
against XLA on every angle the stream can draw).  With every other op one
IEEE-rounded f32 op, the plain version, the CUDA kernels
(``csrc/zo_noise.cuh``) and the reference draw the same bits.

Kernels (replacing ``repro/kernels/zo_noise.py::noise_perturb`` and
``::noise_update``): :func:`noise_perturb` is a chain of up to
``_build.MAX_CHAIN`` deltas ``W ← round_W(W + s_p·z_p)`` (a perturb, the flip,
the bridge), :func:`noise_update` the optional restore chain then the
probe mean ``g = (Σ_p κ_p·z_p)·f32(1/q)`` and the sgd, momentum or adam
rule with the decoupled decay folded in; both write W in place (the
perturb into ``out`` if given), the update its f32 moments too.  One
launch per leaf, the slice of a stacked leaf on the grid, ragged edges
masked.  On a CPU tensor each runs its plain version; on a CUDA tensor it
launches its kernel or raises.

Shards (``offsets``).  When ``w`` is one rank's shard of a leaf sharded on
a host mesh (``distributed.sharding``), ``offsets`` holds the global
coordinates of its origin, one int per dim, with the meaning of the
reference's ``ops.noise_perturb(..., offsets=)``: each slice key takes the
global leading index and each draw the global row and column, so the
shard's result is the matching slice of the whole leaf's, bit for bit.  No
offsets means zeros.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LeadDims, NoiseChain, NoiseHyp, NoiseOffsets
from repro_torch.kernels.tezo_perturb import _DTYPES, _check_out
from repro_torch.utils import jax_random
from repro_torch.utils.tree import _path_hash

MAX_ROWS = 1 << 24  # the row shares a counter word with the probe id
MAX_PROBES = 1 << 8
BATCH_TWEAK = 0x5EED51CE  # repro/kernels/ops.py _batch_seeds
VARIANTS = ("sgd", "momentum", "adam")
_TWO_PI = float(np.float32(2.0 * math.pi))

# --------------------------------------------------------------------------
# keys and the counter stream
# --------------------------------------------------------------------------


def leaf_seed(key_t, path: str) -> tuple[int, int]:
    """The leaf's Threefry key: ``(key_t[0] ^ path_hash, key_t[1])``."""
    k0, k1 = jax_random.as_key(key_t)
    return k0 ^ _path_hash(path), k1


def batch_seeds(seed, batch: int, offset: int = 0) -> list[tuple[int, int]]:
    """One key per slice of a leading dim: the global slice index (``offset``
    + the local one) encrypted under the parent key with the tweak word
    (not XOR-ed in, which would collide across nesting levels)."""
    k0, k1 = seed
    return [jax_random.threefry2x32(k0, k1, i + offset, BATCH_TWEAK) for i in range(batch)]


def _slices(shape, seed, lead_offsets=()):
    """(index, key) of every [m, n] matrix of a leaf, the leading dims
    peeled one level at a time (``lead_offsets``: a shard's global leading
    indices)."""
    if len(shape) == 2:
        return [((), seed)]
    off = lead_offsets[0] if lead_offsets else 0
    return [((i,) + idx, s)
            for i, si in enumerate(batch_seeds(seed, shape[0], off))
            for idx, s in _slices(shape[1:], si, lead_offsets[1:])]


def _offsets(w, offsets) -> tuple:
    """One int per dim of ``w`` (zeros for None), checked."""
    if offsets is None:
        return (0,) * w.dim()
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) != w.dim() or any(o < 0 for o in offsets):
        raise ValueError(f"offsets {offsets} must be {w.dim()} ints >= 0 for W "
                         f"{tuple(w.shape)}")
    if offsets[-2] + w.shape[-2] >= MAX_ROWS:
        raise ValueError(f"global rows up to {offsets[-2] + w.shape[-2]}: the row index must "
                         "fit 24 bits")
    return offsets


# glibc's cosf tables (sysdeps/ieee754/flt-32/sincosf_data.c)
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_COS_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16"))
_SIN_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))


def _cos_poly(x, x2, sgn):
    """glibc's double cosine polynomial; ``sgn`` flips its coefficients."""
    c0, c1, c2, c3, c4 = (sgn * c for c in _COS_C)
    x4 = x2 * x2
    hi = c3 + x2 * c4
    lo = c0 + x2 * c1
    x6 = x4 * x2
    return (lo + x4 * c2) + x6 * hi


def _sin_poly(x, x2):
    s1, s2, s3 = _SIN_S
    x3 = x * x2
    t = s2 + x2 * s3
    x7 = x3 * x2
    return (x + x3 * s1) + x7 * t


def cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's f32 ``cosf`` for 0 <= y < 120, in f64 op for op: the
    abstop12 range tests, the reduction by pi/2 and the polynomials."""
    top = (y.view(torch.int32) >> 20) & 0x7FF
    x = y.double()
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    xr = x - n.double() * _HPI
    flip = torch.where((n & 2) != 0, -1.0, 1.0).to(x)
    xs = xr * torch.where(((n & 3) == 1) | ((n & 3) == 2), -1.0, 1.0).to(x)
    x2 = xr * xr
    reduced = torch.where((n & 1) == 1, _sin_poly(xs, x2), _cos_poly(xs, x2, flip))
    small = torch.where(top < 0x398, 1.0, _cos_poly(x, x * x, 1.0))
    return torch.where(top < 0x3F4, small, reduced).float()


# elements per block of rows the plain stream draws at once: its int64
# temporaries stay in a CPU core's cache (three times faster than one pass
# over a vocabulary matrix); on the card, few large launches
_BLOCK = {"cpu": 1 << 18, "cuda": 1 << 24}


def counter_normal(seed, m: int, n: int, probe: int, device="cpu", row0: int = 0,
                   col0: int = 0) -> torch.Tensor:
    """z ~ N(0, 1) f32 of every element of an [m, n] matrix under key
    ``seed``: Threefry-2x32 on (col, row | probe << 24), then Box–Muller;
    the matrix's element (0, 0) is the whole one's (row0, col0)."""
    k0, k1 = seed
    device = torch.device(device)
    out = torch.empty(m, n, dtype=torch.float32, device=device)
    cols = torch.arange(col0, col0 + n, dtype=torch.int64, device=device).unsqueeze(0)
    step = max(1, _BLOCK[device.type] // n)
    for r0 in range(0, m, step):
        rows = torch.arange(row0 + r0, row0 + min(r0 + step, m), dtype=torch.int64,
                            device=device)
        shape = (rows.numel(), n)
        b0, b1 = jax_random.threefry2x32(k0, k1, cols.expand(shape),
                                         (rows.unsqueeze(1) | (int(probe) << 24)).expand(shape))
        u1 = (b0 >> 8).float() * 2.0**-24 + 2.0**-25
        u2 = (b1 >> 8).float() * 2.0**-24
        r = jax_random.sqrt_rn(-2.0 * jax_random._xla_log(u1))
        out[r0:r0 + shape[0]] = r * cosf(u2 * _TWO_PI)
    return out


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _delta(wf: torch.Tensor, scale: float, z: torch.Tensor, dtype) -> torch.Tensor:
    """round_W(w + scale·z) widened back to f32: the product and the sum
    rounded apart."""
    return (wf + z * scale).to(dtype).float()


def _f32(x) -> float:
    return float(np.float32(x))


def _chain(probes, scales) -> list[tuple[int, float]]:
    probes, scales = tuple(probes), tuple(scales)
    if len(probes) != len(scales):
        raise ValueError(f"{len(probes)} probes for {len(scales)} scales")
    for p in probes:
        if not 0 <= p < MAX_PROBES:
            raise ValueError(f"probe id {p} must fit 8 bits")
    return [(int(p), _f32(s)) for p, s in zip(probes, scales)]


def noise_perturb_plain(w, seed, probes, scales, out=None, offsets=None):
    """The kernel's function in plain PyTorch, one matrix slice at a time."""
    chain = _chain(probes, scales)
    out = w if out is None else out
    m, n = w.shape[-2:]
    *lead_off, row0, col0 = _offsets(w, offsets)
    for idx, s in _slices(tuple(w.shape), seed, tuple(lead_off)):
        wf = w[idx].float()
        for p, sc in chain:
            wf = _delta(wf, sc, counter_normal(s, m, n, p, w.device, row0, col0), w.dtype)
        out[idx].copy_(wf)
    return out


def _hyp(lr, beta1, beta2, eps, decay, q) -> NoiseHyp:
    """The update's scalars as the kernel takes them: f32, with 1 − β
    formed in f32 as the reference forms it from its f32 hyperparameters,
    and f32(1/q)."""
    f = np.float32
    return NoiseHyp(lr, beta1, float(f(1.0) - f(beta1)), beta2, float(f(1.0) - f(beta2)), eps,
                    1.0 if decay is None else decay, 1.0 / q)


def _rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) rounded once to f32 (the kernel's ``__frsqrt_rn``), formed
    in f64."""
    return (1.0 / torch.sqrt(x.double())).float()


def noise_update_plain(w, seed, kappas, variant, lr, beta1=0.0, beta2=0.0, eps=0.0,
                       decay=None, m_buf=None, v_buf=None, restore_probes=(),
                       restore_scales=(), offsets=None):
    """The kernel's function in plain PyTorch; W, M and V in place.  A
    probe that both the restore chain and g read is drawn once per slice
    (the chained step restores its last probe: one draw in four saved)."""
    restore = _chain(restore_probes, restore_scales)
    q = kappas.shape[0]
    h = _hyp(lr, beta1, beta2, eps, decay, q)
    m, n = w.shape[-2:]
    *lead_off, row0, col0 = _offsets(w, offsets)
    for idx, s in _slices(tuple(w.shape), seed, tuple(lead_off)):
        drawn: dict = {}

        def z(p):
            if p not in drawn:
                drawn[p] = counter_normal(s, m, n, p, w.device, row0, col0)
            return drawn[p]

        wf = w[idx].float()
        for p, sc in restore:
            wf = _delta(wf, sc, z(p), w.dtype)
        g = kappas[0] * z(0)
        for p in range(1, q):
            g = g + kappas[p] * z(p)
        step = g * h.inv_q
        if variant != "sgd":
            mm = m_buf[idx] * h.b1 + step * h.omb1
            if variant == "adam":
                vv = v_buf[idx] * h.b2 + (step * h.omb2) * step
                v_buf[idx].copy_(vv)
                m_buf[idx].copy_(mm)
                step = mm * _rsqrt_rn(vv + h.eps)
            else:
                m_buf[idx].copy_(mm)
                step = mm
        w[idx].copy_(wf * h.decay - step * h.lr)
    return _outputs(w, m_buf, v_buf, variant)


def _outputs(w, m_buf, v_buf, variant):
    return (w,) + ((m_buf,) if variant != "sgd" else ()) + ((v_buf,) if variant == "adam" else ())


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _check_leaf(w, seed):
    if w.dim() < 2:
        raise ValueError(f"a noise-kernel leaf has two matrix dims; got {tuple(w.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"W must be f32 or bf16, not {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("W must be contiguous")
    if w.shape[-2] >= MAX_ROWS:
        raise ValueError(f"{w.shape[-2]} rows: the row index must fit 24 bits")
    k0, k1 = seed
    if not (0 <= k0 <= 0xFFFFFFFF and 0 <= k1 <= 0xFFFFFFFF):
        raise ValueError(f"seed {seed} is not two uint32 words")
    *lead, m, n = w.shape
    return LeadDims.of(lead), math.prod(lead), m, n


def noise_perturb(w, seed, probes, scales, out=None, offsets=None):
    """Apply ``scales[i]·z_{probes[i]}`` in chain order to ``w`` (in place,
    or into ``out``) and return the result.  ``seed`` is the leaf key (two
    ints); ``probes`` and ``scales`` are host values; ``offsets`` a shard's
    global origin (one int per dim; None for a whole leaf)."""
    _build.check_chain(len(scales))
    if w.device.type == "cpu":
        return noise_perturb_plain(w, seed, probes, scales, out=out, offsets=offsets)
    if w.device.type != "cuda":
        raise ValueError(f"noise_perturb runs on cuda or cpu, not {w.device}")
    chain = _chain(probes, scales)
    if not chain:
        raise ValueError("noise_perturb needs at least one delta")
    lead, B, m, n = _check_leaf(w, seed)
    out = _check_out(w, out)
    lib = _build.load()
    with torch.cuda.device(w.device):
        err = lib.noise_perturb_fwd(w.data_ptr(), out.data_ptr(), seed[0], seed[1],
                                    NoiseChain.of(chain), lead,
                                    NoiseOffsets.of(_offsets(w, offsets)), B, m, n,
                                    _DTYPES[w.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "noise_perturb_fwd")
    noise_perturb.launches += 1
    return out


noise_perturb.launches = 0


def noise_update(w, seed, kappas, variant, lr, beta1=0.0, beta2=0.0, eps=0.0, decay=None,
                 m_buf=None, v_buf=None, restore_probes=(), restore_scales=(), offsets=None):
    """The fused update of one leaf in place; returns ``(w,)``, ``(w, m)``
    or ``(w, m, v)``.  ``kappas`` is the step's [q] f32 vector on W's
    device; the hyperparameters are host floats; ``offsets`` as
    :func:`noise_perturb`'s."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown update variant {variant!r}; expected one of {VARIANTS}")
    moments = (m_buf,) if variant == "momentum" else (m_buf, v_buf) if variant == "adam" else ()
    for t in moments:
        if t is None or t.shape != w.shape or t.dtype != torch.float32 or t.device != w.device:
            raise ValueError("the moments must be f32 tensors of W's shape and device")
    q = kappas.shape[0]
    if kappas.dim() != 1 or not 1 <= q < MAX_PROBES:
        raise ValueError(f"kappas must be a [q] vector with 1 <= q < {MAX_PROBES}")
    _build.check_chain(len(restore_scales))
    if w.device.type == "cpu":
        return noise_update_plain(w, seed, kappas, variant, lr, beta1, beta2, eps, decay,
                                  m_buf, v_buf, restore_probes, restore_scales, offsets)
    if w.device.type != "cuda":
        raise ValueError(f"noise_update runs on cuda or cpu, not {w.device}")
    restore = _chain(restore_probes, restore_scales)
    lead, B, m, n = _check_leaf(w, seed)
    for t in moments + (kappas,):
        if not t.is_contiguous() or t.device != w.device or t.dtype != torch.float32:
            raise ValueError("kappas and the moments must be contiguous f32 on W's device")
    m_ptr = None if m_buf is None else m_buf.data_ptr()
    v_ptr = None if v_buf is None else v_buf.data_ptr()
    lib = _build.load()
    with torch.cuda.device(w.device):
        err = lib.noise_update_fwd(w.data_ptr(), m_ptr, v_ptr, kappas.data_ptr(), q,
                                   seed[0], seed[1], NoiseChain.of(restore),
                                   _hyp(lr, beta1, beta2, eps, decay, q), lead,
                                   NoiseOffsets.of(_offsets(w, offsets)),
                                   VARIANTS.index(variant), B, m, n, _DTYPES[w.dtype],
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(err, "noise_update_fwd")
    noise_update.launches += 1
    return _outputs(w, m_buf, v_buf, variant)


noise_update.launches = 0
