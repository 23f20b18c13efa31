"""Fused LUT-dequant matmul for quantized weight leaves: the hand-written
CUDA kernel and its plain PyTorch version.

    out = x @ LUT-dequant(codes) + xu @ qvᵀ

Replaces the TPU kernel ``repro/kernels/quant_matmul.py::quant_matmul``
(through ``repro.kernels.ops.quant_matmul``).  The packed b-bit codes are
the only weight-sized operand the kernel reads (``csrc/quant_matmul.cu``),
so the dense weight never reaches device memory.  With bf16 x (the
training forward) it runs on the tensor cores: each block splits its
columns of the scaled LUT into three bf16 parts whose sum is the f32 entry
exactly (:func:`lut_parts`), dequantizes a code by looking up its three
parts, and sums ``x·hi + x·mid + x·lo`` in f32, walking K one group of
word rows at a time with every plane of the group unpacked from the same
words and planes past K skipped.  With f32 x it accumulates f32 FMAs on the
CUDA cores.  Both add ``xu @ qvᵀ`` (the temporal-factor delta, ``xu =
x @ (qu·acc)`` formed by the caller) in f32 in the epilogue and round once.
See the source for the design and what bounds it.

Padding: ``codes`` covers ``Kp = cpw·Kw`` dense rows, K padded to a
multiple of ``lcm(cpw, 128)`` with code 0.  ``x`` may have its true K
columns: the kernel (and the plain version) read zeros past them, which is
the padding ``repro.kernels.ops`` materialises, so the pad rows' codes
multiply zeros, whatever they are.

On a CPU tensor :func:`quant_matmul` runs :func:`quant_matmul_plain`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant import unpack_codes
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 256  # the epilogue's xu / qv columns
GROUP_ROWS = 16  # csrc/quant_matmul.cu tc::kBK: packed word rows per K group
# the bf16 blocks the forward launches, (warps along M, warps along N, m16
# tiles per warp): csrc/quant_matmul.cu default_tile takes TILE_WIDE where
# its grid fits one block per SM, else TILE (code 100·WM + 10·WN + MT)
TILE_WIDE, TILE = (1, 6, 4), (1, 4, 4)
# the blocks quant_matmul_tile times
TILE_CHOICES = [(1, 3, 4), (1, 4, 4), (1, 6, 4), (1, 8, 4)]


def lut_parts(lut: torch.Tensor) -> tuple:
    """The bf16 kernel's split of a scaled LUT: ``hi = bf16(W)``, ``mid =
    bf16(W − hi)``, ``lo = bf16(W − hi − mid)``, each rounded to nearest
    even; ``hi + mid + lo`` is W exactly."""
    w = lut.float()
    hi = w.to(torch.bfloat16)
    r1 = w - hi.float()
    mid = r1.to(torch.bfloat16)
    return hi, mid, (r1 - mid.float()).to(torch.bfloat16)


def quant_matmul_plain(x, codes, lut, xu, qv, *, bits: int):
    """The kernel's function in plain PyTorch: unpack every code, look it up
    in its column's LUT, one f32 matmul over the (zero-padded) x, plus
    ``xu @ qvᵀ``.  x [M, K <= Kp] -> [M, N] in x's dtype."""
    kw, n = codes.shape
    kp = kw * (32 // bits)
    c = unpack_codes(codes, bits, kp).to(torch.int64)  # [Kp, N]
    w = torch.gather(lut.float().t(), 0, c)  # w[k, n] = lut[n, c[k, n]]
    xf = F.pad(x.float(), (0, kp - x.shape[-1]))
    out = torch.matmul(xf, w) + torch.matmul(xu.float(), qv.float().t())
    return out.to(x.dtype)


def _check(x, codes, lut, xu, qv, bits):
    if bits not in (3, 4):
        raise ValueError(f"bits must be 3 or 4, not {bits}")
    if x.dim() != 2 or codes.dim() != 2 or lut.dim() != 2 or xu.dim() != 2 or qv.dim() != 2:
        raise ValueError("quant_matmul takes x [M,K], codes [Kw,N], lut [N,L], xu [M,r], "
                         "qv [N,r]")
    M, K = x.shape
    kw, N = codes.shape
    r = qv.shape[1]
    if K > kw * (32 // bits):
        raise ValueError(f"x has {K} columns; codes [{kw}, {N}] cover {kw * (32 // bits)}")
    if kw % GROUP_ROWS:
        raise ValueError(f"packed rows {kw} must be a multiple of {GROUP_ROWS} (K padded "
                         "to lcm(cpw, 128))")
    if tuple(lut.shape) != (N, 1 << bits):
        raise ValueError(f"lut {tuple(lut.shape)} must be [{N}, {1 << bits}]")
    if tuple(xu.shape) != (M, r) or qv.shape[0] != N or r > MAX_RANK:
        raise ValueError(f"xu {tuple(xu.shape)} / qv {tuple(qv.shape)} do not fit "
                         f"[{M}, r] / [{N}, r], r <= {MAX_RANK}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be f32 or bf16, not {x.dtype}")
    if codes.dtype != torch.uint32:
        raise TypeError(f"codes must be uint32, not {codes.dtype}")
    for name, t in (("lut", lut), ("xu", xu), ("qv", qv)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be f32, not {t.dtype}")
    for name, t in (("x", x), ("codes", codes), ("lut", lut), ("xu", xu), ("qv", qv)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return M, K, kw, N, r


def _launch(x, codes, lut, xu, qv, bits, tile):
    M, K, kw, N, r = _check(x, codes, lut, xu, qv, bits)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.load()
    args = (x.data_ptr(), codes.data_ptr(), lut.data_ptr(), xu.data_ptr(), qv.data_ptr(),
            out.data_ptr(), M, K, kw, N, r, bits)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tile is None:
            err, entry = lib.quant_matmul_fwd(*args, _DTYPES[x.dtype], stream), \
                "quant_matmul_fwd"
        else:
            err, entry = lib.quant_matmul_fwd_tile(*args, tile, stream), "quant_matmul_fwd_tile"
    _build.check(err, entry)
    return out


def quant_matmul(x, codes, lut, xu, qv, *, bits: int):
    """``x @ dequant(codes) + xu @ qvᵀ``: x [M, K] f32/bf16 (K up to the
    codes' Kp rows), codes uint32 [Kw, N] plane-packed, lut f32 [N, 2**bits]
    scaled, xu f32 [M, r], qv f32 [N, r] -> [M, N] in x's dtype."""
    _build.forbid_autograd("quant_matmul", x, lut, xu, qv)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, codes, lut, xu, qv, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x.device}")
    out = _launch(x, codes, lut, xu, qv, bits, None)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


def quant_matmul_tile(x, codes, lut, xu, qv, *, bits: int, tile: tuple):
    """The bf16 kernel with another block (one of ``TILE_CHOICES``): for
    timing the choice of ``TILE``.  The forward calls :func:`quant_matmul`;
    this launch is not counted."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("quant_matmul_tile times the bf16 kernel on a CUDA tensor")
    if tuple(tile) not in TILE_CHOICES:
        raise ValueError(f"{tile} is not one of {TILE_CHOICES}")
    wm, wn, mt = tile
    return _launch(x, codes, lut, xu, qv, bits, 100 * wm + 10 * wn + mt)
