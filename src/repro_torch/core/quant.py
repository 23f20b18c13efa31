"""Quantized weight leaves: SqueezeLLM-style per-channel LUT quantization
(counterpart of ``repro.core.quant``).

ZO fine-tuning needs no backward pass, so the frozen base weights never
need gradients: they can live in device memory as 3/4-bit LUT-quantized
blocks while every trainable quantity stays f32.  This module owns the leaf
type and the pack/quantize math; the compute on quantized leaves lives in
``core.dispatch`` (the leaf-op protocol) and ``kernels.quant_matmul`` (the
fused in-tile dequant matmul).

Representation (one :class:`QuantLeaf` replaces one dense ``[..., K, N]``
leaf), the reference's fields:

* ``codes``     uint32 ``[..., Kw, N]``: plane-strided packed b-bit codes,
  ``cpw = 32 // bits`` codes per word.  Word row ``i`` packs dense rows
  ``{s·Kw + i : s < cpw}`` at bit offset ``b·s`` (a C-order reshape of the
  padded ``[Kp, N]`` code matrix to ``[cpw, Kw, N]``).
* ``codebook``  f32 ``[..., N, 2**bits]``: per-output-channel LUT in
  normalized units (nf4: the fixed NormalFloat table; lut3/lut4:
  per-channel quantiles of w/scale).
* ``scale``     f32 ``[..., N]``: per-channel absmax.  Dequant of code ``c``
  in channel ``n`` is ``scale[n] · codebook[n, c]``.
* ``qu, qv``    f32 ``[..., K, r]`` / ``[..., N, r]``: the frozen CPD
  factors, drawn with the streams ``cpd.init_factors`` uses for the dense
  leaf, so a quantized run perturbs with the dense run's Z.
* ``acc``       f32 ``[..., r]``: the accumulated temporal coefficient, the
  leaf's whole mutable state for the TeZO family:
  ``W_eff = dequant(codes) + (qu · diag(acc)) @ qvᵀ``.
* ``nacc``      optional dense ``[..., K, N]`` in the weight dtype: the
  accumulated MeZO-style delta, present only for the MeZO family.

K is zero-padded to a multiple of ``lcm(cpw, 128)`` before packing (pad
rows carry code 0; the matmul reads zero activations over them).

``codes`` is a ``torch.uint32`` tensor (the reference's dtype, so bridges
and checkpoints carry it as is); the bit arithmetic runs on int64 views,
since torch's uint32 has no shifts.

Quantile fit.  ``torch.quantile`` does not round as ``jnp.quantile`` does:
on a ``[12, 768, 768]`` normalized leaf 12-13% of the lut3/lut4 codebook
entries differ by one f32 ulp, which can flip a code at a near-tie.
:func:`_quantile_rows` replays jax 0.9's ``_quantile`` as XLA:CPU runs it
(sort, ``q·(n−1)`` in f32, floor/ceil weights, and the low product fused
into the add as one fma, emulated in f64), so codebooks and codes are
bitwise the reference's on either device.

A QuantLeaf is an atomic leaf for the port's path walks
(``utils.tree.register_atomic_leaf``): the factor table, the noise keys and
dispatch address it by the path of the dense leaf it replaced.  Storage
walks (checkpoints) descend into its tensor fields, under the keys JAX's
flattening gives them (``['blocks']['wq'].codes``); its meta fields ride
the template.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.utils import jax_random
from repro_torch.utils.tree import fold_in_path, map_with_path, register_atomic_leaf

# scheme name -> code width in bits
SCHEMES = {"nf4": 4, "lut3": 3, "lut4": 4}

# methods whose update path composes with quantized leaves: the TeZO family
# writes τ-space (acc), the MeZO family writes the dense nacc buffer.
# LOZO/SubZO lazily rewrite U/V against dense W and are excluded.
QUANT_METHODS = ("tezo", "tezo_m", "tezo_adam", "mezo", "mezo_m", "mezo_adam")
NOISE_QUANT_METHODS = ("mezo", "mezo_m", "mezo_adam")

# transformer block weights eligible for quantization
QUANT_FIELDS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# QLoRA's NormalFloat-4 table: quantiles of N(0, 1) rescaled to [-1, 1].
NF4_TABLE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_META = {"static": True}  # a meta field: not a tensor, not walked by storage


def codes_per_word(bits: int) -> int:
    return 32 // bits


def pack_align(bits: int) -> int:
    """Row-count multiple K is padded to before packing: integral words
    (cpw | Kp) and a 128-aligned x tile (128 | Kp)."""
    return math.lcm(codes_per_word(bits), 128)


def packed_rows(k: int, bits: int) -> tuple[int, int]:
    """(Kp, Kw): padded dense rows and packed word rows for a K-row leaf."""
    align = pack_align(bits)
    kp = ((k + align - 1) // align) * align
    return kp, kp // codes_per_word(bits)


@dataclass(frozen=True)
class QuantLeaf:
    codes: torch.Tensor  # uint32 [..., Kw, N]
    codebook: torch.Tensor  # f32 [..., N, 2**bits], normalized
    scale: torch.Tensor  # f32 [..., N]
    qu: torch.Tensor  # f32 [..., K, r]
    qv: torch.Tensor  # f32 [..., N, r]
    acc: torch.Tensor  # f32 [..., r]
    nacc: Optional[torch.Tensor]  # weight-dtype [..., K, N] or None
    bits: int = field(metadata=_META)
    k_dim: int = field(metadata=_META)
    dtype_name: str = field(metadata=_META)
    qmethod: str = field(metadata=_META)

    # --- logical dense view ------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.codes.shape[:-2]) + (self.k_dim, self.codes.shape[-1])

    @property
    def ndim(self) -> int:
        return self.codes.dim()

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype_name]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        return self.qu.shape[-1]

    def replace(self, **kw) -> "QuantLeaf":
        return dataclasses.replace(self, **kw)

    def __getitem__(self, i) -> "QuantLeaf":
        """The leaf's slice ``i`` along its leading (layer) dim: every tensor
        field indexed, the meta fields kept."""
        if self.codes.dim() < 3:
            raise IndexError("a single-matrix QuantLeaf has no leading dim to index")
        return self.replace(**{f: getattr(self, f)[i] for f in TENSOR_FIELDS
                               if getattr(self, f) is not None})


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(QuantLeaf)
                      if not f.metadata.get("static"))
register_atomic_leaf(QuantLeaf)


# --- pack / unpack ---------------------------------------------------------


def _to_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the uint32 tensor of the same bits."""
    signed = torch.where(words >= 2**31, words - 2**32, words)
    return signed.to(torch.int32).view(torch.uint32)


def _word_bits(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> int64 values in [0, 2**32)."""
    return words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., K, N] integer codes -> uint32 [..., Kw, N] plane-strided words."""
    cpw = codes_per_word(bits)
    k, n = codes.shape[-2], codes.shape[-1]
    kp, kw = packed_rows(k, bits)
    c = torch.nn.functional.pad(codes.to(torch.int64), (0, 0, 0, kp - k))
    planes = c.reshape(tuple(c.shape[:-2]) + (cpw, kw, n))
    word = torch.zeros(tuple(c.shape[:-2]) + (kw, n), dtype=torch.int64, device=codes.device)
    for s in range(cpw):
        word = word | (planes[..., s, :, :] << (bits * s))
    return _to_uint32(word)


def unpack_codes(words: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """uint32 [..., Kw, N] -> int32 [..., K, N] codes (crops the pack pad)."""
    cpw = codes_per_word(bits)
    w = _word_bits(words)
    mask = (1 << bits) - 1
    codes = torch.cat([(w >> (bits * s)) & mask for s in range(cpw)], dim=-2)
    return codes[..., :k, :].to(torch.int32)


def scaled_lut(leaf: QuantLeaf) -> torch.Tensor:
    """Per-channel dequant table in weight units: f32 [..., N, 2**bits]."""
    return leaf.codebook * leaf.scale[..., :, None]


def dequantize(leaf: QuantLeaf) -> torch.Tensor:
    """Dense reconstruction of the frozen quantized base, in the leaf's
    dtype (without the acc/nacc deltas: see :func:`effective_weight`)."""
    codes = unpack_codes(leaf.codes, leaf.bits, leaf.k_dim)  # [..., K, N]
    lut = scaled_lut(leaf)  # [..., N, L]
    w = torch.gather(lut, -1, codes.transpose(-1, -2).to(torch.int64))  # [..., N, K]
    return w.transpose(-1, -2).to(leaf.dtype)


def effective_weight(leaf: QuantLeaf) -> torch.Tensor:
    """Dense ``W_eff = dequant(codes) + (qu·diag(acc))@qvᵀ [+ nacc]``, the
    weight the forward computes against, materialized (a test oracle only:
    the forward never builds it)."""
    w = dequantize(leaf).float()
    ut = leaf.qu * leaf.acc[..., None, :]
    w = w + torch.matmul(ut, leaf.qv.transpose(-1, -2))
    if leaf.nacc is not None:
        w = w + leaf.nacc.float()
    return w.to(leaf.dtype)


# --- quantization ----------------------------------------------------------


def _quantile_rows(wn: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(wn, qs, axis=-2)`` (method "linear") as XLA:CPU runs
    jax 0.9's ``_quantile``, moved to [..., N, L]: sort along K; ``q·(n−1)``
    in f32; low = floor, high = ceil, ``hw = q − low``, ``lw = 1 − hw``;
    then ``fma(low_value, lw, f32(high_value·hw))``, the product XLA:CPU
    fuses into the add, emulated in f64 (the product of two f32 values is
    exact there)."""
    n = wn.shape[-2]
    a = torch.sort(wn, dim=-2).values
    q = qs * torch.tensor(float(n - 1), dtype=torch.float32)
    low = torch.floor(q)
    high = torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo_i = torch.clamp(low, 0, n - 1).to(torch.int64).to(wn.device)
    hi_i = torch.clamp(high, 0, n - 1).to(torch.int64).to(wn.device)
    lo_v = a.index_select(-2, lo_i)  # [..., L, N]
    hi_v = a.index_select(-2, hi_i)
    lw = lw.to(wn.device)[:, None]
    hw = hw.to(wn.device)[:, None]
    hi_p = hi_v * hw  # rounded to f32, as XLA leaves it
    out = (lo_v.double() * lw.double() + hi_p.double()).float()
    return out.transpose(-1, -2).contiguous()


def _channel_codebook(wn: torch.Tensor, bits: int, scheme: str) -> torch.Tensor:
    """Normalized per-channel LUT for ``wn = w / scale`` [..., K, N]: nf4 the
    fixed NormalFloat table, lut3/lut4 per-channel quantiles."""
    n = wn.shape[-1]
    batch = tuple(wn.shape[:-2])
    levels = 1 << bits
    if scheme == "nf4":
        table = torch.tensor(NF4_TABLE, dtype=torch.float32, device=wn.device)
        return table.expand(batch + (n, levels)).contiguous()
    qs = (torch.arange(levels, dtype=torch.float32) + 0.5) / levels
    return _quantile_rows(wn, qs)


def _assign_codes(wn: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-entry assignment, streamed over the (<= 16) LUT entries so
    the [..., K, N, L] distance tensor is never materialized; the first of
    equally near entries wins, as in the reference."""
    levels = codebook.shape[-1]
    best = torch.full(wn.shape, math.inf, dtype=torch.float32, device=wn.device)
    codes = torch.zeros(wn.shape, dtype=torch.int32, device=wn.device)
    for j in range(levels):
        err = torch.abs(wn - codebook[..., j][..., None, :])
        better = err < best
        best = torch.where(better, err, best)
        codes = torch.where(better, j, codes)
    return codes


def quantize_leaf(w: torch.Tensor, *, scheme: str, rank: int, key, path: str,
                  with_nacc: bool = False) -> QuantLeaf:
    """Quantize one dense [..., K, N] leaf on its device.  qu/qv are drawn
    from ``fold_in_path(key, path + "#u"/"#v")``, the streams
    ``cpd.init_factors`` uses for this path."""
    bits = SCHEMES[scheme]
    k, n = w.shape[-2], w.shape[-1]
    batch = tuple(w.shape[:-2])
    wf = w.float()
    scale = torch.clamp_min(torch.amax(torch.abs(wf), dim=-2), 1e-8)  # [..., N]
    wn = wf / scale[..., None, :]
    codebook = _channel_codebook(wn, bits, scheme)
    codes = pack_codes(_assign_codes(wn, codebook), bits)
    r = max(1, min(rank, k, n))
    qu = jax_random.normal(fold_in_path(key, path + "#u"), batch + (k, r), w.device)
    qv = jax_random.normal(fold_in_path(key, path + "#v"), batch + (n, r), w.device)
    acc = torch.zeros(batch + (r,), dtype=torch.float32, device=w.device)
    nacc = torch.zeros_like(w) if with_nacc else None
    dtype_name = {v: k for k, v in _DTYPES.items()}[w.dtype]
    return QuantLeaf(codes=codes, codebook=codebook, scale=scale, qu=qu, qv=qv, acc=acc,
                     nacc=nacc, bits=bits, k_dim=k, dtype_name=dtype_name, qmethod=scheme)


def is_quant_target(path: str, leaf: Any) -> bool:
    """Transformer block matmul weights only: stacked [L, K, N] leaves whose
    field name is in QUANT_FIELDS."""
    if isinstance(leaf, QuantLeaf) or getattr(leaf, "ndim", 0) != 3:
        return False
    if min(leaf.shape[-2:]) < 8:
        return False
    return any(path.endswith(f"['{f}']") for f in QUANT_FIELDS)


def quantize_params(params: Any, *, scheme: str, rank: int, key,
                    with_nacc: bool = False) -> Any:
    """Replace every eligible dense leaf with a QuantLeaf; other leaves pass
    through untouched.  The dense leaf is freed as its QuantLeaf replaces
    it (the caller's tree still holds it until it lets go)."""
    hit = []

    def q(path: str, leaf: Any) -> Any:
        if not is_quant_target(path, leaf):
            return leaf
        hit.append(path)
        return quantize_leaf(leaf, scheme=scheme, rank=rank, key=key, path=path,
                             with_nacc=with_nacc)

    out = map_with_path(q, params)
    if not hit:
        raise ValueError(
            f"weight_quant={scheme!r} matched no leaves: quantization covers "
            f"transformer block weights {QUANT_FIELDS} (stacked [L, K, N]); "
            "this parameter tree has none"
        )
    return out


def validate_quant_config(cfg) -> None:
    """Eager compatibility checks for ``ZOConfig.weight_quant``, with the
    reference's messages."""
    if cfg.weight_quant == "none":
        return
    if cfg.weight_quant not in SCHEMES:
        raise ValueError(
            f"weight_quant={cfg.weight_quant!r}: expected one of "
            f"{('none',) + tuple(SCHEMES)}"
        )
    if cfg.method not in QUANT_METHODS:
        raise ValueError(
            f"weight_quant={cfg.weight_quant!r} supports methods "
            f"{QUANT_METHODS}; got {cfg.method!r} (LOZO/SubZO lazily rewrite "
            "factors against dense W and do not compose with packed leaves)"
        )
    if cfg.weight_decay:
        raise ValueError(
            "weight_quant with weight_decay != 0 is unsupported: decay "
            "multiplies the frozen packed base, which the factor-space "
            "update path cannot express"
        )
    if getattr(cfg, "rank_mode", "const") == "spectral":
        raise ValueError(
            "weight_quant with rank_mode='spectral' is unsupported: spectral "
            "rank selection inspects dense W at init"
        )
    factor_dtype = str(getattr(cfg, "factor_dtype", "float32"))
    if factor_dtype not in ("float32", "torch.float32"):
        raise ValueError(
            "weight_quant requires factor_dtype=float32: quantized leaves "
            "carry their qu/qv in f32, and jax.random.normal draws different "
            f"bits per dtype (got factor_dtype={factor_dtype})"
        )


def quantize_for_config(params: Any, cfg, key) -> Any:
    """The init-time hook ``zo_step.init_zo_state`` calls: validate the
    config and quantize the eligible leaves."""
    validate_quant_config(cfg)
    if cfg.weight_quant == "none":
        return params
    return quantize_params(params, scheme=cfg.weight_quant, rank=cfg.rank, key=key,
                           with_nacc=cfg.method in NOISE_QUANT_METHODS)


# --- storage accounting ----------------------------------------------------


def code_bytes_per_element(scheme: str) -> float:
    """Packed-code bytes per dense weight element (4-byte words / cpw)."""
    return 4.0 / codes_per_word(SCHEMES[scheme])


def stored_weight_bytes(leaf: QuantLeaf) -> int:
    """Bytes this leaf stores in place of the dense weight: packed codes +
    codebook + scale (+ nacc when present); qu/qv are excluded (the CPD
    factor state a dense TeZO run carries too)."""
    n = leaf.codes.numel() * 4 + leaf.codebook.numel() * 4 + leaf.scale.numel() * 4
    if leaf.nacc is not None:
        n += leaf.nacc.numel() * leaf.nacc.element_size()
    return n


def dense_weight_bytes(leaf: Any) -> int:
    """Dense-equivalent storage of any leaf (QuantLeaf: its logical view)."""
    itemsize = torch.empty((), dtype=leaf.dtype).element_size()
    return math.prod(leaf.shape) * itemsize
