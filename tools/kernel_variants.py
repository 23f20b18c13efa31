#!/usr/bin/env python3
"""Variants of the port's redesigned weight kernels, built from edited
copies of their sources and measured beside the real build on one card.

    python3 tools/kernel_variants.py            # from the root of a checkout, on a card

There is no ``ncu`` on the card's machine, so a design choice is measured by
taking it out: each variant below is the kernel's source with a few
statements replaced (the edits must apply, or the script stops), built with
nvcc into ``build/kernel_variants/`` and loaded beside the real library.

quant_matmul (bf16 x, lut4 unless stated, M = 1024 rows):
  one_level   each group's products go straight into the running sum
              (no second f32 register sum);
  two_part    the weight as hi + mid only; one_part  as hi only;
  no_mma      the products replaced by a cheap use of the same operands;
  no_lut      the lookups replaced by the code words themselves.
Each is held against the bf16 bar of chip_smoke.py's phase 2 (within 2 bf16
ulps + 1e-5 of the f32 plain version) at the forward's three shapes for
nf4, lut3 and lut4: ``bar_ratio`` is the largest error over its bar (> 1
fails).  Then every variant's time for one lut4 layer forward (six calls).

tezo_perturb (bf16, r = 24, k = 1, over full-width opt-125m's ten low-rank
leaves): no_product (the deltas are zeros: the W stream alone) and
no_stream (W neither loaded nor stored: the factors and products alone).

Times are device time per call (chip_smoke.timed); the card's name and power
limit lead the output.  The variants are measurements only: nothing in the
port runs them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

QMM_VARIANTS = {
    "one_level": [("mma_bf16(gacc[mb][nb], a[mb]", "mma_bf16(acc[mb][nb], a[mb]"),
                  ("acc[mb][nb][e] = __fadd_rn(acc[mb][nb][e], gacc[mb][nb][e]);", ";")],
    "two_part": [("for (int p = 0; p < 3; ++p)", "for (int p = 0; p < 2; ++p)")],
    "one_part": [("for (int p = 0; p < 3; ++p)", "for (int p = 0; p < 1; ++p)")],
    "no_mma": [("for (int nb = 0; nb < 2; ++nb) mma_bf16(gacc[mb][nb], a[mb], bp[p][nb][0], "
                "bp[p][nb][1]);",
                "for (int nb = 0; nb < 2; ++nb) gacc[mb][nb][0] += "
                "__uint_as_float((a[mb][0] ^ bp[p][nb][0]) & 0x3fffffu);")],
    "no_lut": [("e[j] = lut0[nb * kLutNb + 4 * static_cast<int>(cw[nb][j] & MASK)];",
                "e[j] = make_uint2(cw[nb][j], cw[nb][j] >> 16);")],
}
TEZO_VARIANTS = {
    "no_product": [("      tezo::rank_fma(z, sm, jn);", "")],
    "no_stream": [("  tezo::stage_w_tile(ws, w + b * mn, t, vec);", "  cp_async_commit();"),
                  ("  tezo::store_w_tile(out + b * mn, ws, t, vec);", "")],
}


def build(name: str, source: str, edits: list) -> ctypes.CDLL:
    """The edited copy of csrc/<source>.cu as its own shared library."""
    from repro_torch.kernels import _build

    csrc = ROOT / "src" / "repro_torch" / "csrc"
    text = (csrc / f"{source}.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in {source}.cu")
        text = text.replace(old, new)
    out = ROOT / "build" / "kernel_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "common.cuh").write_text((csrc / "common.cuh").read_text())
    (out / f"{source}.cu").write_text(text)
    so = out / f"{name}.so"
    cmd = [_build._nvcc(), *_build._ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
           "-o", str(so), str(out / f"{source}.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"variant {name} does not build:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("quant_matmul_fwd", "tezo_perturb_fwd"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
    return lib


def qmm_call(lib, x, leaf, lut, xu):
    out = torch.empty((x.shape[0], leaf.codes.shape[1]), dtype=x.dtype, device=x.device)
    err = lib.quant_matmul_fwd(x.data_ptr(), leaf.codes.data_ptr(), lut.data_ptr(),
                               xu.data_ptr(), leaf.qv.data_ptr(), out.data_ptr(), x.shape[0],
                               x.shape[1], leaf.codes.shape[0], leaf.codes.shape[1],
                               leaf.qv.shape[1], leaf.bits, 1,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"quant_matmul_fwd: cudaError {err}")
    return out


def main() -> int:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.estimator import ZOConfig
    from repro_torch.core.zo_step import init_zo_state
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models import build_model
    from repro_torch.utils.jax_random import PRNGKey
    from repro_torch.utils.tree import flatten_with_path

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    real = _build.load()
    qlibs = {"main": real, **{n: build(n, "quant_matmul", e) for n, e in QMM_VARIANTS.items()}}
    tlibs = {"main": real, **{n: build(n, "tezo_perturb", e) for n, e in TEZO_VARIANTS.items()}}

    def bar_ratio(got, ref):
        _, e = torch.frexp(ref.abs())
        ulp = torch.ldexp(torch.ones_like(ref), e - 8)
        return ((got.float() - ref).abs() / (2 * ulp + 1e-5)).max().item()

    for i, (K, N) in enumerate(cs.QMM_SHAPES):
        for scheme in ("nf4", "lut3", "lut4"):
            leaf = cs._qmm_leaf(K, N, scheme, dev, 70 + i)
            x = cs.drandn((cs.QMM_M, K), 80 + i, dev, dtype=torch.bfloat16)
            lut = quant.scaled_lut(leaf)
            xu = x.float() @ (leaf.qu * leaf.acc)
            ref = qm.quant_matmul_plain(x.float(), leaf.codes, lut, xu, leaf.qv, bits=leaf.bits)
            row = {n: bar_ratio(qmm_call(lib, x, leaf, lut, xu), ref)
                   for n, lib in qlibs.items() if n not in ("no_mma", "no_lut")}
            print(json.dumps({"kernel": "quant_matmul", "scheme": scheme, "M": cs.QMM_M, "K": K,
                              "N": N, "bar_ratio": row}), flush=True)

    layer = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    ops = []
    for i, (K, N) in enumerate(layer):
        leaf = cs._qmm_leaf(K, N, "lut4", dev, 100 + i)
        x = cs.drandn((cs.QMM_M, K), 110 + i, dev, dtype=torch.bfloat16)
        ops.append((x, leaf, quant.scaled_lut(leaf), x.float() @ (leaf.qu * leaf.acc)))
    for name, lib in qlibs.items():
        t = cs.timed(lambda lib=lib: [qmm_call(lib, *o) for o in ops], 30)
        print(json.dumps({"kernel": "quant_matmul", "variant": name,
                          "unit": "lut4 layer forward (six calls)", "us": t["ms"] * 1e3,
                          "timer": t["timer"]}), flush=True)

    model = build_model(get_config("opt-125m"), dev)
    state = init_zo_state(model.init(PRNGKey(0)), ZOConfig(method="tezo_adam", rank=24))
    params = dict(flatten_with_path(state.params))
    leaves = []
    for i, (path, f) in enumerate(sorted(state.mstate["factors"].items())):
        w = params[path].clone()
        leaves.append((w, f.u, f.v, cs.drandn((*f.batch, 1, f.rank), 100 + i, dev), f.rank))
    chain = _build.DeltaChain.of([cs.TRAIN_RHO], [1.0])

    def tezo_pass(lib):
        for w, u, v, tau, r in leaves:
            *b, m, n = w.shape
            err = lib.tezo_perturb_fwd(w.data_ptr(), w.data_ptr(), u.data_ptr(), v.data_ptr(),
                                       tau.data_ptr(), chain, max(1, w.numel() // (m * n)), m,
                                       n, r, 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"tezo_perturb_fwd: cudaError {err}")

    for name, lib in tlibs.items():
        t = cs.timed(lambda lib=lib: tezo_pass(lib), 30)
        print(json.dumps({"kernel": "tezo_perturb", "variant": name,
                          "unit": "k = 1 pass over the 10 low-rank leaves", "us": t["ms"] * 1e3,
                          "timer": t["timer"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
