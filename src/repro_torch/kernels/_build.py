"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc`` per source, all
started together) and linked into one shared library with a plain C
interface, loaded with ``ctypes`` — a build of seconds, where a PyTorch
extension that includes the torch headers takes minutes.  The library lands
in ``build/repro_torch/`` under the checkout, named by a hash of the sources
and flags, at first use: no binary is committed and nothing is built when a
module is imported.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_longlong
MAX_CHAIN = 8  # csrc/common.cuh kMaxChain
MAX_LEAD = 4  # csrc/zo_noise.cuh kMaxLead


class DeltaChain(ctypes.Structure):
    """``repro_torch::DeltaChain`` (csrc/common.cuh), passed by value: the
    scales and decays of up to MAX_CHAIN rank-r deltas."""

    _fields_ = [("scale", _F * MAX_CHAIN), ("decay", _F * MAX_CHAIN), ("k", _I)]

    @classmethod
    def of(cls, scales, decays) -> "DeltaChain":
        if len(scales) != len(decays) or len(scales) > MAX_CHAIN:
            raise ValueError(f"a chain holds at most {MAX_CHAIN} deltas; got "
                             f"{len(scales)} scales and {len(decays)} decays")
        ch = cls()
        ch.k = len(scales)
        for i, (s, d) in enumerate(zip(scales, decays)):
            ch.scale[i], ch.decay[i] = float(s), float(d)
        return ch


class FactorList(ctypes.Structure):
    """``repro_torch::FactorList`` (csrc/common.cuh), passed by value: the
    device pointers of up to MAX_CHAIN f32 factors, one per delta."""

    _fields_ = [("p", _P * MAX_CHAIN)]

    @classmethod
    def of(cls, tensors) -> "FactorList":
        if len(tensors) > MAX_CHAIN:
            raise ValueError(f"a chain holds at most {MAX_CHAIN} deltas; got {len(tensors)}")
        fl = cls()
        for i, t in enumerate(tensors):
            fl.p[i] = t.data_ptr()
        return fl


class NoiseChain(ctypes.Structure):
    """``repro_torch::noise::NoiseChain`` (csrc/zo_noise.cuh), by value."""

    _fields_ = [("scale", _F * MAX_CHAIN), ("probe", _I * MAX_CHAIN), ("k", _I)]

    @classmethod
    def of(cls, chain) -> "NoiseChain":
        if len(chain) > MAX_CHAIN:
            raise ValueError(f"a chain holds at most {MAX_CHAIN} deltas; got {len(chain)}")
        ch = cls()
        ch.k = len(chain)
        for i, (p, s) in enumerate(chain):
            ch.probe[i], ch.scale[i] = p, s
        return ch


class LeadDims(ctypes.Structure):
    """``repro_torch::noise::LeadDims``: a leaf's leading dims, by value."""

    _fields_ = [("dim", _I * MAX_LEAD), ("n", _I)]

    @classmethod
    def of(cls, dims) -> "LeadDims":
        if len(dims) > MAX_LEAD:
            raise ValueError(f"a leaf has at most {MAX_LEAD} leading dims; got {len(dims)}")
        ld = cls()
        ld.n = len(dims)
        for i, d in enumerate(dims):
            ld.dim[i] = d
        return ld


class NoiseHyp(ctypes.Structure):
    """``repro_torch::NoiseHyp`` (csrc/noise_update.cu), by value; its
    fields read back as the f32 values the kernel gets."""

    _fields_ = [(name, _F) for name in ("lr", "b1", "omb1", "b2", "omb2", "eps", "decay", "inv_q")]


# C signatures: name -> argtypes (restype is int, the cudaError_t)
_SIGNATURES = {
    # q, k, v, out, B, S, T, H, KV, dh, q_offset, window, causal, scale,
    # dtype (0 f32 / 1 bf16), stream
    "flash_attention_fwd": [_P, _P, _P, _P] + [_I] * 9 + [_F, _I, _P],
    # the same with the bf16 q-tile's warps before the stream
    "flash_attention_fwd_warps": [_P, _P, _P, _P] + [_I] * 9 + [_F, _I, _I, _P],
    # q, k_pages, v_pages, block_tables, lengths, out, workspace, its floats,
    # S, H, KV, dh, page_size, pages_per_slot, scale, q dtype, pages dtype,
    # stream
    "paged_decode_attention_fwd": [_P] * 7 + [_L] + [_I] * 6 + [_F, _I, _I, _P],
    # the same with the window length T after S
    "paged_verify_attention_fwd": [_P] * 7 + [_L] + [_I] * 7 + [_F, _I, _I, _P],
    # x, dt, a, b, c, h0, y, h_last, B, S, D, N, stream
    "selective_scan_fwd": [_P] * 8 + [_I] * 4 + [_P],
    # x, codes, lut, xu, qv, out, M, K, Kw, N, r, bits, x dtype, stream
    "quant_matmul_fwd": [_P] * 6 + [_I] * 7 + [_P],
    # the same with the bf16 block's tile code in place of the x dtype
    "quant_matmul_fwd_tile": [_P] * 6 + [_I] * 7 + [_P],
    # w, out, u, v, tau, chain, B, m, n, r, dtype, stream
    "tezo_perturb_fwd": [_P] * 5 + [DeltaChain] + [_I] * 5 + [_P],
    # w, out, u, the k V factors, chain, B, m, n, r, dtype, stream
    "lozo_chain_fwd": [_P] * 3 + [FactorList, DeltaChain] + [_I] * 5 + [_P],
    # w, out, u, v, sigma, U·Σ scratch, chain, B, m, n, r, dtype, stream
    "subzo_perturb_fwd": [_P] * 6 + [DeltaChain] + [_I] * 5 + [_P],
    # w, out, u, v, tau_m, tau_v, tau_r, restore chain, -lr, eps, decay,
    # B, m, n, r, dtype, stream
    "tezo_adam_update_fwd": [_P] * 7 + [DeltaChain, _F, _F, _F] + [_I] * 5 + [_P],
    # w, out, k0, k1, chain, lead dims, B, m, n, dtype, stream
    "noise_perturb_fwd": [_P, _P, _U, _U, NoiseChain, LeadDims] + [_I] * 4 + [_P],
    # w, m, v, kappas, q, k0, k1, restore chain, hyp, lead dims, variant, B,
    # m, n, dtype, stream
    "noise_update_fwd": [_P] * 4 + [_I, _U, _U, NoiseChain, NoiseHyp, LeadDims] + [_I] * 5
    + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
builds = 0  # nvcc runs performed by this process
build_log = ""  # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return found


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> str:
    """One ``nvcc -c`` per source, all started together, then one link.
    Returns nvcc's combined output; raises if any step fails."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = _BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append(
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        )
    log = []
    for p in procs:
        out, _ = p.communicate()
        log.append(out)
        if p.returncode != 0:
            for q in procs:
                q.wait()
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{''.join(log)}")
    tmp = _BUILD_DIR / f"{tag}.so"
    link = subprocess.run(
        [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True,
        text=True,
    )
    log.append(link.stdout + link.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{''.join(log)}")
    os.replace(tmp, so)
    return "".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has no build."""
    global _lib, builds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            build_log = _compile(so)
            builds += 1
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
