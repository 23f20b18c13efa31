"""The selective scan's plain version (``repro_torch.kernels.selective_scan``)
on the CPU, against the reference: its sequential oracle
``repro.kernels.ref.selective_scan_ref`` and the Pallas kernel through
``repro.kernels.ops.selective_scan`` under the interpreter (as
tests/test_selective_scan_kernel.py runs it).

Inputs are made with numpy from a seed.  Tolerance: 1e-5 of the output's
largest entry (f32; the frameworks' ``exp`` differs in the last ulp and the
reference reduces over the state in its own order, where the port sums in
ascending order).  The CUDA kernel is held against this plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.core import dispatch
from repro_torch.kernels import selective_scan as tscan

ATOL = 1e-5


@pytest.fixture
def force_interpret():
    ops.set_interpret(True)
    yield
    ops.set_interpret(None)


def _inputs(B, S, D, N, seed, h0_scale=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, D)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((D, N)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((B, D, N)) * h0_scale).astype(np.float32)
    return x, dt, a, b, c, h0


def _plain(args):
    return tscan.selective_scan_plain(*(torch.from_numpy(t) for t in args))


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale, err_msg=what)


# ragged D and S (no tile multiple), S = 1 (a decode step), N of the full
# config (16) and of the smoke config (4), zero and nonzero h0
CASES = [(2, 37, 100, 16, 0.1), (1, 1, 24, 16, 0.1), (3, 9, 20, 4, 0.0), (2, 16, 64, 8, 1.0)]


@pytest.mark.parametrize("B,S,D,N,h0_scale", CASES)
def test_plain_matches_reference_oracle(B, S, D, N, h0_scale):
    args = _inputs(B, S, D, N, seed=B + S + D + N, h0_scale=h0_scale)
    y, h = _plain(args)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, D)
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, D, N)
    y_r, h_r = ref.selective_scan_ref(*(jnp.asarray(t) for t in args))
    _close(y, y_r, "y")
    _close(h, h_r, "h_last")


@pytest.mark.parametrize("B,S,D,N", [(2, 37, 100, 16), (1, 1, 24, 16)])
def test_plain_matches_pallas_kernel(B, S, D, N, force_interpret):
    """Against the TPU kernel under the interpreter, its wrapper padding the
    ragged D and S (identity steps, zero channels)."""
    args = _inputs(B, S, D, N, seed=3 * S + D)
    y, h = _plain(args)
    y_k, h_k = ops.selective_scan(*(jnp.asarray(t) for t in args), bd=32, bs=16)
    _close(y, y_k, "y")
    _close(h, h_k, "h_last")


def test_chained_calls_equal_one_call():
    """h_last carries: two calls over S = 13 + 24 give one call over 37,
    bitwise (the plain version's steps do not depend on the split)."""
    x, dt, a, b, c, h0 = (torch.from_numpy(t) for t in _inputs(2, 37, 40, 16, seed=5))
    y, h = tscan.selective_scan_plain(x, dt, a, b, c, h0)
    y1, h1 = tscan.selective_scan_plain(x[:, :13], dt[:, :13], a, b[:, :13], c[:, :13], h0)
    y2, h2 = tscan.selective_scan_plain(x[:, 13:], dt[:, 13:], a, b[:, 13:], c[:, 13:], h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h)


def test_dispatch_runs_the_plain_version_on_the_cpu():
    """``dispatch.selective_scan_fwd`` on CPU tensors is the plain version
    (at S = 1 too), and launches nothing."""
    before = tscan.selective_scan.launches
    for S in (1, 7):
        args = [torch.from_numpy(t) for t in _inputs(2, S, 20, 4, seed=S)]
        got = dispatch.selective_scan_fwd(*args)
        want = tscan.selective_scan_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tscan.selective_scan.launches == before


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 2, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tscan.selective_scan(x, x, torch.zeros((3, 4), device="meta"),
                             torch.zeros((1, 2, 4), device="meta"),
                             torch.zeros((1, 2, 4), device="meta"),
                             torch.zeros((1, 3, 4), device="meta"))
