"""The port's dense-noise stream and the plain versions of its two noise
kernels (``repro_torch.kernels.zo_noise``) on the CPU, against the
reference (``repro/kernels/zo_noise.py``, ``ops.noise_*`` under the Pallas
interpreter, ``ref.counter_normal_ref``).

Tolerances and why:

* Keys, Threefry bits and the normals: bit for bit.  The integer part is a
  spec (Random123); the f32 part replays the functions XLA:CPU computes the
  reference's stream with (its own ``log``, the correctly rounded ``sqrt``,
  glibc's ``cosf``), checked against XLA on a sample of the inputs the
  stream can draw that crosses every branch (``box_muller_mismatches(1)``
  checks all 2^24).
* W against the reference's Pallas kernels: f32 within 1e-6 (the weights
  are ~0.1, an f32 ulp there ~7e-9), bf16 within 1 bf16 ulp taken at the
  larger of the results and the input weight.  The interpreter lets XLA:CPU
  contract ``w + s·z`` and the update's products into fmas; the port rounds
  each product and sum on its own, as the reference's ``add_scaled`` does
  and as its kernels' per-delta rounding contract states, so single
  elements differ by an f32 ulp.  XLA's ``rsqrt`` is not correctly rounded
  either (the port's is).
* The moments M and V (f32): within 1e-6 of their largest entry, for the
  same reasons.
* Inside the port (a chain against its single deltas, restore-into-update
  against a perturb then an update, stacked against slice by slice): bit
  for bit.

The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels import zo_noise as rz
from repro_torch.kernels import zo_noise as pz
from repro_torch.utils import jax_random


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    ops.set_interpret(True)
    yield
    ops.set_interpret(None)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _seeds(k=7, path="['blocks']['wq']"):
    key = jax.random.PRNGKey(k)
    port_key = tuple(int(x) for x in np.asarray(jax.random.key_data(key)))
    return rz.leaf_seed(key, path), pz.leaf_seed(port_key, path)


def _within_bf16_ulp(got, want, w_in) -> bool:
    got, want, w_in = (np.asarray(x, np.float32) for x in (got, want, w_in))
    _, e = np.frexp(np.maximum(np.maximum(np.abs(got), np.abs(want)), np.abs(w_in)))
    return bool(np.all(np.abs(got - want) <= np.ldexp(1.0, e - 8)))


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _check_w(got, want, w_in, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=1e-6, err_msg=what)
    else:
        assert _within_bf16_ulp(_f32(got), _f32(want), _f32(w_in)), what


# --------------------------------------------------------------------------
# keys and the stream
# --------------------------------------------------------------------------


def test_threefry_matches_random123_vectors():
    """The published Threefry-2x32-20 vectors (tests/test_zo_noise.py:37)."""
    cases = [
        ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
    ]
    for (k0, k1), (c0, c1), want in cases:
        assert jax_random.threefry2x32(k0, k1, c0, c1) == want
        x0, x1 = jax_random.threefry2x32(k0, k1, torch.tensor([c0]), torch.tensor([c1]))
        assert (int(x0), int(x1)) == want


@pytest.mark.parametrize("path", ["['embed']", "['blocks']['w_up']", "[\"a'b\"]"])
def test_leaf_and_batch_seeds_equal_reference(path):
    seed_j, seed_p = _seeds(11, path)
    assert seed_p == tuple(int(x) for x in np.asarray(seed_j))
    want = np.asarray(ops._batch_seeds(seed_j, 5))
    assert [tuple(s) for s in want.tolist()] == pz.batch_seeds(seed_p, 5)


@pytest.mark.parametrize("shape", [(131, 257), (3, 40, 24)])
def test_counter_normal_equals_reference(shape):
    """The Threefry words and the normals, bit for bit (0 ulps), at a ragged
    shape and a stacked one (each slice under its own slice key)."""
    seed_j, seed_p = _seeds()
    *lead, m, n = shape
    slices = ([((), seed_j, seed_p)] if not lead else
              [((i,), s_j, s_p) for i, (s_j, s_p) in enumerate(
                  zip(ops._batch_seeds(seed_j, lead[0]), pz.batch_seeds(seed_p, lead[0])))])
    rows = jnp.broadcast_to(jnp.arange(m, dtype=jnp.uint32)[:, None], (m, n))
    cols = jnp.broadcast_to(jnp.arange(n, dtype=jnp.uint32)[None, :], (m, n))
    for _, s_j, s_p in slices:
        for probe in (0, 1, 255):
            b0, b1 = rz.threefry2x32(s_j[0], s_j[1], cols, rows | jnp.uint32(probe << 24))
            t0, t1 = jax_random.threefry2x32(
                *s_p, torch.arange(n).expand(m, n), torch.arange(m)[:, None].expand(m, n)
                | (probe << 24))
            np.testing.assert_array_equal(t0.numpy(), np.asarray(b0, np.int64))
            np.testing.assert_array_equal(t1.numpy(), np.asarray(b1, np.int64))
            want = np.asarray(ref.counter_normal_ref((m, n), s_j, probe))
            got = pz.counter_normal(s_p, m, n, probe).numpy()
            np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and 0.5 < got.std() < 1.5


def box_muller_mismatches(stride: int) -> tuple[int, int]:
    """Elements where the port's radius sqrt(-2 log u1) and cos(2π u2)
    differ from XLA:CPU's, over every ``stride``-th of the 2^24 uniforms a
    word of the stream can give."""
    k = np.arange(0, 1 << 24, stride, dtype=np.float32)
    u1 = k * np.float32(2.0**-24) + np.float32(2.0**-25)
    ang = (k * np.float32(2.0**-24)) * np.float32(2.0 * math.pi)
    want_r = np.asarray(jax.jit(lambda u: jnp.sqrt(jnp.float32(-2.0) * jnp.log(u)))(u1))
    got_r = jax_random.sqrt_rn(-2.0 * jax_random._xla_log(torch.from_numpy(u1))).numpy()
    want_c = np.asarray(jax.jit(jnp.cos)(ang))
    got_c = pz.cosf(torch.from_numpy(ang)).numpy()
    return int(np.sum(got_r != want_r)), int(np.sum(got_c != want_c))


def test_box_muller_equals_xla():
    """The radius and cos(2π u2) equal XLA:CPU's bit for bit, so z does
    (its last step is one f32 product).  A stride-16 sample of the 2^24
    inputs, which crosses every branch and reduction quadrant of glibc's
    cosf, keeps this test to about a second; ``box_muller_mismatches(1)``
    checks all of them (about 11 s on one core) and finds none either."""
    assert box_muller_mismatches(16) == (0, 0)


# --------------------------------------------------------------------------
# the plain kernels against the reference's Pallas kernels
# --------------------------------------------------------------------------


def _weights(shape, dtype, seed):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jnp.asarray(w).astype(jdt), _t(w).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noise_perturb_plain_matches_reference(dtype):
    """k = 1, 2, 3 probe chains on a stacked ragged leaf against the
    reference's chain kernel; the chain equals its single deltas bit for
    bit; ``out`` leaves W untouched."""
    seed_j, seed_p = _seeds()
    w_j, w_t = _weights((3, 40, 136), dtype, 1)
    probes, scales = (0, 1, 2), (1e-3, -2e-3, 1e-3)
    for k in (1, 2, 3):
        got = pz.noise_perturb(w_t.clone(), seed_p, probes[:k], scales[:k])
        want = ops.noise_perturb(w_j, seed_j, jnp.asarray(scales[:k], jnp.float32),
                                 probe=probes[:k])
        assert got.dtype == w_t.dtype and got.shape == w_t.shape
        _check_w(got, want, w_t, dtype, f"k={k}")
        single = w_t.clone()
        for p, s in zip(probes[:k], scales[:k]):
            single = pz.noise_perturb(single, seed_p, [p], [s])
        assert torch.equal(got, single)
    out = torch.empty_like(w_t)
    before = w_t.clone()
    res = pz.noise_perturb(w_t, seed_p, [0], [1e-3], out=out)
    assert res is out and torch.equal(w_t, before) and not torch.equal(out, before)


# q, restore (of the last probe), decay
UPDATE_CASES = [(1, False, None), (1, True, 0.99), (3, False, 0.99), (3, True, 0.99)]


@pytest.mark.parametrize("variant", ["sgd", "momentum", "adam"])
def test_noise_update_plain_matches_reference(variant, dtype="float32"):
    """Each rule at q = 1 and 3, each with and without the restore of the
    last probe, with and without a decay, on f32 weights (the bf16 rounding is the perturb
    test's and the card's) against ``ops.noise_update_*`` under the
    interpreter (not ref.py's oracle, which divides by q where the kernel
    multiplies by f32(1/q))."""
    seed_j, seed_p = _seeds(5)
    w_j, w_t = _weights((2, 24, 40), dtype, 2)
    rng = np.random.default_rng(3)
    m0 = (rng.standard_normal((2, 24, 40)) * 0.01).astype(np.float32)
    v0 = (np.abs(rng.standard_normal((2, 24, 40))) * 0.01).astype(np.float32)
    kap = np.asarray([0.7, -1.3, 0.4], np.float32)
    lr, b1, b2, eps, rs = 1e-2, 0.9, 0.99, 1e-5, 1e-3
    for q, restore, decay in UPDATE_CASES:
        rp = q - 1 if restore else None
        rk = dict(restore_probe=rp, restore_scale=rs, decay=decay)
        mt, vt = _t(m0), _t(v0)
        got = pz.noise_update(w_t.clone(), seed_p, _t(kap[:q]), variant, lr, b1, b2, eps,
                              decay=decay, m_buf=mt, v_buf=vt,
                              restore_probes=[rp] if restore else [],
                              restore_scales=[rs] if restore else [])
        k_j = jnp.asarray(kap[:q])
        if variant == "sgd":
            want = (ops.noise_update_sgd(w_j, seed_j, k_j, lr, **rk),)
        elif variant == "momentum":
            want = ops.noise_update_momentum(w_j, jnp.asarray(m0), seed_j, k_j, lr, b1, **rk)
        else:
            want = ops.noise_update_adam(w_j, jnp.asarray(m0), jnp.asarray(v0), seed_j, k_j,
                                         lr, b1, b2, eps, **rk)
        assert len(got) == len(want)
        what = f"{variant} q={q} restore={restore}"
        _check_w(got[0], want[0], w_t, dtype, what)
        for g, w in zip(got[1:], want[1:]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                       err_msg=what)
        if variant != "sgd":
            assert got[1] is mt  # the moments are updated in place


def test_restore_into_update_is_bitwise_a_perturb_then_an_update():
    """The chained contract inside the port: the folded restore equals a
    separate perturb pass; a stacked leaf equals its slices under their
    slice keys."""
    _, seed = _seeds(9)
    w = (_t(np.random.default_rng(4).standard_normal((3, 16, 24)) * 0.1)).to(torch.bfloat16)
    kap = torch.tensor([0.5, -0.8])
    kw = dict(beta1=0.9, beta2=0.99, eps=1e-5, decay=0.98)
    m1, v1 = torch.zeros(w.shape), torch.full(w.shape, 1e-3)
    m2, v2 = m1.clone(), v1.clone()
    fused = pz.noise_update(w.clone(), seed, kap, "adam", 1e-2, m_buf=m1, v_buf=v1,
                            restore_probes=[1], restore_scales=[1e-3], **kw)
    two = pz.noise_update(pz.noise_perturb(w.clone(), seed, [1], [1e-3]), seed, kap, "adam",
                          1e-2, m_buf=m2, v_buf=v2, **kw)
    for a, b in zip(fused, two):
        assert torch.equal(a, b)
    for i, s in enumerate(pz.batch_seeds(seed, 3)):
        one = pz.noise_perturb(w[i].clone(), s, [0, 1], [1e-3, -2e-3])
        assert torch.equal(one, pz.noise_perturb(w.clone(), seed, [0, 1], [1e-3, -2e-3])[i])


def test_wrappers_reject_bad_operands():
    _, seed = _seeds()
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="8 bits"):
        pz.noise_perturb(w, seed, [256], [1.0])
    with pytest.raises(ValueError, match="variant"):
        pz.noise_update(w, seed, torch.ones(1), "lion", 1e-3)
    with pytest.raises(ValueError, match="moments"):
        pz.noise_update(w, seed, torch.ones(1), "adam", 1e-3, m_buf=torch.zeros(4, 8))
