"""The port's replay of the reference's random streams (``jax.random`` with
partitionable Threefry) against JAX itself, on the CPU.

Keys, path folds and random bits must be bitwise equal; f32 normals too
(the port replays XLA:CPU's log1p, its fused multiply-adds and its
correctly rounded sqrt; the older checks below keep their 2-ulp bound);
drawn params within 2 ulps times their init scale; zeros and ones
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import cpd as jcpd
from repro.models import build_model as ref_build_model
from repro.utils.tree import fold_in_path as ref_fold_in_path
from repro_torch.configs import get_smoke_config
from repro_torch.core import cpd
from repro_torch.models import build_model
from repro_torch.utils import jax_random as jr
from repro_torch.utils.tree import flatten_with_path, fold_in_path, map_with_path

PATHS = ["['blocks']['wq']", "['embed']#tau", "['blocks']['ln1']#dense", ".mstate['x']"]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _key(k) -> tuple:
    return tuple(int(x) for x in np.asarray(k))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -7])
def test_keys_and_folds_bitwise(seed):
    k = jax.random.PRNGKey(seed)
    assert _key(k) == jr.PRNGKey(seed)
    for data in (0, 1, 0xF0, 0x5EED, 2**31 - 1, 123456789):
        assert _key(jax.random.fold_in(k, data)) == jr.fold_in(jr.PRNGKey(seed), data)
    for path in PATHS:
        assert _key(ref_fold_in_path(k, path)) == fold_in_path(jr.PRNGKey(seed), path)


@pytest.mark.parametrize("shape", [(7,), (2, 64, 24), (33, 65)])
@pytest.mark.parametrize("fold", [0, 5])
def test_bits_bitwise_and_normal_within_2ulp(shape, fold):
    k = jax.random.fold_in(jax.random.PRNGKey(3), fold)
    n = int(np.prod(shape))
    want_bits = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    got_bits = jr._bits(*_key(k), 0, n, "cpu").numpy().reshape(shape)
    np.testing.assert_array_equal(got_bits, want_bits)
    want = np.asarray(jax.random.normal(k, shape, jnp.float32))
    got = jr.normal(_key(k), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _ulps(got, want).max() <= 2


def test_normal_bitwise_on_a_large_draw():
    """2^20 normals, bit for bit: the tails (erfinv's sqrt branch, about 1
    in 300 draws) included, which torch's own f32 sqrt on the CPU would put
    an ulp off about 1 in 140 times."""
    k = jax.random.fold_in(jax.random.PRNGKey(11), 2)
    want = np.asarray(jax.random.normal(k, (1 << 20,), jnp.float32))
    np.testing.assert_array_equal(jr.normal(_key(k), (1 << 20,)).numpy(), want)


def test_normal_many_is_the_concatenation():
    keys = np.stack([jr.fold_in(jr.PRNGKey(1), i) for i in range(4)]).astype(np.int64)
    sizes = [3, 0, 50, 7]
    got = jr.normal_many(keys, sizes)
    want = torch.cat([jr.normal(tuple(k), (s,)) for k, s in zip(keys.tolist(), sizes)])
    assert torch.equal(got, want)


def _specs(model) -> dict:
    out = {}
    map_with_path(lambda path, spec: out.setdefault(path, spec), model.impl.param_specs())
    return out


def _ref_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_match_reference(seed):
    ref = _ref_leaves(ref_build_model(ref_smoke_config("opt-125m")).init(
        jax.random.PRNGKey(seed)))
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    got = dict(flatten_with_path(model.init(jr.PRNGKey(seed))))
    specs = _specs(model)
    assert set(got) == set(ref)
    for path, want in ref.items():
        g = got[path].float().numpy()
        spec = specs[path]
        if spec.init == "normal":
            assert _ulps(g / spec.scale, want / spec.scale).max() <= 2, path
        else:
            np.testing.assert_array_equal(g, want, err_msg=path)


def _smoke_params(seed=0):
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    ported = model.init(jr.PRNGKey(seed))
    ref = ref_build_model(ref_smoke_config("opt-125m")).init(jax.random.PRNGKey(seed))
    return ported, ref


def test_cpd_draws_match_reference():
    """init_factors, sample_tau and dense_noise on opt-125m-smoke: the
    same leaves get factors, and every draw is within 2 ulps."""
    ported, ref = _smoke_params()
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0xF0)
    ref_f = jcpd.init_factors(ref, key, default_rank=8)
    got_f = cpd.init_factors(ported, _key(key), default_rank=8)
    assert sorted(got_f) == sorted(ref_f)
    key_t = jax.random.fold_in(jax.random.PRNGKey(9), 4)
    for path, f in ref_f.items():
        assert _ulps(got_f[path].u.numpy(), f.u).max() <= 2, path
        assert _ulps(got_f[path].v.numpy(), f.v).max() <= 2, path
        want = jcpd.sample_tau(f, key_t, path, 1)
        got = cpd.sample_tau(got_f[path], _key(key_t), path, 1)
        assert tuple(got.shape) == want.shape
        assert _ulps(got.numpy(), want).max() <= 2, path
    dense = {p: w for p, w in flatten_with_path(ported) if p not in got_f}
    ref_leaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    assert "['final_norm']" in dense and "['blocks']['ln1']" in dense  # [2, 64]: m < 8
    for path, w in dense.items():
        want = jcpd.dense_noise(ref_leaves[path], key_t, path, 1)
        got = cpd.dense_noise(w, _key(key_t), path, 1)
        assert got.dtype == w.dtype
        assert _ulps(got.numpy(), want).max() <= 2, path


def test_stacked_norm_scales_are_lowrank_at_full_width():
    """Full opt-125m's [12, 768] ln1/ln2 stacks count as matrices (m = 12 >=
    8), as in the reference; the final norm [768] does not."""
    specs = _specs(build_model(get_smoke_config("opt-125m").reduced(n_layers=12),
                               device="cpu"))
    ln1 = torch.empty(specs["['blocks']['ln1']"].shape)
    assert cpd.is_lowrank_leaf("", ln1) == jcpd.is_lowrank_leaf("", np.empty(ln1.shape))
    assert cpd.is_lowrank_leaf("", ln1) and not cpd.is_lowrank_leaf("", torch.empty(64))
