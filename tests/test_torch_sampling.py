"""Sampled tokens: the port replays ``jax.random.categorical`` bit for bit.

* ``utils.jax_random.uniform`` / ``gumbel`` / ``categorical`` against
  ``jax.random``'s over many keys and shapes, f32 and bf16, one key or one
  key per row (``vmap``): bitwise;
* at temperature 0.8 on the opt-125m smoke config, the port's
  ``ServeEngine`` (with and without speculative decoding) and
  ``BatchedServer`` emit the reference's tokens exactly.  The Hymba
  ``BatchedServer``'s sampled tokens are held in tests/test_torch_hymba.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import BatchedServer, Request, ServeEngine
from repro_torch.models.bridge import params_from_numpy
from repro_torch.utils import jax_random

from _torch_ref import numpy_params, to_jax

TEMPERATURE = 0.8
ENGINE_KW = dict(max_concurrent_decodes=2, max_prompt_len=8, max_new_tokens=6, page_size=8,
                 temperature=TEMPERATURE)
TINY = float(np.finfo(np.float32).tiny)
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _bits32(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _key(seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_draws_equal_jax_random(dtypes):
    """uniform (at gumbel's range), gumbel and categorical over 12 keys and
    shapes from one row of 1 to a [5, 50272] batch."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(0)
    shapes = [(1, 1), (1, 7), (2, 256), (3, 1000), (1, 32001), (5, 50272)]
    for i in range(12):
        shape = shapes[i % len(shapes)]
        key = _key(int(rng.integers(0, 2**31)), int(rng.integers(0, 10**6)))
        k = np.asarray(key)
        u = jax.random.uniform(key, shape, jdt, minval=TINY, maxval=1.0)
        assert np.array_equal(_bits32(jax_random.uniform(k, shape, tdt, TINY, 1.0).float()),
                              _bits32(u.astype(jnp.float32))), (shape, "uniform")
        g = jax.random.gumbel(key, shape, jdt)
        assert np.array_equal(_bits32(jax_random.gumbel(k, shape, tdt).float()),
                              _bits32(g.astype(jnp.float32))), (shape, "gumbel")
        logits = (rng.standard_normal(shape) * 3).astype(np.float32)
        want = jax.random.categorical(key, jnp.asarray(logits).astype(jdt), axis=-1)
        got = jax_random.categorical(k, torch.from_numpy(logits).to(tdt))
        assert np.array_equal(got.numpy(), np.asarray(want)), (shape, "categorical")


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_categorical_with_a_key_per_row_is_vmap(dtypes):
    jdt, tdt = dtypes
    rng = np.random.default_rng(1)
    keys = np.stack([np.asarray(_key(int(s), int(t)))
                     for s, t in rng.integers(0, 10**6, size=(9, 2))])
    logits = (rng.standard_normal((9, 3001)) * 2).astype(np.float32)
    want = jax.vmap(lambda k, r: jax.random.categorical(k, r))(
        jnp.asarray(keys), jnp.asarray(logits).astype(jdt))
    got = jax_random.categorical(keys, torch.from_numpy(logits).to(tdt))
    assert np.array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the servers at temperature 0.8
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(get_smoke_config("opt-125m"), seed=0)


def _trace(request_cls):
    rng = np.random.default_rng(4)
    return [request_cls(id=f"t{i}", tokens=rng.integers(2, 256, size=n).astype(np.int32),
                        max_new=6, seed=300 + i, arrival=float(a))
            for i, (n, a) in enumerate(zip((5, 8, 3, 7), (0, 0, 1, 3)))]


@pytest.fixture(scope="module")
def ref_streams(np_params):
    eng = ref_serve.ServeEngine(ref_smoke_config("opt-125m"), to_jax(np_params), **ENGINE_KW)
    res, _ = eng.serve(_trace(ref_serve.Request), step_clock=True)
    return {rid: r["tokens"] for rid, r in res.items()}


@pytest.mark.parametrize("spec", [False, True], ids=["engine", "spec_engine"])
def test_engine_sampled_streams_match_reference(np_params, ref_streams, spec):
    """Every request's sampled stream equals the reference engine's (whose
    spec stream is its non-spec one)."""
    eng = ServeEngine(get_smoke_config("opt-125m"), params_from_numpy(np_params),
                      device="cpu", spec_decode=spec, draft_len=3, **ENGINE_KW)
    res, _ = eng.serve(_trace(Request), step_clock=True)
    assert set(res) == set(ref_streams)
    for rid, want in ref_streams.items():
        np.testing.assert_array_equal(res[rid]["tokens"], want, err_msg=rid)


def test_batched_server_sampled_tokens_match_reference(np_params):
    prompts = np.random.default_rng(5).integers(2, 256, size=(3, 10)).astype(np.int32)
    want, _ = ref_serve.BatchedServer(ref_smoke_config("opt-125m"), to_jax(np_params),
                                      max_len=32).generate(prompts, max_new_tokens=8,
                                                           temperature=TEMPERATURE, seed=11)
    got, _ = BatchedServer(get_smoke_config("opt-125m"), params_from_numpy(np_params),
                           max_len=32, device="cpu").generate(
        prompts, max_new_tokens=8, temperature=TEMPERATURE, seed=11)
    np.testing.assert_array_equal(got, np.asarray(want))
