"""One TeZO-Adam step of the port on qwen2.5-14b-smoke (QKV biases),
qwen3-32b-smoke (qk-norm), dbrx-132b-smoke and kimi-k2-smoke (MoE: expert
leaves with batch dims (L, E); kimi-k2's router of 8 experts is low-rank,
dbrx's of 4 is not) against the reference's ``kernel_mode="xla"`` step, on the CPU, from the same numpy params (nonzero biases and norm
scales): the loss within 1e-5 relative, params and factors within 1e-5,
the κ-scaled τ-space and dense moments within 1e-3 of each moment's
largest entry (the two frameworks sum matmuls in other orders, and κ =
Δloss / 2ρ magnifies that by 1/2ρ; tests/test_torch_train.py holds
opt-125m so).

The smoke configs run at 8 layers instead of 2: the reference's
``is_lowrank_leaf`` counts a stacked ``[L, n]`` leaf as a matrix only once
L >= 8, so only there are the stacked QKV biases and qk-norm scales (and
the layer norms) perturbed as low-rank leaves (the expert leaves and
kimi-k2's router are at any depth), as they are at full width
(ROADMAP.md fact 12).  At 2 layers they would take the dense perturbation
that tests/test_torch_train.py already holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import ZOConfig as RefZOConfig
from repro.core import build_zo_train_step as ref_build_step
from repro.core import init_zo_state as ref_init_state
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.core.cpd import is_lowrank_leaf
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.models import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.utils.tree import flatten_with_path

from _torch_ref import numpy_params, to_jax

DATA = dict(seq_len=32, global_batch=4, vocab_size=256, seed=0)
# (arch, the stacked leaves that must be low-rank at 8 layers)
CASES = [
    ("qwen2.5-14b", ("bq", "bk", "bv", "ln1", "ln2")),
    ("qwen3-32b", ("q_norm", "k_norm", "ln1", "ln2")),
    ("dbrx-132b", ("we_gate", "we_up", "we_down", "ln1", "ln2")),
    ("kimi-k2-1t-a32b", ("router", "we_gate", "we_up", "we_down", "ln1", "ln2")),
]
LAYERS = 8


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _ref_flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) if v.dtype != np.uint32
            else np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch,stacked", CASES)
def test_tezo_adam_step_matches_reference_xla(arch, stacked):
    cfg = get_smoke_config(arch).reduced(n_layers=LAYERS)
    np_params = numpy_params(cfg, seed=6)
    batch = batch_at_step(DataConfig(**DATA), 0)
    kw = dict(method="tezo_adam", q_probes=1, rank=8, lr=1e-4, seed=0)

    params = params_from_numpy(np_params)
    lowrank = {p for p, w in flatten_with_path(params) if is_lowrank_leaf(p, w)}
    assert {f"['blocks']['{n}']" for n in stacked} <= lowrank
    assert ("['blocks']['router']" in lowrank) == (cfg.n_experts >= 8)
    zc = ZOConfig(**kw)
    state = init_zo_state(params, zc)
    assert set(state.mstate["factors"]) == lowrank
    state, metrics = build_zo_train_step(build_model(cfg, device="cpu").loss_fn, zc)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})

    ref_model = ref_build_model(ref_smoke_config(arch).reduced(n_layers=LAYERS,
                                                               kernel_mode="xla"))
    rzc = RefZOConfig(kernel_mode="xla", **kw)
    jstate = ref_init_state(to_jax(np_params), rzc)
    jstate, jmetrics = jax.jit(ref_build_step(ref_model.loss_fn, rzc))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5,
                               atol=0)
    got = {p: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for p, v in flatten_with_path(state)}
    want = _ref_flat(jstate)
    assert got.keys() == want.keys()
    for path, w in want.items():
        if path.startswith((".mstate['tau_", ".mstate['dense_")):
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-3 * scale, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    # the step moved the new leaves, and by the reference's amounts
    for name in stacked:
        path = f".params['blocks']['{name}']"
        assert np.abs(got[path] - np_params["blocks"][name]).max() > 1e-6, path
