"""Spectral rank in the ZO step, against the reference at
``kernel_mode="xla"`` on the f32 opt-125m-smoke config:

* ``--smoke --device cpu --rank-mode spectral`` (ranks 43, no mask) prints
  the reference trainer's ``final_eval_loss`` within 1e-5 relative, the bar
  of the const-rank CLI test in tests/test_torch_train.py.  Neither is
  bitwise in general: the port's and the reference's states already differ
  in the last bits after one const-rank step (κ = Δloss / 2ρ carries the
  forwards' rounding), and at rank 43 the two losses print 2 f32 ulps
  apart, as the const-rank run at rank 43 does; the spectral run is bitwise
  the port's own const-rank run at the ranks it selects.
* A TeZO-Adam run with per-layer masks on the stacked block leaves: the
  state within test_torch_train.py's bounds of the reference's, the masked
  τ_M / τ_V components exactly 0 in both, chained == unchained bitwise in
  the port, and the masked state through either checkpointer restored by
  the other with every array equal.

The reference's jitted steps: its trainer's spectral step, and one masked
step, each compiled once per module."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.checkpoint.checkpointer import _flatten_numpy as ref_flatten_numpy
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import ZOConfig as RefZOConfig
from repro.core import build_zo_train_step as ref_build_step
from repro.core import init_zo_state as ref_init_state
from repro.data import DataConfig as RefDataConfig
from repro.data import batch_at_step as ref_batch_at_step
from repro.launch.train import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import build_zo_train_step, init_zo_state
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path, map_with_path

DATA = dict(seq_len=32, global_batch=4, vocab_size=256, seed=0)
RANK, STEPS, Q = 8, 2, 2
BLOCK_LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_down")  # [2, m, n] at the smoke size
# layer 0 keeps 5 of the 8 components, layer 1 all of them
MASK = np.array([[1] * 5 + [0] * 3, [1] * 8], np.float32)
MASKS = {f"['blocks']['{name}']": MASK for name in BLOCK_LEAVES}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(state) -> dict:
    return {p: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_with_path(state)}


def _ref_flat(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(state)}


def test_spectral_smoke_cli_matches_reference(capsys):
    want = ref_train(smoke=True, kernel_mode="xla", rank_mode="spectral", steps=10,
                     verbose=False)["final_eval_loss"]
    port_train.main(["--smoke", "--device", "cpu", "--steps", "10", "--rank-mode", "spectral"])
    out = capsys.readouterr().out
    lines = [json.loads(ln[len("[train] "):]) for ln in out.splitlines()
             if ln.startswith("[train] ")]
    assert lines[0]["rank_set"] == [43] and lines[0]["rank_masks"] == 0
    result = json.loads(out[out.index("\n{") + 1:])
    assert abs(result["final_eval_loss"] - want) <= 1e-5 * abs(want)
    const = port_train.train(smoke=True, device="cpu", steps=10, rank=43, verbose=False)
    assert result["final_eval_loss"] == const["final_eval_loss"]


def _port_run(restore_mode="inplace"):
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    zc = ZOConfig(method="tezo_adam", q_probes=Q, restore_mode=restore_mode, rank=RANK,
                  lr=1e-4)
    state = init_zo_state(model.init(PRNGKey(0)), zc, rank_masks=MASKS)
    step = build_zo_train_step(model.loss_fn, zc)
    losses = []
    for s in range(STEPS):
        state, m = step(state, {k: _t(v) for k, v in batch_at_step(DataConfig(**DATA),
                                                                     s).items()})
        losses.append(float(m["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def masked_runs():
    """(port state, port losses, reference state, reference losses,
    reference template) of the masked TeZO-Adam run."""
    port, lp = _port_run()
    model = ref_build_model(ref_smoke_config("opt-125m"))
    zc = RefZOConfig(method="tezo_adam", kernel_mode="xla", q_probes=Q, rank=RANK, lr=1e-4)
    params = map_with_path(lambda _, w: jnp.asarray(w.numpy()),
                           build_model(get_smoke_config("opt-125m"), device="cpu")
                           .init(PRNGKey(0)))
    template = ref_init_state(params, zc, None, MASKS)
    step = jax.jit(ref_build_step(model.loss_fn, zc))
    state, lr_ = template, []
    for s in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in ref_batch_at_step(RefDataConfig(**DATA),
                                                                 s).items()}
        state, m = step(state, batch)
        lr_.append(float(m["loss"]))
    return port, lp, state, lr_, template


def _masked_zero(flat: dict) -> None:
    for path in MASKS:
        for moment in ("tau_m", "tau_v"):
            t = flat[f".mstate['{moment}'][\"{path}\"]"]
            assert np.all(t[0, 5:] == 0) and np.all(t[0, :5] != 0), (moment, path)
            assert np.all(t[1] != 0), (moment, path)


def test_masked_tezo_adam_matches_reference(masked_runs):
    port, lp, ref, lr_, _ = masked_runs
    np.testing.assert_allclose(lp, lr_, rtol=1e-5, atol=0)
    got, want = _flat(port), _ref_flat(ref)
    assert set(got) == set(want)
    for path, w in want.items():
        if path.startswith((".mstate['tau_", ".mstate['dense_")):
            # κ-scaled moments: test_torch_train.py's bound, 1e-3 of the largest
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-3 * scale, err_msg=path)
        elif w.dtype.kind == "f":
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
        else:  # the step and the key
            np.testing.assert_array_equal(got[path], w, err_msg=path)
    _masked_zero(got)
    _masked_zero({k: np.asarray(v, np.float32) for k, v in want.items()})


def test_masked_chained_equals_unchained_bitwise(masked_runs):
    chained, lc = masked_runs[0], masked_runs[1]
    unchained, lu = _port_run("unchained")
    assert lc == lu
    a, b = flatten_with_path(chained), dict(flatten_with_path(unchained))
    for path, x in a:
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, b[path]), path
        else:
            assert np.array_equal(x, b[path]), path


def test_masked_checkpoint_round_trips_between_the_packages(masked_runs, tmp_path):
    """The reference's ``_write`` of its masked state restored by the port,
    and the port's save restored by the reference: every array equal, the
    masks under ``.mstate['factors']["<path>"].rank_mask``."""
    port, _, ref, _, ref_template = masked_runs
    want = _ref_flat(ref)
    key = ".mstate['factors'][\"['blocks']['wq']\"].rank_mask"
    assert key in want
    RefCheckpointer(tmp_path / "ref")._write(STEPS, ref_flatten_numpy(ref), {"step": STEPS})
    template = init_zo_state(build_model(get_smoke_config("opt-125m"), device="cpu")
                             .init(PRNGKey(3)), ZOConfig(method="tezo_adam", q_probes=Q,
                                                         rank=RANK), rank_masks=MASKS)
    got, extra = Checkpointer(tmp_path / "ref").restore(template)
    assert extra == {"step": STEPS}
    flat = {p: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_with_path(got)}
    assert set(flat) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(flat[path], w, err_msg=path)

    Checkpointer(tmp_path / "port").save(STEPS, port, extra={"step": STEPS})
    back, extra = RefCheckpointer(tmp_path / "port").restore(ref_template)
    assert extra == {"step": STEPS}
    mine = {p: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_with_path(port)}
    back = _ref_flat(back)
    assert set(back) == set(mine)
    for path, w in mine.items():
        np.testing.assert_array_equal(back[path], w, err_msg=path)

