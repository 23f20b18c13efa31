"""The port's first-order path (``repro_torch.optim.fo``, ``LM.fo_loss_fn``
and the trainer's ``--pretrain-steps``) against the reference's
(``repro.optim.fo``), on the f32 opt-125m-smoke config from the seed-0
params (the port's draw is bitwise the reference's):

* the loss and its gradients against ``jax.value_and_grad(loss_fn)``: the
  loss within 1e-6 relative, each leaf's gradient within 2e-6 of its largest
  |g| (seen: 7.9e-7; the two frameworks sum the forward's and backward's
  products in other orders);
* ``adamw`` and ``sgd`` (with and without momentum), three updates on the
  same gradients against the reference's ``update``: params and moments
  within one f32 ulp;
* ``train(pretrain_steps=3)``'s params against three reference steps
  (``value_and_grad`` then ``adamw(3e-3).update``, the reference trainer's
  step).  Adam's step is about lr·sign(g), so an element whose gradient is
  small enough for the gradient tolerance to turn its direction can move
  up to 2·lr a step the other way.  Elements whose |g| stays above 1e-3 of
  the leaf's largest at every step (a thousand times the measured gradient
  noise) are held within 1e-6 (seen: 3.8e-7); the rest within 2·lr per step
  (seen: 1.1e-5);
* the gradients repeat bitwise from run to run at a fixed thread count;
* the kernel wrappers raise under autograd;
* the other families, on hymba-1.5b-smoke (the hybrid family: the plain
  windowed attention and the plain selective scan under autograd) and
  xlstm-350m-smoke (the ``ssm`` family: no kernel, its recurrences written
  out of place): the loss and gradients at the same bars, a
  ``train(pretrain_steps=2)`` run's first and last loss within 1e-6
  relative of the reference's two AdamW steps, and gradients that repeat.

The reference's jitted ``value_and_grad`` is compiled once per module and
model, at one batch shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import sgd as ref_sgd
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import quant_matmul as tqmm
from repro_torch.kernels import selective_scan as tscan
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.optim import adamw, build_fo_train_step, init_fo_state, sgd
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import flatten_with_path, map_with_path

DATA = DataConfig(seq_len=128, global_batch=8, vocab_size=256, seed=0)  # train()'s
PRETRAIN_LR = 3e-3


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(s: int) -> dict:
    return batch_at_step(DATA, 10_000_000 + s)


def _keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def init():
    """The seed-0 smoke params: the port's on the CPU, and as numpy."""
    params = build_model(get_smoke_config("opt-125m"), device="cpu").init(PRNGKey(0))
    return params, map_with_path(lambda _, w: w.numpy().copy(), params)


@pytest.fixture(scope="module")
def ref_value_and_grad():
    model = ref_build_model(ref_smoke_config("opt-125m"))
    vg = jax.jit(jax.value_and_grad(model.loss_fn))
    return lambda params, batch: vg(params, {k: jnp.asarray(v) for k, v in batch.items()})


def test_fo_loss_and_grads_match_reference(init, ref_value_and_grad):
    params, npp = init
    want_loss, want_g = ref_value_and_grad(jax.tree.map(jnp.asarray, npp), _batch(0))
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    leaves = {p: w.clone().requires_grad_() for p, w in flatten_with_path(params)}
    loss = model.fo_loss_fn(map_with_path(lambda p, _: leaves[p], params),
                            {k: _t(v) for k, v in _batch(0).items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    want = _keyed(want_g)
    assert set(want) == set(leaves)
    for path, g in zip(leaves, grads):
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0, atol=2e-6 * scale,
                                   err_msg=path)


def _ulps_apart(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in f32 steps (the bit patterns on one ordered
    integer line, -0 beside +0)."""
    def line(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(2**31) - i, i)

    return int(np.abs(line(got) - line(want)).max())


@pytest.mark.parametrize("name,make,make_ref", [
    ("adamw", lambda: adamw(lr=3e-3, weight_decay=0.01),
     lambda: ref_adamw(lr=3e-3, weight_decay=0.01)),
    ("sgd", lambda: sgd(lr=0.1), lambda: ref_sgd(lr=0.1)),
    ("sgd_momentum", lambda: sgd(lr=0.1, momentum=0.9), lambda: ref_sgd(lr=0.1, momentum=0.9)),
])
def test_optimizer_update_matches_reference(name, make, make_ref):
    """Three updates on the same seeded gradients from the same params: each
    param and moment within one f32 ulp of the reference's (its eager
    ``update``, op for op the port's arithmetic)."""
    rng = np.random.default_rng(7)
    npp = {"w": rng.standard_normal((24, 40)).astype(np.float32),
           "blocks": {"b": rng.standard_normal((3, 16)).astype(np.float32)}}
    grads = [map_with_path(lambda _, w: (rng.standard_normal(w.shape) * 0.1)
                           .astype(np.float32), npp) for _ in range(3)]
    opt, ref = make(), make_ref()
    p, rp = _to_torch(npp), jax.tree.map(jnp.asarray, npp)
    st, rst = opt.init(p), ref.init(rp)
    for s, g in enumerate(grads):
        p, st = opt.update(_to_torch(g), st, p, s)
        rp, rst = ref.update(jax.tree.map(jnp.asarray, g), rst, rp, jnp.int32(s))
    got = {**{"p" + k: v.numpy() for k, v in flatten_with_path(p)},
           **{"s" + k: v.numpy() for k, v in flatten_with_path(st)}}
    want = {**{"p" + k: v for k, v in _keyed(rp).items()},
            **{"s" + k: v for k, v in _keyed(rst).items()}}
    assert got.keys() == want.keys() and len(want) == (2 if name == "sgd" else
                                                         4 if name == "sgd_momentum" else 6)
    for k in want:
        assert _ulps_apart(got[k], want[k]) <= 1, (name, k)


def _to_torch(tree):
    return map_with_path(lambda _, a: _t(a), tree)


def test_pretrain_run_matches_reference(init, ref_value_and_grad):
    """``train(pretrain_steps=3)`` (zero ZO steps) against the reference's
    three AdamW steps; see the module docstring for the two bounds."""
    _, npp = init
    opt = ref_adamw(lr=PRETRAIN_LR)
    rp = jax.tree.map(jnp.asarray, npp)
    rst, grads, ref_losses = opt.init(rp), [], []
    for s in range(3):
        loss, g = ref_value_and_grad(rp, _batch(s))
        rp, rst = opt.update(g, rst, rp, jnp.int32(s))
        grads.append(_keyed(g))
        ref_losses.append(float(loss))
    res = port_train.train(smoke=True, device="cpu", steps=0, pretrain_steps=3,
                           verbose=False, return_state=True)
    setup = res["setup"]
    assert setup["pretrain_steps"] == 3
    np.testing.assert_allclose([setup["pretrain_first_loss"], setup["pretrain_last_loss"]],
                               [ref_losses[0], ref_losses[-1]], rtol=1e-6)
    got = dict(flatten_with_path(res["state"].params))
    start = dict(flatten_with_path(npp))
    for path, want in _keyed(rp).items():
        diff = np.abs(got[path].numpy() - want)
        g_min = np.minimum.reduce([np.abs(g[path]) / np.abs(g[path]).max() for g in grads])
        steady = g_min >= 1e-3
        assert diff[steady].max(initial=0.0) <= 1e-6, path
        assert diff.max() <= 2 * PRETRAIN_LR * 3, path
        assert np.abs(want - start[path]).max() > 1e-3, path  # the steps moved it


def test_fo_step_trains_and_counts_steps(init):
    """The port's own step: the loss falls over a few steps on one batch,
    and the state's step counts them."""
    params, _ = init
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    opt = adamw(lr=PRETRAIN_LR)
    state = init_fo_state(map_with_path(lambda _, w: w.clone(), params), opt)
    step = build_fo_train_step(model.fo_loss_fn, opt)
    batch = {k: _t(v) for k, v in _batch(0).items()}
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    assert state.step == 4 and losses[-1] < losses[0] - 0.1
    assert not any(w.requires_grad for _, w in flatten_with_path(state.params))


def test_fo_grads_repeat_across_runs(init):
    """Two backward passes from the same params and batch give bitwise
    equal gradients at a fixed thread count above one (the embedding's
    gradient sums in a fixed order; indexing's accumulating backward did
    not on the CPU)."""
    params, _ = init
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    batch = {k: _t(v) for k, v in _batch(0).items()}

    def grads():
        leaves = {p: w.clone().requires_grad_() for p, w in flatten_with_path(params)}
        loss = model.fo_loss_fn(map_with_path(lambda p, _: leaves[p], params), batch)
        return torch.autograd.grad(loss, list(leaves.values()))

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [grads() for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def _wrapper_calls():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    pages = torch.zeros(3, 4, 2, 16)
    bt, lens = torch.zeros(2, 2, dtype=torch.int32), torch.tensor([3, 5], dtype=torch.int32)
    x = torch.zeros(2, 5, 8, requires_grad=True)
    xq = torch.zeros(4, 8, requires_grad=True)
    return {
        "flash_attention": lambda: tflash.flash_attention(q, q.detach(), q.detach()),
        "paged_decode_attention": lambda: tdec.paged_decode_attention(q[0, :2], pages, pages,
                                                                      bt, lens),
        "paged_verify_attention": lambda: tdec.paged_verify_attention(q[0, :4].reshape(2, 2, 2, 16),
                                                                      pages, pages, bt, lens),
        "selective_scan": lambda: tscan.selective_scan(
            x, x.detach(), -torch.ones(8, 4), torch.zeros(2, 5, 4), torch.zeros(2, 5, 4),
            torch.zeros(2, 8, 4)),
        "quant_matmul": lambda: tqmm.quant_matmul(
            xq, torch.zeros(1, 6, dtype=torch.int32), torch.zeros(6, 16), torch.zeros(4, 2),
            torch.zeros(6, 2), bits=4),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrappers_raise_under_autograd(name):
    """No hand-written kernel has a backward: each wrapper refuses a call
    that autograd would record (an input that requires grad, grad mode on),
    on the CPU too, where it would run the plain version, so a path that
    differentiates must name the plain version.  Under no_grad it runs."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call()
    with torch.no_grad():
        if name != "quant_matmul":  # the others' operands above are valid
            call()


# --------------------------------------------------------------------------
# the hybrid and ssm families
# --------------------------------------------------------------------------

FAMILY_ARCHS = ["hymba-1.5b", "xlstm-350m"]
# each leaf's gradient within this share of its largest |g|: the file's
# 2e-6 for xLSTM; Hymba's 32-step selective scan and its dt path sum their
# backward in other orders than the reference's scan and einsums (seen:
# 2.0e-6 to 5.6e-6 on w_dt2, w_dt1, dt_bias and w_bc over three batches)
FAMILY_GRAD_ATOL = {"hymba-1.5b": 1e-5, "xlstm-350m": 2e-6}
# train()'s data at a shorter sequence and batch; 32 positions pass
# hymba-1.5b-smoke's window of 16
FAMILY_DATA = dict(seq_len=32, global_batch=4)


def _family_batch(s: int) -> dict:
    data = DataConfig(**FAMILY_DATA, vocab_size=128, seed=0)
    return batch_at_step(data, 10_000_000 + s)


@pytest.fixture(scope="module")
def family_init():
    """Per arch: the seed-0 smoke params on the CPU, and as numpy."""
    out = {}
    for arch in FAMILY_ARCHS:
        params = build_model(get_smoke_config(arch), device="cpu").init(PRNGKey(0))
        out[arch] = params, map_with_path(lambda _, w: w.numpy().copy(), params)
    return out


@pytest.fixture(scope="module")
def family_value_and_grad():
    fns = {}

    def run(arch, params, batch):
        if arch not in fns:
            fns[arch] = jax.jit(jax.value_and_grad(
                ref_build_model(ref_smoke_config(arch)).loss_fn))
        return fns[arch](params, {k: jnp.asarray(v) for k, v in batch.items()})

    return run


def _port_loss_and_grads(arch, params, batch):
    model = build_model(get_smoke_config(arch), device="cpu")
    leaves = {p: w.clone().requires_grad_() for p, w in flatten_with_path(params)}
    loss = model.fo_loss_fn(map_with_path(lambda p, _: leaves[p], params),
                            {k: _t(v) for k, v in batch.items()})
    return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_fo_loss_and_grads_match_reference(arch, family_init, family_value_and_grad):
    params, npp = family_init[arch]
    want_loss, want_g = family_value_and_grad(arch, jax.tree.map(jnp.asarray, npp),
                                              _family_batch(0))
    loss, grads = _port_loss_and_grads(arch, params, _family_batch(0))
    assert abs(loss.item() - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    want = _keyed(want_g)
    assert set(want) == set(grads)
    for path, g in grads.items():
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0,
                                   atol=FAMILY_GRAD_ATOL[arch] * scale, err_msg=path)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_hybrid_pretraining_matches_reference(arch, family_init, family_value_and_grad):
    """``train(pretrain_steps=2)`` on the hybrid and ssm families (which
    raised before their first-order losses were ported): the first and last
    pretraining losses against the reference's two AdamW steps."""
    _, npp = family_init[arch]
    opt = ref_adamw(lr=PRETRAIN_LR)
    rp = jax.tree.map(jnp.asarray, npp)
    rst, ref_losses = opt.init(rp), []
    for s in range(2):
        loss, g = family_value_and_grad(arch, rp, _family_batch(s))
        rp, rst = opt.update(g, rst, rp, jnp.int32(s))
        ref_losses.append(float(loss))
    res = port_train.train(arch=arch, smoke=True, device="cpu", steps=0, pretrain_steps=2,
                           verbose=False, return_state=True, **FAMILY_DATA)
    setup = res["setup"]
    np.testing.assert_allclose([setup["pretrain_first_loss"], setup["pretrain_last_loss"]],
                               ref_losses, rtol=1e-6)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_fo_grads_repeat_across_runs(arch, family_init):
    """As test_fo_grads_repeat_across_runs, at 4 threads."""
    params, _ = family_init[arch]
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [_port_loss_and_grads(arch, params, _family_batch(0))[1] for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(runs[0][p], runs[1][p]) for p in runs[0])
