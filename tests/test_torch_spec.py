"""The port's speculative decoding on the CPU (``opt-125m-smoke``), against
the reference.

* The verify kernel's plain version against the reference's Pallas verify
  kernel under the interpreter, at the reference's own test shapes
  (tests/test_decode_attention.py): f32 within 1e-5, bf16 within 2^-8
  relative.  At T = 1 it is bitwise the decode plain version (the CUDA
  kernels share one body for the same reason); the causal window mask and
  exact zeros for dead slots.  The fold-into-slots twin against the
  reference's twin.
* ``verify_step_paged`` from bridged parameters against the reference's
  at ``kernel_mode="pallas"`` under the interpreter, within 1e-4 on logits
  (the reference's XLA twin rounds softmax weights to the bf16 cache dtype,
  ROADMAP.md Queue C), its cache writes included.
* ``prompt_lookup_draft`` against the reference's on seeded histories.
* The engine: spec greedy streams equal the port's non-spec streams and the
  reference spec engine's at ``kernel_mode="xla"`` on the same churned
  trace; multi-token commits on a repetitive workload; temperature spec ==
  non-spec; truncation at the page budget with the window overhanging the
  slot's capacity; the CLI.  The assertions are on tokens, as the
  reference's own spec == non-spec contract is."""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro.models import layers as jlayers
from repro_torch.configs import get_smoke_config
from repro_torch.core import dispatch
from repro_torch.kernels import decode_attention as tdec
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeEngine, prompt_lookup_draft
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models.bridge import params_from_numpy

from _torch_ref import numpy_params, to_jax

# one prefill bucket (8 and 16), page 8 so windows straddle page edges
ENGINE_KW = dict(max_concurrent_decodes=3, max_prompt_len=16, max_new_tokens=8, page_size=8)
ARRIVALS = [0, 0, 0, 1, 6, 9]

VERIFY_CASES = [  # tests/test_decode_attention.py's
    # S, T, H, KV, dh, page_size, pages_per_slot, lengths
    (3, 4, 4, 4, 32, 8, 3, [5, 17, 21]),
    (2, 4, 8, 2, 32, 16, 2, [1, 29]),
    (4, 2, 4, 1, 64, 8, 2, [7, 15, 3, 8]),
    (2, 1, 4, 2, 40, 8, 2, [7, 13]),
    (3, 4, 4, 2, 32, 8, 2, [6, 0, 11]),
]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def force_interpret():
    ops.set_interpret(True)
    yield
    ops.set_interpret(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _verify_inputs(S, T, H, KV, dh, ps, pps, lengths, seed):
    rng = np.random.default_rng(seed)
    n_pages = S * pps + 1
    q = (rng.standard_normal((S, T, H, dh)) * 0.3).astype(np.float32)
    kp = (rng.standard_normal((n_pages, ps, KV, dh)) * 0.3).astype(np.float32)
    vp = (rng.standard_normal((n_pages, ps, KV, dh)) * 0.3).astype(np.float32)
    bt = (rng.permutation(n_pages - 1) + 1).astype(np.int32).reshape(S, pps)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


# --------------------------------------------------------------------------
# the verify kernel's plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("S,T,H,KV,dh,ps,pps,lengths", VERIFY_CASES)
def test_verify_plain_vs_reference_kernel(force_interpret, S, T, H, KV, dh, ps, pps, lengths):
    """f32, shuffled tables, MHA / GQA / MQA, page-straddling windows, a
    window reaching past capacity (29 + 3 > 2 x 16), dh = 40, a dead slot:
    within 1e-5 of the Pallas kernel, dead slots exact zeros on both."""
    args = _verify_inputs(S, T, H, KV, dh, ps, pps, lengths, seed=S * 100 + T * 10 + dh)
    got = tdec.paged_verify_attention_plain(*map(_t, args)).numpy()
    want = np.asarray(ops.paged_verify_attention(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    dead = np.asarray(lengths) == 0
    assert np.all(got[dead] == 0.0) and np.all(want[dead] == 0.0)


def test_verify_plain_bf16_vs_reference_kernel(force_interpret):
    """bf16 q and pages (the serving cache dtype): within 2^-8 relative."""
    q, kp, vp, bt, lens = _verify_inputs(2, 4, 4, 2, 32, 8, 2, [5, 12], seed=7)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp))
    want = np.asarray(ops.paged_verify_attention(qb, kb, vb, jnp.asarray(bt),
                                                 jnp.asarray(lens)), np.float32)
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, kp, vp))
    got = tdec.paged_verify_attention_plain(tq, tk, tv, _t(bt), _t(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-8, atol=1e-6)


def test_verify_t1_is_decode_bitwise():
    """A one-token window is a decode step, bit for bit; so are the CPU
    wrappers and dispatch, and the counters do not move on the CPU."""
    q, kp, vp, bt, lens = map(_t, _verify_inputs(3, 1, 4, 2, 32, 8, 2, [5, 9, 16], seed=23))
    n_dec, n_ver = tdec.paged_decode_attention.launches, tdec.paged_verify_attention.launches
    win = tdec.paged_verify_attention(q, kp, vp, bt, lens)
    assert torch.equal(win[:, 0], tdec.paged_decode_attention(q[:, 0], kp, vp, bt, lens))
    assert torch.equal(win, dispatch.verify_attention_fwd(q, kp, vp, bt, lens))
    assert torch.equal(win, tdec.paged_verify_attention_plain(q, kp, vp, bt, lens))
    assert torch.equal(tlayers.paged_verify_attention_ref(q, kp, vp, bt, lens)[:, 0],
                       tlayers.paged_decode_attention_ref(q[:, 0], kp, vp, bt, lens))
    assert (tdec.paged_decode_attention.launches, tdec.paged_verify_attention.launches) == (
        n_dec, n_ver)


def test_verify_causal_window_and_dead_slots():
    """Position t sees exactly lengths + t positions: it equals a decode at
    length lengths + t, and it changes when the KV at position lengths + t
    - 1 (its own draft token's) changes while position t - 1 does not.
    Dead slots are exact zeros whatever their table row holds."""
    S, T = 3, 3
    q, kp, vp, bt, lens = map(_t, _verify_inputs(S, T, 4, 2, 32, 8, 2, [6, 0, 10], seed=31))
    out = tdec.paged_verify_attention_plain(q, kp, vp, bt, lens)
    assert torch.all(out[1] == 0.0)
    for t in range(T):
        dec = tdec.paged_decode_attention_plain(q[:, t].contiguous(), kp, vp, bt,
                                                torch.where(lens > 0, lens + t, 0))
        torch.testing.assert_close(out[:, t], dec, rtol=0, atol=1e-6)
    kp2 = kp.clone()
    pos = int(lens[0]) + 1  # the KV window position 2 adds over position 1
    kp2[bt[0, pos // 8], pos % 8] += 1.0
    out2 = tdec.paged_verify_attention_plain(q, kp2, vp, bt, lens)
    assert torch.equal(out2[0, :2], out[0, :2]) and not torch.equal(out2[0, 2], out[0, 2])


@pytest.mark.parametrize("S,T,H,KV,dh,ps,pps,lengths", VERIFY_CASES[:2] + VERIFY_CASES[4:])
def test_verify_twin_vs_reference_twin(S, T, H, KV, dh, ps, pps, lengths):
    """The ported fold-into-slots twin == the reference's on live slots (dead
    slots are twin-only uniform softmaxes, as for the decode twin)."""
    args = _verify_inputs(S, T, H, KV, dh, ps, pps, lengths, seed=S * 17 + dh)
    got = tlayers.paged_verify_attention_ref(*map(_t, args)).numpy()
    want = np.asarray(jax.jit(jlayers.paged_verify_attention_ref)(*map(jnp.asarray, args)))
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# the model's verify step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("opt-125m")


@pytest.fixture(scope="module")
def np_params(cfg):
    return numpy_params(cfg, seed=0)


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params)


@pytest.fixture(scope="module")
def ref_params(np_params):
    return to_jax(np_params)


def test_verify_step_paged_matches_reference(cfg, params, ref_params):
    """A 3-token window per slot over a prefilled cache: a dead slot, a
    mid-page slot and a slot whose window overhangs its capacity (writes
    past it land on the null page), against the reference's verify step
    with the Pallas verify kernel under the interpreter: logits within
    1e-4, every live cache entry equal."""
    model = build_model(cfg, device="cpu")
    pallas = ref_build_model(replace(ref_smoke_config("opt-125m"), kernel_mode="pallas"))
    ps, P = 8, 2
    bt = np.asarray([[4, 2], [1, 5], [3, 6], [0, 0]], np.int32)
    rng = np.random.default_rng(2)
    tcache = model.init_paged_cache(7, ps)
    for s, n in enumerate([5, 13, 15]):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :n] = rng.integers(2, 256, size=n)
        _, tk, tv = model.prefill_paged(params, _t(prompt), n)
        model.insert_pages(tcache, tk, tv, _t(bt[s].astype(np.int64)))
    jcache = {n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for n, t in tcache.items()}
    lens = np.asarray([5, 13, 15, 0], np.int32)
    tokens = rng.integers(2, 256, size=(4, 3)).astype(np.int32)
    ops.set_interpret(True)
    try:
        jl, jcache = jax.jit(pallas.verify_step_paged)(
            ref_params, jcache, jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(tokens))
    finally:
        ops.set_interpret(None)
    assert lens[2] + 3 > P * ps  # the window overhangs this slot's capacity
    tl, tcache = model.verify_step_paged(params, tcache, _t(bt), _t(lens), _t(tokens))
    assert tl.shape == (4, 3, cfg.vocab_size)
    live = lens > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=0, atol=1e-4)
    for name in ("k", "v"):  # pages 1..6 (page 0 takes the dead and overhanging writes)
        np.testing.assert_allclose(tcache[name][:, 1:].float().numpy(),
                                   np.asarray(jcache[name][:, 1:], np.float32),
                                   rtol=2.0**-8, atol=1e-6)


def test_verify_window_is_bitwise_decode_steps(cfg, params):
    """Each window position's logits are bitwise those of the decode step
    at its length (bf16 model): the verify step runs the decode step's
    shapes per position, so no GEMM rounds a row otherwise."""
    model = build_model(cfg.reduced(dtype="bfloat16"), device="cpu")
    pb = {k: ({n: w.to(torch.bfloat16) for n, w in v.items()} if isinstance(v, dict)
              else v.to(torch.bfloat16)) for k, v in params.items()}
    bt = torch.tensor([[1, 2], [3, 4], [0, 0]], dtype=torch.int32)
    cache = model.init_paged_cache(5, 8)
    rng = np.random.default_rng(4)
    for s, n in enumerate([6, 9]):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :n] = rng.integers(2, 256, size=n)
        _, k, v = model.prefill_paged(pb, _t(prompt), n)
        model.insert_pages(cache, k, v, bt[s].long())
    lens = torch.tensor([6, 9, 0], dtype=torch.int32)
    window = _t(rng.integers(2, 256, size=(3, 4)).astype(np.int32))
    ver, cache = model.verify_step_paged(pb, cache, bt, lens, window)
    for t in range(4):
        dec, _ = model.decode_step_paged(pb, cache, bt, torch.where(lens > 0, lens + t, 0),
                                         window[:, t].contiguous())
        assert torch.equal(ver[:2, t], dec[:2]), t


def test_prompt_lookup_draft_matches_reference():
    rng = np.random.default_rng(11)
    for _ in range(200):
        n = int(rng.integers(0, 24))
        hist = [int(x) for x in rng.integers(0, 5, size=n)]
        d = int(rng.integers(0, 6))
        assert prompt_lookup_draft(hist, d) == ref_serve.prompt_lookup_draft(hist, d)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(2, 256, size=n).astype(np.int32) for n in (5, 8, 13, 16, 3, 11)]


def _trace(request_cls, max_new=6):
    return [request_cls(id=f"r{i}", tokens=p, max_new=max_new, arrival=a)
            for i, (p, a) in enumerate(zip(_prompts(), ARRIVALS))]


def _repetitive(request_cls, tag):
    """A low-entropy workload (tokens 2 and 3) on which the prompt-lookup
    drafter lands with these weights."""
    rng = np.random.default_rng(1)
    return [request_cls(id=f"{tag}{i}", tokens=rng.integers(2, 4, size=n).astype(np.int32),
                        max_new=8) for i, n in enumerate((9, 12, 6, 14))]


@pytest.fixture(scope="module")
def engines(cfg, params):
    base = ServeEngine(cfg, params, device="cpu", **ENGINE_KW)
    spec = ServeEngine(cfg, params, device="cpu", spec_decode=True, draft_len=4, **ENGINE_KW)
    return base, spec


@pytest.fixture(scope="module")
def ref_spec_streams(ref_params):
    """The reference spec engine at kernel_mode="xla" on the churned trace
    and on the repetitive workload."""
    eng = ref_serve.ServeEngine(ref_smoke_config("opt-125m"), ref_params, spec_decode=True,
                                draft_len=4, **ENGINE_KW)
    churn, _ = eng.serve(_trace(ref_serve.Request), step_clock=True)
    rep, rep_stats = eng.serve(_repetitive(ref_serve.Request, "s"), step_clock=True)
    return ({rid: r["tokens"] for rid, r in churn.items()},
            {rid: r["tokens"] for rid, r in rep.items()}, rep_stats)


def test_spec_greedy_matches_nonspec_and_reference(engines, ref_spec_streams):
    """Staggered arrivals with slot churn: the spec engine's tokens equal
    the port's non-spec engine's and the reference spec engine's, request
    for request; speculation only shrinks the step count."""
    base, spec = engines
    b_res, b_stats = base.serve(_trace(Request), step_clock=True)
    s_res, s_stats = spec.serve(_trace(Request), step_clock=True)
    want, _, _ = ref_spec_streams
    for i in range(6):
        rid = f"r{i}"
        np.testing.assert_array_equal(s_res[rid]["tokens"], b_res[rid]["tokens"], err_msg=rid)
        np.testing.assert_array_equal(s_res[rid]["tokens"], want[rid], err_msg=rid)
    assert s_stats["spec_decode"] is True and s_stats["draft_len"] == 4
    assert s_stats["emitted_tokens"] == b_stats["emitted_tokens"] == 36
    assert s_stats["decode_steps"] <= b_stats["decode_steps"]
    spec.scheduler.check_invariants()
    assert spec.scheduler.occupied() == []


def test_spec_commits_multi_token_steps(engines, ref_spec_streams):
    """On a repetitive workload drafts are proposed and accepted, a verify
    commits more than one token on average, the engine takes fewer steps,
    and the streams still equal the non-spec engine's and the reference's
    (with the reference's acceptance counts)."""
    base, spec = engines
    b_res, b_stats = base.serve(_repetitive(Request, "b"), step_clock=True)
    s_res, s_stats = spec.serve(_repetitive(Request, "s"), step_clock=True)
    _, want, ref_stats = ref_spec_streams
    assert s_stats["proposed_tokens"] > 0 and s_stats["accepted_tokens"] > 0, s_stats
    assert s_stats["decode_steps"] < b_stats["decode_steps"]
    assert 0.0 < s_stats["acceptance_rate"] <= 1.0 and s_stats["tok_per_verify"] > 1.0
    for key in ("proposed_tokens", "accepted_tokens", "decode_steps"):
        assert s_stats[key] == ref_stats[key], key
    for i in range(4):
        np.testing.assert_array_equal(s_res[f"s{i}"]["tokens"], b_res[f"b{i}"]["tokens"])
        np.testing.assert_array_equal(s_res[f"s{i}"]["tokens"], want[f"s{i}"])


def test_spec_temperature_replays_nonspec(cfg, params):
    """Under temperature window position t draws from the stream of emitted
    position generated + t, so the sampled spec stream is the non-spec
    one, token for token, on a workload where a draft is accepted (so a
    window position past 0 supplies an emitted token's draw), at
    temperatures 0.2 and 0.8.  The smoke model's lm_head is scaled 8-fold
    so that its samples repeat often enough for drafts to be accepted."""
    sharp = {**params, "lm_head": params["lm_head"] * 8.0}

    def run(spec, temperature):
        eng = ServeEngine(cfg, sharp, device="cpu", max_concurrent_decodes=2,
                          max_prompt_len=8, max_new_tokens=16, page_size=8,
                          temperature=temperature, spec_decode=spec, draft_len=3)
        rng = np.random.default_rng(1)
        reqs = [Request(id=f"t{i}", tokens=rng.integers(2, 4, size=6).astype(np.int32),
                        max_new=16, seed=200 + i, arrival=float(i)) for i in range(3)]
        return eng.serve(reqs, step_clock=True)

    for temperature in (0.2, 0.8):
        (base, _), (spec, stats) = run(False, temperature), run(True, temperature)
        assert stats["accepted_tokens"] > 0, (temperature, stats)
        for i in range(3):
            np.testing.assert_array_equal(spec[f"t{i}"]["tokens"], base[f"t{i}"]["tokens"])


def test_spec_truncation_and_eos(engines):
    """A request whose budget overruns its page quota is truncated to it as
    in the non-spec engine, with the verify window overhanging capacity on
    its last steps; an EOS inside an accepted run cuts the commit after it."""
    base, spec = engines
    assert spec.capacity == 24  # the 16-token bucket + 8 new, in pages of 8
    rng = np.random.default_rng(3)
    big = rng.integers(2, 4, size=16).astype(np.int32)  # repetitive: long commits
    reqs = lambda: [Request(id="big", tokens=big, max_new=30),  # noqa: E731
                    Request(id="n", tokens=big[:7], max_new=6)]
    b_res, _ = base.serve(reqs(), step_clock=True)
    s_res, s_stats = spec.serve(reqs(), step_clock=True)
    assert s_res["big"]["truncated"] is True and s_stats["truncated_requests"] == 1
    assert len(s_res["big"]["tokens"]) == spec.capacity - 16 + 1
    for rid in ("big", "n"):
        np.testing.assert_array_equal(s_res[rid]["tokens"], b_res[rid]["tokens"])
    eos = int(b_res["big"]["tokens"][5])
    base.eos_id = spec.eos_id = eos
    try:
        b_eos, _ = base.serve(reqs(), step_clock=True)
        s_eos, _ = spec.serve(reqs(), step_clock=True)
    finally:
        base.eos_id = spec.eos_id = -1
    for rid in ("big", "n"):
        np.testing.assert_array_equal(s_eos[rid]["tokens"], b_eos[rid]["tokens"])
        assert s_eos[rid]["tokens"][-1] == eos or len(s_eos[rid]["tokens"]) == 6
    spec.scheduler.check_invariants()


def test_spec_cli_on_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--engine", "--spec-decode", "--batch", "3",
                "--prompt-len", "10", "--max-new", "4", "--draft-len", "3"])
    stats = json.loads(capsys.readouterr().out)
    assert stats["spec_decode"] is True and stats["draft_len"] == 3
    assert stats["requests"] == 3 and stats["emitted_tokens"] == 12
    with pytest.raises(ValueError, match="draft_len"):
        ServeEngine(get_smoke_config("opt-125m"), device="cpu", spec_decode=True, draft_len=0)
