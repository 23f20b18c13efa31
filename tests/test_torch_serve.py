"""The port's serving engine on the CPU (``opt-125m-smoke``): greedy token
streams of ``ServeEngine`` and ``BatchedServer`` against the reference's,
from bridged parameters on the same prompts; the solo == mixed contract
inside the port; scheduler invariants; page-budget truncation; the CLI.

The reference runs at ``kernel_mode="xla"`` as its own serving tests do.
Its paged-decode twin rounds softmax weights to bf16 (see
tests/test_torch_model.py), so logits differ from the port's by ~4e-3 on
this model; the assertion is on tokens, which agree."""

import json

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer, Request, ServeEngine, SlotScheduler
from repro_torch.models.bridge import params_from_numpy

from _torch_ref import numpy_params, to_jax

# one prefill bucket (16) keeps the reference engine's warmup compiles few
ENGINE_KW = dict(max_concurrent_decodes=3, max_prompt_len=16, max_new_tokens=8, page_size=16)
ARRIVALS = [0, 0, 0, 1, 6, 9]


@pytest.fixture(scope="session", autouse=True)
def _torch_one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("opt-125m")


@pytest.fixture(scope="module")
def np_params(cfg):
    return numpy_params(cfg, seed=0)


@pytest.fixture(scope="module")
def ref_params(np_params):
    return to_jax(np_params)


@pytest.fixture(scope="module")
def params(np_params):
    return params_from_numpy(np_params)


@pytest.fixture(scope="module")
def engine(cfg, params):
    eng = ServeEngine(cfg, params, device="cpu", **ENGINE_KW)
    eng.warmup()
    return eng


def _prompts():
    rng = np.random.default_rng(0)
    return [
        rng.integers(2, 256, size=n).astype(np.int32) for n in (5, 8, 13, 16, 3, 11)
    ]


def _trace(request_cls, max_new=6):
    """A staggered trace: r0-r2 fill every slot, r3 waits for an eviction
    (a mid-decode insertion), r4/r5 refill later evictions."""
    return [
        request_cls(id=f"r{i}", tokens=p, max_new=max_new, arrival=a)
        for i, (p, a) in enumerate(zip(_prompts(), ARRIVALS))
    ]


@pytest.fixture(scope="module")
def ref_streams(ref_params):
    """The reference engine's greedy streams on the trace."""
    eng = ref_serve.ServeEngine(ref_smoke_config("opt-125m"), ref_params, **ENGINE_KW)
    plain, _ = eng.serve(_trace(ref_serve.Request), step_clock=True)
    return {rid: r["tokens"] for rid, r in plain.items()}


@pytest.fixture(scope="module")
def mixed(engine):
    return engine.serve(_trace(Request), step_clock=True)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------


def test_engine_greedy_streams_match_reference(engine, mixed, ref_streams):
    """Staggered arrivals with slot churn: every request's tokens equal the
    reference engine's.  With an EOS id, every stream is the reference's
    cut after its first EOS (the reference engine's own EOS contract), and
    the evictions let the queue refill."""
    results, stats = mixed
    for i in range(6):
        np.testing.assert_array_equal(results[f"r{i}"]["tokens"], ref_streams[f"r{i}"])
    assert stats["emitted_tokens"] == stats["live_tokens"] == 36
    assert stats["compile_count"] == 0  # no kernel build on the CPU
    eos = int(ref_streams["r0"][2])  # r0 stops after 3 tokens
    engine.eos_id = eos
    try:
        res_eos, _ = engine.serve(_trace(Request), step_clock=True)
    finally:
        engine.eos_id = -1
    assert any(len(r["tokens"]) < 6 for r in res_eos.values())
    for i in range(6):
        full = ref_streams[f"r{i}"]
        hits = np.flatnonzero(full == eos)
        want = full[: hits[0] + 1] if hits.size else full
        np.testing.assert_array_equal(res_eos[f"r{i}"]["tokens"], want)
    engine.scheduler.check_invariants()
    assert engine.scheduler.occupied() == []


def test_batched_server_matches_reference(cfg, params, ref_params):
    """The static-batch oracle: greedy streams with EOS freezing equal the
    reference's."""
    prompts = np.stack([p[:5] for p in _prompts()[:4]])
    ref = ref_serve.BatchedServer(ref_smoke_config("opt-125m"), ref_params, max_len=24)
    want, _ = ref.generate(prompts, max_new_tokens=8)
    eos = int(want[1, 3])
    want_eos, _ = ref.generate(prompts, max_new_tokens=8, eos_id=eos)
    srv = BatchedServer(cfg, params, max_len=24, device="cpu")
    got, stats = srv.generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got, want)
    got_eos, _ = srv.generate(prompts, max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(got_eos, want_eos)
    assert {"prefill_s", "ttft_s", "decode_s", "live_tokens"} <= stats.keys()


# --------------------------------------------------------------------------
# the port's own contracts
# --------------------------------------------------------------------------


def test_solo_equals_mixed_bitwise(engine, mixed):
    """Each request served alone, on the engine whose pool the mixed trace
    churned, gives bitwise its mixed stream."""
    results, _ = mixed
    for i, p in enumerate(_prompts()):
        solo, _ = engine.serve([Request(id="solo", tokens=p, max_new=6)], step_clock=True)
        np.testing.assert_array_equal(solo["solo"]["tokens"], results[f"r{i}"]["tokens"])


def test_engine_matches_own_batched_server(engine, cfg, params):
    """At matched capacity and a bucket-exact prompt the paged engine equals
    the port's dense-cache BatchedServer."""
    prompt = _prompts()[3]
    res, _ = engine.serve([Request(id="o", tokens=prompt, max_new=8)], step_clock=True)
    srv = BatchedServer(cfg, params, max_len=engine.capacity, device="cpu")
    tokens, _ = srv.generate(prompt[None], max_new_tokens=8)
    np.testing.assert_array_equal(res["o"]["tokens"], tokens[0])


def test_temperature_stream_is_per_request(cfg, params):
    """Temperature sampling draws from each request's own (seed, position)
    stream: deterministic and independent of its neighbours."""

    def run(reqs):
        eng = ServeEngine(cfg, params, device="cpu", temperature=0.8,
                          max_concurrent_decodes=2, max_prompt_len=8,
                          max_new_tokens=6, page_size=8)
        return eng.serve(reqs, step_clock=True)[0]

    prompts = _prompts()[:3]

    def mk(i, arrival=0):
        return Request(id=f"t{i}", tokens=prompts[i][:8], max_new=5, seed=100 + i,
                       arrival=arrival)

    mixed = run([mk(0), mk(1, 1), mk(2, 2)])
    again = run([mk(0), mk(1, 1), mk(2, 2)])
    for i in range(3):
        np.testing.assert_array_equal(again[f"t{i}"]["tokens"], mixed[f"t{i}"]["tokens"])
        np.testing.assert_array_equal(run([mk(i)])[f"t{i}"]["tokens"],
                                      mixed[f"t{i}"]["tokens"])


def test_scheduler_random_trace_invariants():
    """Random insert / evict / decode-growth ops: after each one the page
    and slot invariants hold and live_tokens() is exact."""
    rng = np.random.default_rng(0)
    sched = SlotScheduler(n_slots=4, pages_per_slot=3, n_pages=13)
    resident: dict[str, int] = {}
    expected: dict[str, int] = {}
    for step in range(300):
        ops = (["insert"] if sched.has_free_slot() else []) + (
            ["evict", "decode"] if resident else []
        )
        op = rng.choice(ops)
        if op == "insert":
            rid = f"q{step}"
            resident[rid] = sched.insert(rid, int(rng.integers(1, 12)))
            expected[rid] = int(sched.lengths[resident[rid]])
        elif op == "evict":
            rid = str(rng.choice(list(resident)))
            assert sched.evict(resident.pop(rid)) == rid
            del expected[rid]
        else:
            for rid, slot in resident.items():
                sched.lengths[slot] += 1
                expected[rid] += 1
        sched.check_invariants()
        assert sched.live_tokens() == sum(expected.values())
    for rid in list(resident):
        sched.evict(resident.pop(rid))
    sched.check_invariants()
    assert sched.occupied() == [] and sched.live_tokens() == 0


def test_page_budget_truncation(engine, mixed):
    """A request whose max_new overruns its page quota is admitted with
    ``capacity - n + 1`` emissions and flagged; its neighbour is bitwise
    unaffected."""
    results, _ = mixed
    prompts = _prompts()
    assert engine.capacity == 32
    big = Request(id="big", tokens=prompts[3], max_new=20)  # 16 + 20 > 32
    normal = Request(id="n0", tokens=prompts[0], max_new=6)
    res, stats = engine.serve([big, normal], step_clock=True)
    assert res["big"]["truncated"] is True
    assert len(res["big"]["tokens"]) == engine.capacity - 16 + 1
    assert res["n0"]["truncated"] is False
    np.testing.assert_array_equal(res["n0"]["tokens"], results["r0"]["tokens"])
    assert stats["truncated_requests"] == 1
    with pytest.raises(ValueError, match="exceeds"):
        engine.serve([Request(id="x", tokens=np.zeros(17, np.int32))], step_clock=True)
    engine.scheduler.check_invariants()


def test_cli_smoke_on_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--engine", "--batch", "3",
                "--prompt-len", "10", "--max-new", "4"])
    stats = json.loads(capsys.readouterr().out)
    assert stats["requests"] == 3 and stats["emitted_tokens"] == 12
    assert stats["device"] == "cpu" and stats["spec_decode"] is False
    serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
                "--max-new", "3"])
    assert json.loads(capsys.readouterr().out)["generated_shape"] == [2, 3]
    with pytest.raises(SystemExit):  # the static-batch server has no verify path
        serve.main(["--smoke", "--device", "cpu", "--spec-decode"])
    assert "--spec-decode requires --engine" in capsys.readouterr().err
