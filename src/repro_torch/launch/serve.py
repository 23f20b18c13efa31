"""Serving: a continuous-batching engine over a paged KV cache, plus the
static-batch driver it is checked against (counterpart of
``repro.launch.serve``).

``ServeEngine``:

* **Prefill buckets.** Prompts pad (after the prompt — causal masking makes
  the tail inert) to power-of-two buckets; ``warmup()`` builds the CUDA
  kernels, allocates the page pool and runs every bucket once.  PyTorch
  runs eagerly, so there is no compile to cache: ``compile_count`` counts
  the kernel-library builds (``nvcc``) the engine triggered — 0 on the CPU
  and when ``build/repro_torch/`` already holds a build of these sources —
  and it does not grow after ``warmup()``.
* **Slots + page table.** Decode state is persistent at
  ``max_concurrent_decodes`` slots over a shared KV page pool
  (``[L, n_pages, page_size, KV, dh]``).  Each slot owns a fixed set of
  physical pages recorded in a host-side block table; insert/evict is a
  page-table edit, never a cache copy.  Page 0 is the null page that free
  slots' decode writes land on.
* **Paged decode kernel.** Each step runs one fixed-shape
  ``verify_step_paged`` over all slots; without speculative decoding its
  window is one token, which is ``decode_step_paged``, and on the card its
  attention is the hand-written paged decode kernel.  Prefill attention is
  the flash kernel.
* **Speculative decoding** (``spec_decode=True``).  Each step drafts up to
  ``draft_len`` tokens per slot by prompt lookup (:func:`prompt_lookup_draft`,
  a pure function of the request's own history), scores the whole window in
  one ``verify_step_paged`` forward (on the card the paged verify kernel)
  and commits the longest draft prefix the model re-derives plus one bonus
  token.  The window's KV is written optimistically and a rejected tail is
  rolled back by the slot's length pointer alone.
* **Threaded detokenize.** Emitted tokens go to a daemon worker through an
  unbounded queue; the backlog drains at ``finish()``.
* **Page-budget exhaustion.** A request whose ``max_new`` overruns its
  slot's page quota is admitted with a truncated emission budget, flagged
  in its result and in stats.

Every per-slot op in the decode and verify steps is row-independent, so a
request's token stream is bitwise-identical whether it is served alone or
next to arbitrary other requests; except on the ``moe`` family, whose
capacity-bounded routing couples the rows of a call (pad and dead-slot
tokens take capacity too), in the reference as here, and which therefore
serves without speculative decoding.  Greedy decoding is ``argmax``.
Temperature sampling replays the reference's ``jax.random.categorical``
(``utils.jax_random``) on the logits' device: the draw for a request's emitted
position p is keyed ``fold_in(threefry_key(seed), p)``, so a request's
stream does not depend on its neighbours either, and its tokens are the
reference's for equal logits, on the card as on the CPU.  A verify
window's position t draws with the key of emitted position
``generated + t``, the draw the non-spec loop makes there, so a sampled
spec stream replays the non-spec stream token for token.

``BatchedServer`` serves every family with ``prefill`` / ``decode_step``
(the dense, hybrid and ssm ones); ``ServeEngine`` takes only models with
the paged decode path, and raises for the recurrent (hybrid and ssm)
families as the reference does.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-125m \
        --engine --batch 8 --prompt-len 32 --max-new 16 [--spec-decode] \
        [--device cpu --smoke]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
        --engine                              # 14.8 B params, bf16, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
        --engine --layers 2                   # full width, depth cut to 2 layers
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        [--device cpu --smoke]                # BatchedServer
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        [--device cpu --smoke]                # BatchedServer, the recurrent state as cache
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.utils import jax_random


@dataclass
class Request:
    """One serving request.  ``arrival`` is seconds since serve() start
    (wall-clock admission), or a decode-step index under ``step_clock``
    (deterministic tests); ``seed`` keys the per-request sampling stream."""

    id: str
    tokens: np.ndarray
    max_new: int = 16
    arrival: float = 0.0
    seed: int = 0


@dataclass
class _Live:
    """Host-side state of a request occupying a slot.  ``budget`` is the
    emission budget actually granted (``req.max_new``, or less when the
    slot's page quota can't hold it — then ``truncated`` is set)."""

    req: Request
    slot: int
    generated: int = 0
    budget: int = 0
    truncated: bool = False
    history: list = field(default_factory=list)


def prompt_lookup_draft(history, draft_len: int, max_ngram: int = 3) -> list:
    """Model-free prompt-lookup drafter (PLD / n-gram speculation).

    Finds the longest n-gram (n <= ``max_ngram``) ending the history that
    also occurred earlier, preferring the most recent earlier occurrence,
    and proposes up to ``draft_len`` of the tokens that followed it.  A pure
    function of the request's own history, so the engine's solo == mixed
    identity survives speculation.  Returns [] when no n-gram repeats (the
    engine then verifies a 1-token window, which is a decode step)."""
    L = len(history)
    if L < 2 or draft_len <= 0:
        return []
    for n in range(min(max_ngram, L - 1), 0, -1):
        suffix = history[L - n:]
        for start in range(L - n - 1, -1, -1):
            if history[start:start + n] == suffix:
                return list(history[start + n:start + n + draft_len])
    return []


class SlotScheduler:
    """Host-side slot and page-table bookkeeping for the engine.

    Invariants (``check_invariants`` asserts them):

    * no double-occupancy: a request id occupies at most one slot;
    * every occupied slot owns exactly ``pages_per_slot`` distinct physical
      pages, disjoint from every other slot's and from the free list;
    * free pages ∪ owned pages == {1 .. n_pages-1} (page 0 is the reserved
      null page and is never owned);
    * ``live_tokens()`` equals the sum of occupied slots' lengths, exactly.

    Pages are handed out from a FIFO free list that evictions append to, so
    long-running traces shuffle the physical layout.
    """

    def __init__(self, n_slots: int, pages_per_slot: int, n_pages: int):
        assert n_pages >= n_slots * pages_per_slot + 1, (n_pages, n_slots, pages_per_slot)
        self.n_slots = n_slots
        self.pages_per_slot = pages_per_slot
        self.n_pages = n_pages
        self.block_tables = np.zeros((n_slots, pages_per_slot), np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.requests: list[str | None] = [None] * n_slots
        self._free_slots: deque[int] = deque(range(n_slots))
        self._free_pages: deque[int] = deque(range(1, n_pages))

    def has_free_slot(self) -> bool:
        return bool(self._free_slots)

    def occupied(self) -> list[int]:
        return [s for s in range(self.n_slots) if self.requests[s] is not None]

    def insert(self, req_id: str, n_tokens: int) -> int:
        """Claim a free slot and its page quota for ``req_id``; returns the
        slot."""
        assert self._free_slots, "insert with no free slot"
        assert req_id not in self.requests, f"{req_id} already resident"
        slot = self._free_slots.popleft()
        pages = [self._free_pages.popleft() for _ in range(self.pages_per_slot)]
        self.block_tables[slot] = pages
        self.lengths[slot] = n_tokens
        self.requests[slot] = req_id
        return slot

    def evict(self, slot: int) -> str:
        """Release a slot: its pages go back on the free list, the table row
        points at the null page."""
        rid = self.requests[slot]
        assert rid is not None, f"evict of free slot {slot}"
        self._free_pages.extend(int(p) for p in self.block_tables[slot])
        self.block_tables[slot] = 0
        self.lengths[slot] = 0
        self.requests[slot] = None
        self._free_slots.append(slot)
        return rid

    def live_tokens(self) -> int:
        return int(self.lengths.sum())

    def check_invariants(self) -> None:
        occ = self.occupied()
        rids = [self.requests[s] for s in occ]
        assert len(rids) == len(set(rids)), f"double-occupancy: {rids}"
        owned: list[int] = []
        for s in range(self.n_slots):
            row = [int(p) for p in self.block_tables[s]]
            if self.requests[s] is None:
                assert row == [0] * self.pages_per_slot, (s, row)
                assert self.lengths[s] == 0, (s, self.lengths[s])
            else:
                owned.extend(row)
        free = list(self._free_pages)
        assert 0 not in owned and 0 not in free, "null page leaked"
        combined = owned + free
        assert len(combined) == len(set(combined)), "page owned twice"
        assert set(combined) == set(range(1, self.n_pages)), "page lost"
        assert sorted(occ + list(self._free_slots)) == list(range(self.n_slots))


class _DetokenizeWorker(threading.Thread):
    """Daemon thread draining emitted (request, token, time) triples; the
    decode loop's ``put`` never blocks."""

    def __init__(self, detokenize):
        super().__init__(daemon=True)
        self._q: queue.Queue = queue.Queue()
        self._detok = detokenize
        self.results: dict[str, dict] = {}

    def put(self, rid: str, token: int, t: float) -> None:
        self._q.put((rid, token, t))

    def run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            rid, tok, t = item
            r = self.results.setdefault(rid, {"tokens": [], "text": [], "times": []})
            r["tokens"].append(tok)
            r["text"].append(self._detok(tok))
            r["times"].append(t)
            self._q.task_done()

    def finish(self) -> dict[str, dict]:
        self._q.put(None)
        self._q.join()
        self.join()
        return self.results


def threefry_key(seed: int) -> tuple[int, int]:
    """The raw Threefry key of a request's ``seed`` (the reference's
    ``_threefry_key``: the seed's high and low 32-bit words)."""
    return (seed >> 32) & jax_random.MASK, seed & jax_random.MASK


def _sample_rows(logits: torch.Tensor, temperature: float, keys) -> np.ndarray:
    """``jax.random.categorical(key, row / temperature)`` for every row of
    ``logits`` [R, V] on the logits' device, row i keyed ``keys[i]`` ([R,
    2]), or one draw of the whole [R, V] under one key.  The division runs
    in the logits' dtype with the temperature cast to it, as the
    reference's weakly typed ``row / temperature``; only the R token ids
    leave the device."""
    logits = logits.detach()
    t = torch.tensor(temperature, dtype=logits.dtype).float()
    scaled = (logits.float() / t).to(logits.dtype)
    return jax_random.categorical(keys, scaled).cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Continuous-batching serving engine (see module docstring)."""

    def __init__(
        self,
        cfg,
        params=None,
        *,
        max_concurrent_decodes: int = 4,
        max_prompt_len: int = 64,
        max_new_tokens: int = 32,
        page_size: int = 16,
        eos_id: int = -1,
        temperature: float = 0.0,
        seed: int = 0,
        detokenize=None,
        spec_decode: bool = False,
        draft_len: int = 4,
        device: str | torch.device = "cuda",
    ):
        assert page_size > 0 and page_size & (page_size - 1) == 0, page_size
        if spec_decode and draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        if spec_decode and cfg.n_experts > 0:
            raise NotImplementedError(
                f"speculative decoding on the moe family ({cfg.name}) is not ported "
                "(ROADMAP.md Queue C item 2): the reference routes a verify window's "
                "S·T tokens under one capacity, the port's per-position verify S at a "
                "time, and the reference's own spec tokens differ from its non-spec ones"
            )
        self.cfg = cfg
        self.model = build_model(cfg, device)
        if not self.model.supports_paged_decode:
            raise ValueError(
                f"family {cfg.family!r} has no paged decode path; use "
                "BatchedServer for the recurrent families"
            )
        self.device = self.model.device
        self.params = (
            params
            if params is not None
            else self.model.init(jax_random.PRNGKey(seed))
        )
        self.n_slots = max_concurrent_decodes
        self.page_size = page_size
        self.eos_id = eos_id
        self.temperature = temperature
        self.spec_decode = spec_decode
        self.draft_len = draft_len if spec_decode else 0
        self._detok = detokenize or (lambda t: f"<{t}>")

        bucket_cap = page_size
        while bucket_cap < max_prompt_len:
            bucket_cap *= 2
        self.buckets: list[int] = []
        b = page_size
        while b <= bucket_cap:
            self.buckets.append(b)
            b *= 2
        cap = bucket_cap + max_new_tokens
        self.pages_per_slot = -(-cap // page_size)
        self.capacity = self.pages_per_slot * page_size
        self._n_pool = self.n_slots * self.pages_per_slot + 1
        self.scheduler = SlotScheduler(self.n_slots, self.pages_per_slot, self._n_pool)
        self.cache = None
        self._compile_count = 0

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Kernel-library builds (nvcc runs) this engine triggered; frozen
        once warmup() has run."""
        return self._compile_count

    def warmup(self) -> None:
        """Build the kernels, allocate the page pool and run every prefill
        bucket and one decode step (with ``spec_decode``, one verify step)
        once.  That step runs with every slot free, so its writes land on
        the null page."""
        if self.cache is not None:
            return
        if self.device.type == "cuda":
            before = _build.builds
            _build.load()
            self._compile_count += _build.builds - before
        self.cache = self.model.init_paged_cache(self._n_pool, self.page_size)
        dev = self.device
        for bkt in self.buckets:
            tokens = torch.zeros((1, bkt), dtype=torch.int32, device=dev)
            self.model.prefill_paged(self.params, tokens, 1)
        S, P = self.n_slots, self.pages_per_slot
        zeros = torch.zeros((S,), dtype=torch.int32, device=dev)
        tables = torch.zeros((S, P), dtype=torch.int32, device=dev)
        window = torch.zeros((S, self.draft_len + 1), dtype=torch.int32, device=dev)
        self.model.verify_step_paged(self.params, self.cache, tables, zeros, window)
        _sync(dev)

    # ------------------------------------------------------------------
    # serve loop
    # ------------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for bkt in self.buckets:
            if n <= bkt:
                return bkt
        raise ValueError(f"prompt length {n} exceeds the largest bucket {self.buckets[-1]}")

    def _sample(self, logits: torch.Tensor, slots: list[int], lives: list[_Live]):
        """[len(slots), T] next tokens over a window (``logits`` [S, T, V]):
        greedy argmax, or window position t of a slot drawn with its
        request's key folded with emitted position ``generated + t``."""
        if self.temperature <= 0.0:
            toks = torch.argmax(logits, dim=-1).cpu().numpy()
            return toks[slots]
        rows = logits[slots]
        T = rows.shape[1]
        keys = [jax_random.fold_in(threefry_key(lv.req.seed), lv.generated + t)
                for lv in lives for t in range(T)]
        toks = _sample_rows(rows.reshape(len(lives) * T, -1), self.temperature, keys)
        return toks.astype(np.int64).reshape(len(lives), T)

    def _admit(self, req: Request, worker, live: dict, fed: np.ndarray, clock):
        """Prefill + first sample for ``req``; returns (first-token time,
        truncated).  The emission budget ``capacity - n + 1`` is exact
        because the final emitted token needs no KV slot."""
        n = int(len(req.tokens))
        bkt = self._bucket_for(n)
        budget = min(req.max_new, self.capacity - n + 1)
        padded = np.zeros((1, bkt), np.int32)
        padded[0, :n] = np.asarray(req.tokens, np.int32)
        logits, k_new, v_new = self.model.prefill_paged(
            self.params, torch.from_numpy(padded).to(self.device), n
        )
        slot = self.scheduler.insert(req.id, n)
        page_ids = self.scheduler.block_tables[slot][: bkt // self.page_size]
        self.model.insert_pages(
            self.cache, k_new, v_new, torch.from_numpy(page_ids.astype(np.int64)).to(self.device)
        )
        lv = _Live(req=req, slot=slot, budget=budget, truncated=budget < req.max_new,
                   history=[int(t) for t in req.tokens])
        tok0 = int(self._sample(logits[:, None], [0], [lv])[0, 0])
        lv.generated = 1
        lv.history.append(tok0)
        t_first = clock()
        worker.put(req.id, tok0, t_first)
        fed[slot] = tok0
        live[slot] = lv
        if (self.eos_id >= 0 and tok0 == self.eos_id) or lv.budget <= 1:
            self.scheduler.evict(slot)
            del live[slot]
            fed[slot] = 0
        return t_first, lv.truncated

    def serve(self, requests: list[Request], *, step_clock: bool = False) -> tuple[dict, dict]:
        """Serve a workload to completion.  Requests are admitted once their
        ``arrival`` has passed (wall seconds, or decode-step index under
        ``step_clock``) and a slot is free, in arrival order.  Returns
        (per-request results, aggregate stats)."""
        self.warmup()
        sched = self.scheduler
        dev = self.device
        pending: deque[Request] = deque(sorted(requests, key=lambda r: r.arrival))
        worker = _DetokenizeWorker(self._detok)
        worker.start()
        live: dict[int, _Live] = {}
        fed = np.zeros((self.n_slots,), np.int32)
        ttft: dict[str, float] = {}
        queue_t: dict[str, float] = {}
        truncated: dict[str, bool] = {}
        t0 = time.perf_counter()
        step = 0
        emitted = 0
        decode_emitted = spec_proposed = spec_accepted = 0

        def clock():
            return float(step) if step_clock else time.perf_counter() - t0

        while pending or live:
            now = clock()
            while pending and pending[0].arrival <= now and sched.has_free_slot():
                req = pending.popleft()
                queue_t[req.id] = clock() - req.arrival
                t_first, trunc = self._admit(req, worker, live, fed, clock)
                ttft[req.id] = t_first - req.arrival
                truncated[req.id] = trunc
                emitted += 1
            if not live:
                if step_clock:
                    step += 1
                else:
                    time.sleep(1e-4)
                continue
            tables = torch.from_numpy(sched.block_tables.copy()).to(dev)
            lengths = torch.from_numpy(sched.lengths.copy()).to(dev)
            slots = list(live)
            drafts, toks = self._verify(tables, lengths, fed, live, slots)
            step += 1
            n_em, n_prop, n_acc = self._accept(drafts, toks, fed, live, slots, worker, clock())
            emitted += n_em
            decode_emitted += n_em
            spec_proposed += n_prop
            spec_accepted += n_acc
        wall = time.perf_counter() - t0
        raw = worker.finish()
        results = {
            rid: {
                "tokens": np.asarray(r["tokens"], np.int32),
                "text": "".join(r["text"]),
                "times": r["times"],
                "ttft_s": ttft[rid],
                "queue_time_s": queue_t[rid],
                "truncated": truncated[rid],
            }
            for rid, r in raw.items()
        }
        ttfts = sorted(ttft.values())
        queues = sorted(queue_t.values())

        def _pct(xs, q):
            return round(1e3 * float(np.percentile(xs, q)), 3) if xs else 0.0

        stats = {
            "requests": len(requests),
            "emitted_tokens": emitted,
            "live_tokens": int(sum(len(r["tokens"]) for r in results.values())),
            "decode_steps": step,
            "wall_s": round(wall, 4),
            "tok_per_s": round(emitted / max(wall, 1e-9), 1),
            "ttft_p50_ms": _pct(ttfts, 50),
            "ttft_p99_ms": _pct(ttfts, 99),
            "queue_p50_ms": _pct(queues, 50),
            "queue_p99_ms": _pct(queues, 99),
            "truncated_requests": int(sum(truncated.values())),
            "max_concurrent_decodes": self.n_slots,
            "page_size": self.page_size,
            "compile_count": self.compile_count,
            "spec_decode": self.spec_decode,
            "device": str(dev),
        }
        if self.spec_decode:
            stats["draft_len"] = self.draft_len
            stats["proposed_tokens"] = spec_proposed
            stats["accepted_tokens"] = spec_accepted
            stats["acceptance_rate"] = round(spec_accepted / max(spec_proposed, 1), 4)
            stats["tok_per_verify"] = round(decode_emitted / max(step, 1), 3)
        return results, stats

    def _verify(self, tables, lengths, fed, live: dict, slots: list):
        """Draft and verify for the live ``slots``: returns ({slot: draft},
        [len(slots), T] sampled tokens over each window).  Without
        ``spec_decode`` every draft is empty and the window of one token is
        a decode step."""
        window = np.zeros((self.n_slots, self.draft_len + 1), np.int32)
        drafts = {}
        for slot in slots:
            d = prompt_lookup_draft(live[slot].history, self.draft_len)
            drafts[slot] = d
            window[slot, 0] = fed[slot]
            window[slot, 1:1 + len(d)] = d
        logits, self.cache = self.model.verify_step_paged(
            self.params, self.cache, tables, lengths, torch.from_numpy(window).to(self.device))
        return drafts, self._sample(logits, slots, [live[s] for s in slots])

    def _accept(self, drafts: dict, toks, fed, live: dict, slots: list, worker, t_now):
        """Commit each slot's verified tokens; returns (tokens emitted,
        drafts proposed, drafts accepted).  A slot accepts the longest draft
        prefix the model re-derives, capped so the step's emissions fit the
        request's budget; the sample after the last accepted draft is the
        bonus token, so the slot emits accepted + 1 tokens, cut after an
        EOS."""
        sched = self.scheduler
        n_em_all = proposed = accepted = 0
        for i, slot in enumerate(slots):
            lv, d = live[slot], drafts[slot]
            emit_room = lv.budget - lv.generated
            a = 0
            while a < min(len(d), emit_room - 1) and int(toks[i, a]) == d[a]:
                a += 1
            emits = [int(toks[i, j]) for j in range(a + 1)]
            if self.eos_id >= 0 and self.eos_id in emits:
                emits = emits[:emits.index(self.eos_id) + 1]
            n_em = len(emits)
            proposed += len(d)
            accepted += min(a, n_em - 1)
            for tok in emits:
                worker.put(lv.req.id, tok, t_now)
            n_em_all += n_em
            lv.history.extend(emits)
            lv.generated += n_em
            # the rejected tail's KV (past the last commit) is rolled back by
            # this pointer alone, never copied out
            sched.lengths[slot] += n_em
            fed[slot] = emits[-1]
            hit_eos = self.eos_id >= 0 and emits[-1] == self.eos_id
            if hit_eos or lv.generated >= lv.budget:
                sched.evict(slot)
                del live[slot]
                fed[slot] = 0
        return n_em_all, proposed, accepted


class BatchedServer:
    """Static-batch driver: one prefill, lockstep decode, rows frozen at
    EOS.  Kept as the engine's oracle and for the recurrent (hybrid and ssm)
    families the paged engine does not cover."""

    def __init__(self, cfg, params=None, max_len: int = 512, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.model = build_model(cfg, device)
        self.device = self.model.device
        self.params = (
            params
            if params is not None
            else self.model.init(jax_random.PRNGKey(seed))
        )
        self.max_len = max_len

    def generate(
        self,
        prompts: np.ndarray,  # [B, S] int32
        max_new_tokens: int = 32,
        eos_id: int = -1,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> tuple[np.ndarray, dict]:
        B = prompts.shape[0]
        dev = self.device
        t0 = time.perf_counter()
        tokens_t = torch.from_numpy(np.asarray(prompts, np.int32)).to(dev)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens_t}, self.max_len)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        out = []
        done = np.zeros(B, bool)
        live = np.zeros(B, np.int64)
        # Finished rows are frozen: their emitted token is pinned to eos_id
        # (pad 0 without EOS), and that pinned token feeds the next step.
        fill = eos_id if eos_id >= 0 else 0
        key = jax_random.PRNGKey(seed)
        tok = self._sample(logits, temperature, key)
        ttft_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for i in range(max_new_tokens):
            emitted = np.where(done, fill, tok).astype(np.int32)
            out.append(emitted)
            live += ~done  # the EOS token itself still counts live
            done |= emitted == eos_id
            if done.all() or i == max_new_tokens - 1:
                break
            logits, cache = self.model.decode_step(
                self.params, cache, torch.from_numpy(emitted).to(dev)
            )
            key = jax_random.fold_in(key, i)
            tok = self._sample(logits, temperature, key)
        decode_s = time.perf_counter() - t1
        tokens = np.stack(out, axis=1)
        live_total = int(live.sum())
        stats = {
            "prefill_s": round(prefill_s, 4),
            "ttft_s": round(ttft_s, 4),
            "decode_s": round(decode_s, 4),
            "live_tokens": live_total,
            "decode_tok_per_s": round(live_total / max(decode_s, 1e-9), 1),
        }
        return tokens, stats

    @staticmethod
    def _sample(logits, temperature, key) -> np.ndarray:
        """Greedy argmax, or the reference's ``categorical(key, logits /
        temperature)`` over the whole [B, V] batch under one key."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        return _sample_rows(logits, temperature, key).astype(np.int32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers (0: as registered)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument(
        "--eos-id",
        type=int,
        default=-1,
        help="EOS token id; -1 disables early stop",
    )
    ap.add_argument(
        "--engine",
        action="store_true",
        help="serve through the continuous-batching ServeEngine instead of "
        "the static-batch loop",
    )
    ap.add_argument("--max-concurrent", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument(
        "--spec-decode",
        action="store_true",
        help="speculative decoding (prompt-lookup draft + multi-token verify); "
        "requires --engine",
    )
    ap.add_argument(
        "--draft-len",
        type=int,
        default=4,
        help="max draft tokens proposed per verify step (with --spec-decode)",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="cuda (the default; the hand-written kernels) or cpu (their plain "
        "PyTorch versions)",
    )
    args = ap.parse_args(argv)
    if args.spec_decode and not args.engine:
        ap.error(
            "--spec-decode requires --engine: the static-batch "
            "BatchedServer has no draft/verify pipeline"
        )

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = cfg.reduced(n_layers=args.layers)
    rng = np.random.default_rng(0)
    size = (args.batch, args.prompt_len)
    prompts = rng.integers(2, cfg.vocab_size, size=size).astype(np.int32)
    if args.engine:
        engine = ServeEngine(
            cfg,
            max_concurrent_decodes=args.max_concurrent,
            max_prompt_len=args.prompt_len,
            max_new_tokens=args.max_new,
            page_size=args.page_size,
            eos_id=args.eos_id,
            temperature=args.temperature,
            spec_decode=args.spec_decode,
            draft_len=args.draft_len,
            device=args.device,
        )
        reqs = [
            Request(id=f"r{i}", tokens=prompts[i], max_new=args.max_new)
            for i in range(args.batch)
        ]
        _, stats = engine.serve(reqs)
        print(json.dumps(stats, indent=1))
        return
    server = BatchedServer(
        cfg, max_len=args.prompt_len + args.max_new + 1, device=args.device
    )
    tokens, stats = server.generate(
        prompts,
        max_new_tokens=args.max_new,
        eos_id=args.eos_id,
        temperature=args.temperature,
    )
    print(json.dumps({"generated_shape": list(tokens.shape), **stats}, indent=1))


if __name__ == "__main__":
    main()
