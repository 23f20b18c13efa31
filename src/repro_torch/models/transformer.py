"""Decoder-only transformer LM, dense family (counterpart of
``repro.models.transformer``).

Parameters keep the reference's stacked layout — one ``[L, ...]`` tensor
per block leaf — and a plain Python loop over layers takes the place of
``lax.scan``.  Ported: opt-125m's dense block (no qkv bias, no qk-norm,
full causal attention, the 2-matrix GELU FFN of ``activation="gelu"``, or
SwiGLU), the training forward and
its ``loss_fn``, dense-cache prefill/decode and the paged serving paths,
speculative verify included.  Every weight matmul goes through
``layers.weight_matmul``, so a block leaf may be a quantized
``core.quant.QuantLeaf``.  The reference's other block options, MoE,
prefix ``embeds`` and chunked cross-entropy are not ported yet
(ROADMAP.md).

The caches are updated in place (the reference returns new arrays): the
paged pool is the serving engine's largest allocation and a copy per step
would double its traffic.  Functions still return the cache so callers
read like the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.spec import PSpec


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class TransformerLM:
    def __init__(self, cfg: ModelConfig, device: torch.device):
        self.cfg = cfg
        self.device = device

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        c = self.cfg
        L, D, dh = c.n_layers, c.d_model, c.head_dim
        H, KV, F, V = c.n_heads, c.n_kv_heads, c.d_ff, c.vocab_size
        s_attn = 1.0 / math.sqrt(D)
        s_ff = 1.0 / math.sqrt(max(F, D))
        blocks: dict[str, PSpec] = {
            "ln1": PSpec((L, D), ("layers", "embed"), "zeros"),
            "wq": PSpec((L, D, H * dh), ("layers", "embed", "heads"), scale=s_attn),
            "wk": PSpec((L, D, KV * dh), ("layers", "embed", "kv_heads"), scale=s_attn),
            "wv": PSpec((L, D, KV * dh), ("layers", "embed", "kv_heads"), scale=s_attn),
            "wo": PSpec((L, H * dh, D), ("layers", "heads", "embed"), scale=s_attn),
            "ln2": PSpec((L, D), ("layers", "embed"), "zeros"),
            "w_up": PSpec((L, D, F), ("layers", "embed", "ff"), scale=s_attn),
            "w_down": PSpec((L, F, D), ("layers", "ff", "embed"), scale=s_ff),
        }
        if c.activation != "gelu":
            blocks["w_gate"] = PSpec((L, D, F), ("layers", "embed", "ff"), scale=s_attn)
        return {
            "embed": PSpec((V, D), ("vocab", "embed"), scale=1.0),
            "blocks": blocks,
            "final_norm": PSpec((D,), ("embed",), "zeros"),
            "lm_head": PSpec((D, V), ("embed", "vocab"), scale=s_attn),
        }

    # ------------------------------------------------------------------
    # block
    # ------------------------------------------------------------------
    def _rope(self, pos: torch.Tensor) -> tuple:
        """RoPE angles for positions ``pos`` [S], as [1, S, dh/2]."""
        sin, cos = layers.rope_angles(pos, self.cfg.head_dim, self.cfg.rope_theta)
        return sin[None], cos[None]

    def _qkv(self, p, h, sin, cos):
        """Projections and RoPE of the pre-normed h [B, S, D] -> q [B, S, H,
        dh], k/v [B, S, KV, dh]."""
        c = self.cfg
        B, S, _ = h.shape
        dh, H, KV = c.head_dim, c.n_heads, c.n_kv_heads
        q = layers.weight_matmul(h, p["wq"]).reshape(B, S, H, dh)
        k = layers.weight_matmul(h, p["wk"]).reshape(B, S, KV, dh)
        v = layers.weight_matmul(h, p["wv"]).reshape(B, S, KV, dh)
        return layers.apply_rope(q, sin, cos), layers.apply_rope(k, sin, cos), v

    def _ln1(self, p, x):
        return layers.rms_norm(x, p["ln1"], self.cfg.norm_eps)

    def _attn(self, p, x, sin, cos, q_offset):
        c = self.cfg
        B, S, _ = x.shape
        q, k, v = self._qkv(p, self._ln1(p, x), sin, cos)
        o = layers.attention(q, k, v, q_offset=q_offset, chunked_min_seq=c.attn_chunked_min_seq)
        o = layers.weight_matmul(o.reshape(B, S, -1), p["wo"])
        return o, (k, v)

    def _ffn(self, p, x):
        c = self.cfg
        h = layers.rms_norm(x, p["ln2"], c.norm_eps)
        return layers.gated_mlp(h, p.get("w_gate"), p["w_up"], p["w_down"], c.activation)

    def _block(self, p, x, sin, cos, q_offset):
        o, kv = self._attn(p, x, sin, cos, q_offset)
        x = x + o
        x = x + self._ffn(p, x)
        return x, kv

    @staticmethod
    def _layer(params, i: int) -> dict:
        """Layer ``i`` of every stacked block leaf (a QuantLeaf indexes each
        of its tensors)."""
        return {name: w[i] for name, w in params["blocks"].items()}

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def hidden_states(self, params, batch, collect_kv: bool = False):
        """Final-norm hidden states [B, S, D] and, with ``collect_kv``, the
        per-layer (k, v) stacked as [L, B, S, KV, dh]."""
        c = self.cfg
        x = params["embed"][batch["tokens"]]
        sin, cos = self._rope(torch.arange(x.shape[1], device=x.device))
        ks, vs = [], []
        for i in range(c.n_layers):
            x, (k, v) = self._block(self._layer(params, i), x, sin, cos, 0)
            if collect_kv:
                ks.append(k)
                vs.append(v)
        x = layers.rms_norm(x, params["final_norm"], c.norm_eps)
        return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` (tokens, targets and
        an optional mask, each [B, S]) as an f32 scalar on the device."""
        x, _ = self.hidden_states(params, batch)
        logits = layers.weight_matmul(x, params["lm_head"])
        return layers.cross_entropy(logits, batch["targets"], batch.get("mask"))

    # ------------------------------------------------------------------
    # serving: prefill + single-token decode against a dense KV cache
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int):
        c = self.cfg
        shape = (c.n_layers, batch_size, max_len, c.n_kv_heads, c.head_dim)
        dt = torch_dtype(c.decode_cache_dtype)
        return {
            "k": torch.zeros(shape, dtype=dt, device=self.device),
            "v": torch.zeros(shape, dtype=dt, device=self.device),
            "pos": 0,
        }

    def prefill(self, params, batch, max_len: int):
        """Full forward over the prompt; returns last-position logits and a
        cache of ``max_len`` positions holding the prompt's.  ``pos`` is a
        host int.  (The reference's ring buffer serves sliding-window
        configs, which the port does not have yet.)"""
        x, (k_all, v_all) = self.hidden_states(params, batch, collect_kv=True)
        S = k_all.shape[2]
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds the cache's {max_len}")
        cache = self.init_cache(k_all.shape[1], max_len)
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, :, :S] = k_all.to(k_cache.dtype)
        v_cache[:, :, :S] = v_all.to(v_cache.dtype)
        logits = layers.weight_matmul(x[:, -1, :], params["lm_head"])
        return logits, {"k": k_cache, "v": v_cache, "pos": S}

    def decode_step(self, params, cache, tokens):
        """One token for the whole batch: tokens [B] -> logits [B, V]."""
        c = self.cfg
        pos = int(cache["pos"])
        Tc = cache["k"].shape[2]
        if pos >= Tc:
            raise ValueError(f"the cache's {Tc} positions are full")
        B = tokens.shape[0]
        x = params["embed"][tokens][:, None, :]  # [B, 1, D]
        sin, cos = self._rope(torch.tensor([pos], device=x.device))
        valid = torch.arange(Tc, device=x.device) <= pos
        for i in range(c.n_layers):
            p = self._layer(params, i)
            k_l, v_l = cache["k"][i], cache["v"][i]
            q, k, v = self._qkv(p, self._ln1(p, x), sin, cos)
            k_l[:, pos] = k[:, 0].to(k_l.dtype)
            v_l[:, pos] = v[:, 0].to(v_l.dtype)
            o = layers.decode_attention(q, k_l, v_l, valid)
            x = x + layers.weight_matmul(o.reshape(B, 1, -1), p["wo"])
            x = x + self._ffn(p, x)
        x = layers.rms_norm(x, params["final_norm"], c.norm_eps)
        logits = layers.weight_matmul(x[:, 0, :], params["lm_head"])
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}

    # ------------------------------------------------------------------
    # paged serving: block-table KV pages for the continuous-batching engine
    # ------------------------------------------------------------------
    def init_paged_cache(self, n_pages: int, page_size: int):
        """Shared KV page pool [L, n_pages, page_size, KV, dh].  Page 0 is
        reserved as the null page: free slots' decode writes are routed
        there so a stale block-table row can never corrupt a live page."""
        c = self.cfg
        shape = (c.n_layers, n_pages, page_size, c.n_kv_heads, c.head_dim)
        dt = torch_dtype(c.decode_cache_dtype)
        return {
            "k": torch.zeros(shape, dtype=dt, device=self.device),
            "v": torch.zeros(shape, dtype=dt, device=self.device),
        }

    def prefill_paged(self, params, tokens, true_len: int):
        """Prefill one bucket-padded prompt ([1, Sb] int, padding AFTER the
        prompt) and return the per-layer KV for page insertion.  Logits are
        taken at position true_len - 1; the pad tail is causally downstream
        and never read.  Returns (logits [1, V], k_all, v_all [L, Sb, KV, dh])."""
        x, (k_all, v_all) = self.hidden_states(params, {"tokens": tokens}, collect_kv=True)
        x_last = x[:, int(true_len) - 1, :]
        logits = layers.weight_matmul(x_last, params["lm_head"])
        return logits, k_all[:, 0], v_all[:, 0]

    def insert_pages(self, cache, k_new, v_new, page_ids):
        """Scatter a prefilled prompt's KV ([L, Sb, KV, dh]) into the pool at
        the given physical pages ([Sb/page_size] int) — a page-table edit;
        no existing page moves.  In place."""
        L, Sb, KV, dh = k_new.shape
        ps = cache["k"].shape[2]
        n = Sb // ps
        dt = cache["k"].dtype
        cache["k"][:, page_ids] = k_new.reshape(L, n, ps, KV, dh).to(dt)
        cache["v"][:, page_ids] = v_new.reshape(L, n, ps, KV, dh).to(dt)
        return cache

    def decode_step_paged(self, params, cache, block_tables, lengths, tokens):
        """One decode token per slot against the paged KV pool:
        :meth:`verify_step_paged` over a window of one token.

        ``tokens/lengths [S] int32`` — length is the count of kv positions
        already in the slot's pages, i.e. the new token's position; free
        slots carry length 0 and their write lands on the reserved null
        page 0, as does any write at or past the slot's page capacity (the
        reference's capacity-clamped ``writable`` routing).  Every per-slot
        op is row-independent, which makes a request's token stream bitwise
        invariant to the other slots.  Returns (logits [S, V], cache)."""
        logits, cache = self.verify_step_paged(params, cache, block_tables, lengths,
                                               tokens[:, None])
        return logits[:, 0], cache

    def verify_step_paged(self, params, cache, block_tables, lengths, tokens):
        """Score a T-token speculative window per slot in one forward.

        ``tokens [S, T] int32``: window position 0 is the slot's committed
        last token, 1 .. T-1 the draft proposals; ``lengths [S]`` is
        position 0's kv write position (as in :meth:`decode_step_paged`).
        All T KVs are written optimistically at lengths .. lengths+T-1 (a
        rejected tail is rolled back by the engine's length pointer alone,
        never copied), and window position t attends kpos < lengths+1+t
        through the verify kernel, one launch per layer for the whole
        window.  Writes at or past the slot's page capacity land on the
        null page 0, so a window overhanging capacity never indexes past
        the block table.

        Every other op runs per window position on an [S, 1, D] slice,
        exactly the shapes of a decode step: a GEMM at M = S·T rows may
        take another cuBLAS algorithm than the decode step's M = S and
        round a position's logits otherwise, which flips greedy ties (seen
        on the H100 at full width in bf16).  Per position, window position
        t is bitwise the decode step at length lengths + t (the verify
        kernel's rows past their limit add exact zeros), which is what
        keeps the engine's spec == non-spec tokens.  A one-token window
        attends through the decode kernel, the verify kernel's instructions
        at T = 1.  Returns (logits [S, T, V], cache)."""
        c = self.cfg
        S, T = tokens.shape
        ps = cache["k"].shape[2]
        P = block_tables.shape[1]
        pos = lengths[:, None] + torch.arange(T, device=tokens.device, dtype=lengths.dtype)
        xs = [params["embed"][tokens[:, t]][:, None, :] for t in range(T)]  # [S, 1, D] each
        rope = [layers.rope_angles(pos[:, t:t + 1], c.head_dim, c.rope_theta) for t in range(T)]
        active = lengths > 0
        writable = active[:, None] & (pos < P * ps)
        lp = torch.clamp(pos // ps, 0, P - 1).long()
        rows = torch.arange(S, device=tokens.device)[:, None]
        phys = torch.where(writable, block_tables[rows, lp], 0).long()
        off = (pos % ps).long()
        attn_len = torch.where(active, lengths + 1, 0).to(torch.int32)
        for i in range(c.n_layers):
            p = self._layer(params, i)
            k_l, v_l = cache["k"][i], cache["v"][i]
            qkv = [self._qkv(p, self._ln1(p, x), sin, cos) for x, (sin, cos) in zip(xs, rope)]
            q, k, v = qkv[0] if T == 1 else (torch.cat(parts, dim=1) for parts in zip(*qkv))
            k_l[phys, off] = k.to(k_l.dtype)  # q, k, v [S, T, H | KV, dh]
            v_l[phys, off] = v.to(v_l.dtype)
            if T == 1:
                o = layers.paged_decode_attention(q[:, 0], k_l, v_l, block_tables,
                                                  attn_len)[:, None]
            else:
                o = layers.paged_verify_attention(q, k_l, v_l, block_tables, attn_len)
            for t in range(T):
                x = xs[t] + layers.weight_matmul(o[:, t].reshape(S, 1, -1).contiguous(),
                                                 p["wo"])
                xs[t] = x + self._ffn(p, x)
        logits = [layers.weight_matmul(layers.rms_norm(x, params["final_norm"],
                                                       c.norm_eps)[:, 0, :], params["lm_head"])
                  for x in xs]
        return torch.stack(logits, dim=1), cache
