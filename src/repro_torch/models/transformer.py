"""Decoder-only transformer LM covering the dense, MoE, VLM and audio
families (counterpart of ``repro.models.transformer``).

Parameters keep the reference's stacked layout — one ``[L, ...]`` tensor
per block leaf — and a plain Python loop over layers takes the place of
``lax.scan``.  Ported: the dense block with GQA/MQA attention and RoPE,
the optional QKV biases (qwen2.5) and qk-norm (qwen3), full causal
attention, the SwiGLU, GeGLU or 2-matrix GELU FFN, and the capacity-bounded
top-k MoE FFN of dbrx-132b and kimi-k2 (the reference's single-device
``_moe_gspmd``; its expert-parallel ``_moe_ep``, which runs on a mesh with a model axis);
sliding-window attention (``window`` > 0) with the ring-buffered dense
cache; the training forward and its ``loss_fn``, dense-cache
prefill/decode and the paged serving paths (full causal attention only),
speculative verify included.  The modality frontends
(paligemma, musicgen) are stubs, as in the reference: a batch may carry
precomputed prefix embeddings ``embeds [B, P, D]``, concatenated before
the token embeddings, and the loss is taken on the token positions.
Every weight matmul goes through ``layers.weight_matmul``, so a block
leaf may be a quantized ``core.quant.QuantLeaf`` (the MoE's router and
expert leaves never are).  Chunked cross-entropy is not ported yet
(ROADMAP.md).

The caches are updated in place (the reference returns new arrays): the
paged pool is the serving engine's largest allocation and a copy per step
would double its traffic.  Functions still return the cache so callers
read like the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers
from repro_torch.models.spec import PSpec
from repro_torch.utils import shard_ctx

_EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def ep_mesh(cfg: ModelConfig):
    """The mesh the expert-parallel MoE runs on: the current mesh
    (``utils.shard_ctx.current_mesh``) when ``moe_impl == "ep"`` and it has a model
    axis > 1, else None (the single-device path, as the reference takes
    without its ``spmd_hints``)."""
    mesh = shard_ctx.current_mesh()
    if cfg.n_experts > 0 and cfg.moe_impl == "ep" and mesh is not None and mesh.model > 1:
        return mesh
    return None


class MoERoute(NamedTuple):
    """One call's MoE routing: ``probs [N, E]`` f32, the renormalised
    ``gates [N, K]``, and per (token, k) entry, token-major, its expert,
    its 0-based position in that expert's buffer and whether it lies inside
    ``capacity``."""

    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    positions: torch.Tensor
    in_capacity: torch.Tensor
    capacity: int


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
        }
        if c.qkv_bias:
            blocks["bq"] = PSpec((L, H * dh), ("layers", "heads"), "zeros")
            blocks["bk"] = PSpec((L, KV * dh), ("layers", "kv_heads"), "zeros")
            blocks["bv"] = PSpec((L, KV * dh), ("layers", "kv_heads"), "zeros")
        if c.qk_norm:
            blocks["q_norm"] = PSpec((L, dh), ("layers", None), "zeros")
            blocks["k_norm"] = PSpec((L, dh), ("layers", None), "zeros")
        if c.n_experts > 0:
            E = c.n_experts
            blocks["router"] = PSpec((L, D, E), ("layers", "embed", None), scale=s_attn)
            blocks["we_gate"] = PSpec(
                (L, E, D, F), ("layers", "experts", "embed", "ff_expert"), scale=s_attn
            )
            blocks["we_up"] = PSpec(
                (L, E, D, F), ("layers", "experts", "embed", "ff_expert"), scale=s_attn
            )
            blocks["we_down"] = PSpec(
                (L, E, F, D), ("layers", "experts", "ff_expert", "embed"), scale=s_ff
            )
        else:
            if c.activation != "gelu":
                blocks["w_gate"] = PSpec((L, D, F), ("layers", "embed", "ff"), scale=s_attn)
            blocks["w_up"] = PSpec((L, D, F), ("layers", "embed", "ff"), scale=s_attn)
            blocks["w_down"] = PSpec((L, F, D), ("layers", "ff", "embed"), scale=s_ff)
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
        """Projections of the pre-normed h [B, S, D] -> q [B, S, H, dh], k/v
        [B, S, KV, dh], in the reference's order: the matmuls, the QKV
        biases (``qkv_bias``), the head reshape, the per-head RMS norms of q
        and k (``qk_norm``), then RoPE.  Every path that builds q and k
        (training forward, prefill, decode, paged decode and verify) comes
        through here."""
        c = self.cfg
        B, S, _ = h.shape
        dh, H, KV = c.head_dim, c.n_heads, c.n_kv_heads
        q = layers.weight_matmul(h, p["wq"])
        k = layers.weight_matmul(h, p["wk"])
        v = layers.weight_matmul(h, p["wv"])
        if c.qkv_bias:
            q = q + p["bq"].to(q.dtype)
            k = k + p["bk"].to(k.dtype)
            v = v + p["bv"].to(v.dtype)
        q = q.reshape(B, S, H, dh)
        k = k.reshape(B, S, KV, dh)
        v = v.reshape(B, S, KV, dh)
        if c.qk_norm:
            q = layers.rms_norm(q, p["q_norm"], c.norm_eps)
            k = layers.rms_norm(k, p["k_norm"], c.norm_eps)
        return layers.apply_rope(q, sin, cos), layers.apply_rope(k, sin, cos), v

    def _ln1(self, p, x):
        return layers.rms_norm(x, p["ln1"], self.cfg.norm_eps)

    def _attn(self, p, x, sin, cos, q_offset, grad=False):
        c = self.cfg
        B, S, _ = x.shape
        q, k, v = self._qkv(p, self._ln1(p, x), sin, cos)
        if grad:  # no kernel has a backward: autograd runs through the plain version
            o = flash_attention_plain(q, k, v, causal=True, window=c.window, q_offset=q_offset)
        else:
            o = layers.attention(q, k, v, window=c.window, q_offset=q_offset,
                                 chunked_min_seq=c.attn_chunked_min_seq)
        o = layers.weight_matmul(o.reshape(B, S, -1), p["wo"])
        return o, (k, v)

    def _ffn(self, p, x):
        c = self.cfg
        h = layers.rms_norm(x, p["ln2"], c.norm_eps)
        if c.n_experts > 0:
            return self._moe(p, h)
        return layers.gated_mlp(h, p.get("w_gate"), p["w_up"], p["w_down"], c.activation)

    def moe_route(self, p, xt) -> MoERoute:
        """The routing of the tokens ``xt [N, D]`` (all of one call) by layer
        params ``p``: the reference's ``_moe_gspmd`` up to its dispatch.  The
        router logits come from a matmul in the weight dtype, cast to f32;
        softmax, top-k (ties to the lower expert, ``layers.top_k``), the
        gates renormalised by ``max(sum, 1e-9)``; then each (token, k) entry
        takes the next position of its expert, token-major, and is dropped
        (weight 0) at or past ``capacity = max(1, ceil(N·K/E·factor))``."""
        c = self.cfg
        N = xt.shape[0]
        E, K = c.n_experts, c.n_experts_per_token
        capacity = max(1, int(math.ceil(N * K / E * c.moe_capacity_factor)))
        probs = torch.softmax(layers.weight_matmul(xt, p["router"]).float(), dim=-1)
        gate, eidx = layers.top_k(probs, K)  # [N, K]
        gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)
        e_flat = eidx.reshape(-1)  # [N*K], token-major then k
        onehot = torch.nn.functional.one_hot(e_flat, E)
        pos = torch.cumsum(onehot, dim=0).gather(1, e_flat[:, None])[:, 0] - 1
        in_cap = (pos < capacity) & (pos >= 0)
        return MoERoute(probs, gate, e_flat, pos, in_cap, capacity)

    def _experts(self, buf, wg, wu, wd):
        """The experts' gated FFN on their dispatch buffers [E, C, D]: batched
        matmuls in the weight dtype, the activation in f32, as the
        reference's einsums run outside any kernel."""
        ge = layers.weight_matmul(buf, wg)  # [E, C, F]
        ue = layers.weight_matmul(buf, wu)
        if self.cfg.activation == "swiglu":
            ae = torch.nn.functional.silu(ge.float()).to(ue.dtype)
        else:
            ae = torch.nn.functional.gelu(ge.float(), approximate="tanh").to(ue.dtype)
        return layers.weight_matmul(ae * ue, wd)

    def _moe_ep(self, p, h, mesh):
        """Expert-parallel MoE, the reference's ``_moe_ep`` step for step:
        this rank's tokens ``h [B_l, S, D]`` (its data share) route over
        all E experts, but only the E/M experts local to its model index
        take them (``p``'s expert leaves hold those, or the whole stack,
        which is cut here), under a capacity of ``max(1, ceil(N_l·K/E·cf))``
        over its N_l tokens; the combined outputs are summed over the model
        axis in rank order.  The routing is :meth:`moe_route`'s on the
        rank's tokens (top-k the stable descending sort, ``layers.top_k``)."""
        c = self.cfg
        B, S, D = h.shape
        E, K, M = c.n_experts, c.n_experts_per_token, mesh.model
        if E % M:
            raise ValueError(f"{E} experts do not split over a model axis of {M}")
        E_loc, col = E // M, mesh.model_index
        wg, wu, wd = (p[name] for name in _EXPERT_LEAVES)
        if wg.shape[0] == E:  # whole stacks: this rank's experts
            wg, wu, wd = (w[col * E_loc:(col + 1) * E_loc] for w in (wg, wu, wd))
        xt = h.reshape(B * S, D)
        n_l = xt.shape[0]
        r = self.moe_route(p, xt)  # capacity over the n_l local tokens
        C = r.capacity
        e_rel = r.experts - col * E_loc
        loc = (e_rel >= 0) & (e_rel < E_loc)
        # a local entry's position among its expert's entries is the same
        # whether the other experts' entries are counted or not
        in_cap = loc & r.in_capacity
        dest = torch.clamp(e_rel, 0, E_loc - 1) * C + torch.clamp(r.positions, 0, C - 1)
        w_in = in_cap.to(xt.dtype)
        src = torch.repeat_interleave(xt, K, dim=0) * w_in[:, None]
        buf = xt.new_zeros(E_loc * C, D).index_add(0, dest, src).view(E_loc, C, D)
        ye = self._experts(buf, wg, wu, wd)  # [E_loc, C, D]
        out = ye.reshape(E_loc * C, D).index_select(0, dest)
        out = out * (r.gates.reshape(-1) * w_in.float()).to(out.dtype)[:, None]
        y = out.reshape(n_l, K, D).sum(dim=1)
        return shard_ctx.sum_in_rank_order(y, mesh, over="model").reshape(B, S, D)

    def _moe(self, p, h):
        """Capacity-bounded top-k MoE with scatter dispatch and gather
        combine: the reference's ``_moe_gspmd``, step for step, on one
        device; with ``moe_impl="ep"`` on a mesh with a model axis > 1,
        :meth:`_moe_ep` (without one, ``ep`` takes this path too, as the
        reference does).  All ``N = B·S`` tokens of the call route under one
        capacity (:meth:`moe_route`), pad and dead-slot tokens included; the
        experts run as :meth:`_experts`."""
        mesh = ep_mesh(self.cfg)
        if mesh is not None:
            return self._moe_ep(p, h, mesh)
        c = self.cfg
        B, S, D = h.shape
        E, K = c.n_experts, c.n_experts_per_token
        xt = h.reshape(B * S, D)
        r = self.moe_route(p, xt)
        C = r.capacity
        dest = r.experts * C + torch.clamp(r.positions, 0, C - 1)  # rows of [E·C, D]
        w = r.in_capacity.to(xt.dtype)[:, None]
        src = torch.repeat_interleave(xt, K, dim=0) * w  # [N*K, D]
        buf = xt.new_zeros(E * C, D).index_add(0, dest, src).view(E, C, D)
        ye = self._experts(buf, p["we_gate"], p["we_up"], p["we_down"])  # [E, C, D]

        gathered = ye.reshape(E * C, D).index_select(0, dest)  # [N*K, D]
        gathered = gathered * (r.gates.reshape(-1)[:, None].to(gathered.dtype) * w)
        return gathered.reshape(B * S, K, D).sum(dim=1).reshape(B, S, D)

    def _block(self, p, x, sin, cos, q_offset, grad=False):
        o, kv = self._attn(p, x, sin, cos, q_offset, grad)
        x = x + o
        x = x + self._ffn(p, x)
        return x, kv

    def _layer(self, params, i: int) -> dict:
        """Layer ``i`` of every stacked block leaf (a QuantLeaf indexes each
        of its tensors).  On sharded params the layer's leaves are gathered
        here, just in time (``utils.shard_ctx.layer``), the expert
        stacks only over the data axis when the MoE runs expert-parallel."""
        keep = ({name: ("model",) for name in _EXPERT_LEAVES}
                if ep_mesh(self.cfg) is not None else None)
        return shard_ctx.layer(params, i, keep)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    @staticmethod
    def _embed_inputs(params, batch) -> torch.Tensor:
        """Token embeddings [B, S, D], after the batch's optional prefix
        ``embeds`` [B, P, D] (cast to the embeddings' dtype): [B, P + S, D]."""
        # a gather; its gradient sums in a fixed order (indexing's
        # accumulate=True backward on the CPU does not)
        x = torch.nn.functional.embedding(batch["tokens"], shard_ctx.whole(params, "embed"))
        if batch.get("embeds") is not None:
            x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
        return x

    def hidden_states(self, params, batch, collect_kv: bool = False, grad: bool = False):
        """Final-norm hidden states [B, P + S, D] (P prefix embeddings, if
        the batch has them) and, with ``collect_kv``, the per-layer (k, v)
        stacked as [L, B, P + S, KV, dh].  ``grad``: the attention runs
        ``flash_attention_plain``, which autograd can differentiate (the
        first-order step's forward)."""
        c = self.cfg
        x = self._embed_inputs(params, batch)
        sin, cos = self._rope(torch.arange(x.shape[1], device=x.device))
        ks, vs = [], []
        for i in range(c.n_layers):
            x, (k, v) = self._block(self._layer(params, i), x, sin, cos, 0, grad)
            if collect_kv:
                ks.append(k)
                vs.append(v)
        x = layers.rms_norm(x, shard_ctx.whole(params, "final_norm"), c.norm_eps)
        return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)

    def loss_fn(self, params, batch, grad: bool = False, sums: bool = False):
        """Mean next-token cross-entropy of ``batch`` (tokens, targets and
        an optional mask, each [B, S], and optional prefix ``embeds`` [B, P,
        D], whose P rows the loss drops) as an f32 scalar on the device;
        ``grad`` as in :meth:`hidden_states`; ``sums``: the (NLL sum, token
        count) pair instead (``layers.cross_entropy_sums``)."""
        x, _ = self.hidden_states(params, batch, grad=grad)
        P = 0 if batch.get("embeds") is None else batch["embeds"].shape[1]
        logits = layers.weight_matmul(x[:, P:, :], shard_ctx.whole(params, "lm_head"))
        ce = layers.cross_entropy_sums if sums else layers.cross_entropy
        return ce(logits, batch["targets"], batch.get("mask"))

    # ------------------------------------------------------------------
    # serving: prefill + single-token decode against a dense KV cache
    # ------------------------------------------------------------------
    def cache_capacity(self, max_len: int) -> int:
        """Positions the dense cache holds: the window for a sliding-window
        config (a ring), else ``max_len``."""
        c = self.cfg
        return min(max_len, c.window) if c.window > 0 else max_len

    def init_cache(self, batch_size: int, max_len: int, device=None):
        """Zeros of the reference's dense cache: k/v [L, B, Tc, KV, dh] in
        the cache dtype, Tc = :meth:`cache_capacity`, and ``pos`` (a host 0).
        ``device="meta"`` gives the reference's ``abstract=True`` stand-ins:
        meta tensors, ``pos`` an int32 scalar."""
        c = self.cfg
        shape = (c.n_layers, batch_size, self.cache_capacity(max_len), c.n_kv_heads,
                 c.head_dim)
        dt = torch_dtype(c.decode_cache_dtype)
        dev = self.device if device is None else torch.device(device)
        pos = torch.empty((), dtype=torch.int32, device=dev) if dev.type == "meta" else 0
        return {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": pos,
        }

    def prefill(self, params, batch, max_len: int):
        """Full forward over the prompt; returns last-position logits and a
        populated cache.  ``pos`` is a host int.  A sliding-window config
        keeps the last Tc positions in a ring, position p in slot p % Tc, as
        the reference does; a full-causal one needs ``max_len`` >= the
        prompt."""
        x, (k_all, v_all) = self.hidden_states(params, batch, collect_kv=True)
        S = k_all.shape[2]
        if S > max_len and self.cfg.window == 0:
            raise ValueError(f"prompt of {S} tokens exceeds the cache's {max_len}")
        cache = self.init_cache(k_all.shape[1], max_len)
        k_cache, v_cache = cache["k"], cache["v"]
        Tc = k_cache.shape[2]
        if S >= Tc:
            k_all = torch.roll(k_all[:, :, S - Tc:], S % Tc, dims=2)
            v_all = torch.roll(v_all[:, :, S - Tc:], S % Tc, dims=2)
        k_cache[:, :, :k_all.shape[2]] = k_all.to(k_cache.dtype)
        v_cache[:, :, :v_all.shape[2]] = v_all.to(v_cache.dtype)
        logits = layers.weight_matmul(x[:, -1, :], params["lm_head"])
        return logits, {"k": k_cache, "v": v_cache, "pos": S}

    def decode_step(self, params, cache, tokens):
        """One token for the whole batch: tokens [B] -> logits [B, V].  The
        new KV lands in slot ``pos % Tc``; a sliding-window ring attends to
        every slot once it is full, a full-causal cache raises then."""
        c = self.cfg
        pos = int(cache["pos"])
        Tc = cache["k"].shape[2]
        if pos >= Tc and c.window == 0:
            raise ValueError(f"the cache's {Tc} positions are full")
        B = tokens.shape[0]
        x = params["embed"][tokens][:, None, :]  # [B, 1, D]
        sin, cos = self._rope(torch.tensor([pos], device=x.device))
        slot = pos % Tc
        valid = (torch.arange(Tc, device=x.device) <= pos) | (pos >= Tc)
        for i in range(c.n_layers):
            p = self._layer(params, i)
            k_l, v_l = cache["k"][i], cache["v"][i]
            q, k, v = self._qkv(p, self._ln1(p, x), sin, cos)
            k_l[:, slot] = k[:, 0].to(k_l.dtype)
            v_l[:, slot] = v[:, 0].to(v_l.dtype)
            o = layers.decode_attention(q, k_l, v_l, valid)
            x = x + layers.weight_matmul(o.reshape(B, 1, -1), p["wo"])
            x = x + self._ffn(p, x)
        x = layers.rms_norm(x, params["final_norm"], c.norm_eps)
        logits = layers.weight_matmul(x[:, 0, :], params["lm_head"])
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}

    # ------------------------------------------------------------------
    # paged serving: block-table KV pages for the continuous-batching engine
    # ------------------------------------------------------------------
    def _refuse_window(self, entry: str) -> None:
        """The paged pool does not ring: the reference asserts ``window ==
        0`` on its paged entries."""
        if self.cfg.window > 0:
            raise ValueError(f"{entry} requires full causal attention (window == 0); "
                             f"{self.cfg.name} has window {self.cfg.window}: serve it "
                             "with prefill/decode_step")

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
        and never read.  Returns (logits [1, V], k_all, v_all [L, Sb, KV, dh]).
        Full causal attention only: the paged pool does not ring."""
        self._refuse_window("prefill_paged")
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
        invariant to the other slots, except the MoE's routing: its S tokens
        (dead slots' too) share one capacity, as in the reference.  Returns
        (logits [S, V], cache)."""
        self._refuse_window("decode_step_paged")
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
        self._refuse_window("verify_step_paged")
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
