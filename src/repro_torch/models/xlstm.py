"""xLSTM LM (Beck et al., arXiv:2405.04517), counterpart of
``repro.models.xlstm``: mLSTM (matrix-memory) blocks with a few sLSTM
(scalar-memory) blocks and no separate FFN (d_ff = 0: the projection lives
inside the block).

As in the reference: exponential gating with the log-space stabilizer
``m_t``; the mLSTM's matrix memory C [B, Nh, dh, dh] with normalizer n and
denominator max(|nᵀq|, e^{-m}); the sLSTM with a block-diagonal recurrence
R per head; the causal conv of the mLSTM cell omitted and one output
projection in the sLSTM block.  The mLSTM head dim is d_inner / n_heads
(512 at full width), not the config's ``head_dim``.

Parameters are per layer (``blocks/lNN_m``, ``blocks/lNN_s``), not stacked,
and keep the reference's keys, so one seed draws the reference's params.
There is no kernel on this path: the reference has no Pallas mLSTM or
sLSTM kernel (its chunkwise form is already matrix products), so every
product here is ``torch.matmul`` / ``torch.einsum``.  The recurrences are
Python loops written out of place, which autograd runs through as written
(the first-order step).  The reference's ``shard_hint`` calls are no-ops
without a mesh and are left out.

The mLSTM runs sequentially or chunkwise (:meth:`XLSTMLM._mlstm_chunk`):
an explicit ``cfg.mlstm_chunk`` wins; otherwise a CUDA tensor takes chunks
of 256, the reference's "pallas" default, and a CPU tensor the sequential
scan, its "xla" lowering.  The chunkwise form runs only where the chunk
divides S and S is longer than it.

Serving: the recurrent state is the cache, O(1) in context; ``pos`` is a
host int."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.spec import PSpec
from repro_torch.utils import shard_ctx

CARD_CHUNK = 256  # the chunk a CUDA tensor takes when cfg.mlstm_chunk is 0


class XLSTMLM:
    def __init__(self, cfg: ModelConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.d_inner = 2 * cfg.d_model  # mLSTM inner dim: projection factor 2
        self.dh_m = self.d_inner // cfg.n_heads  # mLSTM head dim
        self.dh_s = cfg.d_model // cfg.n_heads  # sLSTM head dim

    def _is_slstm(self, layer_idx: int) -> bool:
        return layer_idx in self.cfg.slstm_layers

    def _key(self, layer_idx: int) -> str:
        return f"l{layer_idx:02d}_{'s' if self._is_slstm(layer_idx) else 'm'}"

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        c = self.cfg
        D, Di, Nh = c.d_model, self.d_inner, c.n_heads
        s = 1.0 / math.sqrt(D)
        si = 1.0 / math.sqrt(Di)
        blocks = {}
        for li in range(c.n_layers):
            if self._is_slstm(li):
                blocks[self._key(li)] = {
                    "ln": PSpec((D,), ("embed",), "zeros"),
                    # gates i, f, z, o each take x and the recurrent h
                    "w_x": PSpec((D, 4 * D), ("embed", "heads"), scale=s),
                    "r_h": PSpec((Nh, self.dh_s, 4 * self.dh_s), (None, None, None),
                                 scale=1.0 / math.sqrt(self.dh_s)),
                    "b": PSpec((4 * D,), ("heads",), "zeros"),
                    "w_out": PSpec((D, D), ("heads", "embed"), scale=s),
                }
            else:
                blocks[self._key(li)] = {
                    "ln": PSpec((D,), ("embed",), "zeros"),
                    "w_up": PSpec((D, 2 * Di), ("embed", "heads"), scale=s),
                    "w_q": PSpec((Di, Di), ("heads", "kv_heads"), scale=si),
                    "w_k": PSpec((Di, Di), ("heads", "kv_heads"), scale=si),
                    "w_v": PSpec((Di, Di), ("heads", "kv_heads"), scale=si),
                    "w_if": PSpec((Di, 2 * Nh), ("heads", None), scale=si),
                    "b_if": PSpec((2 * Nh,), (None,), "zeros"),
                    "w_down": PSpec((Di, D), ("heads", "embed"), scale=si),
                }
        return {
            "embed": PSpec((c.vocab_size, D), ("vocab", "embed"), scale=1.0),
            "blocks": blocks,
            "final_norm": PSpec((D,), ("embed",), "zeros"),
            "lm_head": PSpec((D, c.vocab_size), ("embed", "vocab"), scale=s),
        }

    # ------------------------------------------------------------------
    # mLSTM cell: one step (the sequential form and decode)
    # ------------------------------------------------------------------
    @staticmethod
    def _mlstm_step(state, q, k, v, it, ft):
        """state (C [B,Nh,dh,dh], n [B,Nh,dh], m [B,Nh]); q, k, v [B,Nh,dh];
        it, ft [B,Nh] -> (new state, h [B,Nh,dh])."""
        C, n, m = state
        m_new = torch.maximum(ft + m, it)
        i_g = torch.exp(it - m_new)[..., None]  # [B,Nh,1]
        f_g = torch.exp(ft + m - m_new)[..., None]
        C = f_g[..., None] * C + i_g[..., None] * (v[..., :, None] * k[..., None, :])
        n = f_g * n + i_g * k
        num = torch.einsum("bhij,bhj->bhi", C, q)  # C q
        den = torch.abs(torch.einsum("bhj,bhj->bh", n, q))
        den = torch.maximum(den, torch.exp(-m_new))[..., None]
        return (C, n, m_new), num / den

    @staticmethod
    def _mlstm_chunk_scan(q, k, v, it, ft, state, chunk: int):
        """The reference's chunkwise-parallel stabilized mLSTM.  The
        stabilizer recurrence m_t = max(f_t + m_{t-1}, i_t) is a max-plus
        scan, so within a chunk

            m_j = g_j + M_j,   M_j = max(m₀, cummax_{l≤j}(i_l − g_l)),
            g_j = Σ_{l≤j} f_l,

        and every gate product is a closed-form exponent <= 0:
            intra:  S_jl = exp(i_l − g_l − M_j)·(k_l·q_j),  l ≤ j
            inter:  c_j  = exp(m₀ − M_j)
            carry:  C' = exp(m₀ − M_Q)·C + Σ_j exp(i_j − g_j − M_Q)·v_j k_jᵀ.

        q, k, v [B,S,Nh,dh] f32, it, ft [B,S,Nh] -> (state, h [B,S,Nh,dh])."""
        B, S, Nh, dh = q.shape
        nc = S // chunk

        def to_chunks(t):  # [B,S,Nh,(dh)] -> [nc,B,Nh,chunk,(dh)]
            t = t.reshape((B, nc, chunk) + tuple(t.shape[2:]))
            return t.permute(1, 0, 3, 2, 4) if t.dim() == 5 else t.permute(1, 0, 3, 2)

        qc, kc, vc, ic, fc = (to_chunks(t) for t in (q, k, v, it, ft))
        causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=q.device))
        C, n, m = state
        hs = []
        for qb, kb, vb, ib, fb in zip(qc, kc, vc, ic, fc):  # [B,Nh,Q,(dh)]
            g = torch.cumsum(fb, dim=-1)  # [B,Nh,Q]
            a = ib - g  # i_l − g_l
            M = torch.maximum(m[..., None], torch.cummax(a, dim=-1).values)
            c_inter = torch.exp(m[..., None] - M)  # <= 1
            # the causal mask inside the exponent: for l > j the raw exponent
            # a_l − M_j grows ~|log f|·(l − j) and overflows exp at chunks of
            # ~128 and more, where inf·0 from a mask after the exp is NaN
            expo = torch.where(causal, a[..., None, :] - M[..., :, None], -math.inf)
            d_w = torch.exp(expo)  # <= 1, 0 above the diagonal
            scores = torch.einsum("bhqd,bhld->bhql", qb, kb) * d_w
            num = torch.einsum("bhql,bhli->bhqi", scores, vb)
            num = num + c_inter[..., None] * torch.einsum("bhij,bhqj->bhqi", C, qb)
            nq = torch.sum(scores, dim=-1) + c_inter * torch.einsum("bhj,bhqj->bhq", n, qb)
            m_j = g + M
            denom = torch.maximum(torch.abs(nq), torch.exp(-m_j))[..., None]
            hs.append(num / denom)  # [B,Nh,Q,dh]
            # the carry
            M_Q = M[..., -1]
            cg = torch.exp(m - M_Q)[..., None]
            w = torch.exp(a - M_Q[..., None])  # [B,Nh,Q]
            C = cg[..., None] * C + torch.einsum("bhqi,bhqj->bhij", w[..., None] * vb, kb)
            n = cg * n + torch.einsum("bhq,bhqj->bhj", w, kb)
            m = g[..., -1] + M_Q
        # [nc,B,Nh,chunk,dh] -> [B,S,Nh,dh]
        h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, S, Nh, dh)
        return (C, n, m), h

    def _mlstm_chunk(self, x: torch.Tensor) -> int:
        """The chunk of this forward (0: the sequential scan).  The reference
        picks with its ``kernel_mode`` knob; the port, which has none, with
        the device: an explicit ``cfg.mlstm_chunk`` wins, else a CUDA tensor
        takes CARD_CHUNK (the reference's "pallas" default) and a CPU tensor
        0 (its "xla" lowering)."""
        if self.cfg.mlstm_chunk:
            return self.cfg.mlstm_chunk
        return CARD_CHUNK if x.is_cuda else 0

    def _mlstm_block(self, p, x, state=None):
        """x [B,S,D] -> (y [B,S,D], new state): the sequential scan over S,
        or the chunkwise form where the chunk divides S (the same math)."""
        c = self.cfg
        B, S, _ = x.shape
        Nh, dh, Di = c.n_heads, self.dh_m, self.d_inner
        h = layers.rms_norm(x, p["ln"], c.norm_eps)
        up = layers.weight_matmul(h, p["w_up"])
        xc, gate = up[..., :Di], up[..., Di:]  # [B,S,Di] each
        q = layers.weight_matmul(xc, p["w_q"]).reshape(B, S, Nh, dh).float()
        k = layers.weight_matmul(xc, p["w_k"]).reshape(B, S, Nh, dh).float() / math.sqrt(dh)
        v = layers.weight_matmul(xc, p["w_v"]).reshape(B, S, Nh, dh).float()
        gif = (layers.weight_matmul(xc, p["w_if"]) + p["b_if"].to(xc.dtype)).float()
        gif = gif.reshape(B, S, 2 * Nh)
        it, ft = gif[..., :Nh], F.logsigmoid(gif[..., Nh:])  # log f in (-inf, 0)

        if state is None:
            state = (
                torch.zeros((B, Nh, dh, dh), dtype=torch.float32, device=x.device),
                torch.zeros((B, Nh, dh), dtype=torch.float32, device=x.device),
                torch.full((B, Nh), -1e30, dtype=torch.float32, device=x.device),
            )
        chunk = self._mlstm_chunk(x)
        if chunk and S > chunk and S % chunk == 0:
            state, hs = self._mlstm_chunk_scan(q, k, v, it, ft, state, chunk)
        else:
            steps = []
            for t in range(S):
                state, h_t = self._mlstm_step(state, q[:, t], k[:, t], v[:, t], it[:, t],
                                              ft[:, t])
                steps.append(h_t)
            hs = torch.stack(steps, dim=1)
        hs = hs.reshape(B, S, Di).to(x.dtype)
        out = layers.weight_matmul(hs * F.silu(gate.float()).to(x.dtype), p["w_down"])
        return x + out, state

    # ------------------------------------------------------------------
    # sLSTM cell
    # ------------------------------------------------------------------
    def _slstm_step(self, r_h, state, xw):
        """state (c, n, h [B,Nh,dh], m [B,Nh]); xw [B,4D] is the input's
        contribution; the recurrence adds R·h_{t-1} per head (``r_h`` in
        f32)."""
        Nh, dh = self.cfg.n_heads, self.dh_s
        c, n, h, m = state
        B = c.shape[0]
        rec = torch.einsum("bhd,hdk->bhk", h, r_h)  # [B,Nh,4dh]
        z = xw.reshape(B, Nh, 4 * dh).float() + rec
        zi, zf, zz, zo = z.split(dh, dim=-1)  # [B,Nh,dh] each
        # per-head scalar gates from the mean pre-activation (scalar memory)
        it = torch.mean(zi, dim=-1)  # [B,Nh]
        ft = F.logsigmoid(torch.mean(zf, dim=-1))
        m_new = torch.maximum(ft + m, it)
        i_g = torch.exp(it - m_new)[..., None]
        f_g = torch.exp(ft + m - m_new)[..., None]
        c_new = f_g * c + i_g * torch.tanh(zz)
        n_new = f_g * n + i_g
        h_new = torch.sigmoid(zo) * c_new / torch.clamp_min(n_new, 1e-6)
        return (c_new, n_new, h_new, m_new), h_new

    def _slstm_block(self, p, x, state=None):
        c = self.cfg
        B, S, D = x.shape
        Nh, dh = c.n_heads, self.dh_s
        h = layers.rms_norm(x, p["ln"], c.norm_eps)
        xw = layers.weight_matmul(h, p["w_x"]) + p["b"].to(h.dtype)  # [B,S,4D]
        if state is None:
            zeros = [torch.zeros((B, Nh, dh), dtype=torch.float32, device=x.device)
                     for _ in range(3)]
            state = (*zeros, torch.full((B, Nh), -1e30, dtype=torch.float32, device=x.device))
        r_h = p["r_h"].float()
        steps = []
        for t in range(S):
            state, h_t = self._slstm_step(r_h, state, xw[:, t])
            steps.append(h_t)
        hs = torch.stack(steps, dim=1).reshape(B, S, D).to(x.dtype)
        return x + layers.weight_matmul(hs, p["w_out"]), state

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def hidden_states(self, params, batch, states=None):
        """Final-norm hidden states [B, P + S, D] (P prefix ``embeds``, if the
        batch has them) and each layer's carried state, keyed as its params
        (``states``: the carried states to start from, or None)."""
        c = self.cfg
        # a gather; its gradient sums in a fixed order (indexing's
        # accumulate=True backward on the CPU does not)
        x = F.embedding(batch["tokens"], shard_ctx.whole(params, "embed"))
        if batch.get("embeds") is not None:
            x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
        new_states = {}
        for li in range(c.n_layers):
            key = self._key(li)
            block = self._slstm_block if self._is_slstm(li) else self._mlstm_block
            # a sharded layer's leaves are gathered here, just in time
            p = shard_ctx.subtree(params["blocks"][key], f"['blocks'][{key!r}]")
            x, new_states[key] = block(p, x, None if states is None else states[key])
        return layers.rms_norm(x, shard_ctx.whole(params, "final_norm"), c.norm_eps), new_states

    def loss_fn(self, params, batch, grad: bool = False, sums: bool = False):
        """Mean next-token cross-entropy (f32 scalar; ``sums``: its NLL sum
        and token count).  ``grad`` changes nothing: no kernel runs here, so
        autograd differentiates this forward as it is (the first-order
        step's)."""
        x, _ = self.hidden_states(params, batch)
        P = 0 if batch.get("embeds") is None else batch["embeds"].shape[1]
        logits = layers.weight_matmul(x[:, P:, :], shard_ctx.whole(params, "lm_head"))
        ce = layers.cross_entropy_sums if sums else layers.cross_entropy
        return ce(logits, batch["targets"], batch.get("mask"))

    # ------------------------------------------------------------------
    # serving: the recurrent state is the cache (O(1) in context length)
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int, device=None):
        """Each layer's recurrent state, the reference's layout; ``pos`` a
        host 0.  ``device="meta"``: the reference's ``abstract=True``
        stand-ins (``pos`` an int32 scalar)."""
        c = self.cfg
        B, Nh = batch_size, c.n_heads
        dev = self.device if device is None else torch.device(device)

        def mk(shape, fill=0.0):
            return torch.full(shape, fill, dtype=torch.float32, device=dev)

        cache: dict = {}
        for li in range(c.n_layers):
            if self._is_slstm(li):
                dh = self.dh_s
                cache[self._key(li)] = (mk((B, Nh, dh)), mk((B, Nh, dh)), mk((B, Nh, dh)),
                                        mk((B, Nh), -1e30))
            else:
                dh = self.dh_m
                cache[self._key(li)] = (mk((B, Nh, dh, dh)), mk((B, Nh, dh)),
                                        mk((B, Nh), -1e30))
        cache["pos"] = (torch.empty((), dtype=torch.int32, device=dev) if dev.type == "meta"
                        else 0)
        return cache

    def prefill(self, params, batch, max_len: int):
        """The forward over the prompt: (last-position logits [B, V], the
        per-layer states as the cache)."""
        x, states = self.hidden_states(params, batch)
        logits = layers.weight_matmul(x[:, -1, :], params["lm_head"])
        states["pos"] = x.shape[1]
        return logits, states

    def decode_step(self, params, cache, tokens):
        """One token for the whole batch: tokens [B] -> logits [B, V]."""
        states = {k: v for k, v in cache.items() if k != "pos"}
        x, new_states = self.hidden_states(params, {"tokens": tokens[:, None]}, states)
        logits = layers.weight_matmul(x[:, 0, :], params["lm_head"])
        new_states["pos"] = int(cache["pos"]) + 1
        return logits, new_states
