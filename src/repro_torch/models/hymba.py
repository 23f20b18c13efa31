"""Hymba-style hybrid LM (arXiv:2411.13676), counterpart of
``repro.models.hymba``: every block runs sliding-window attention heads and
Mamba (selective-SSM) heads in parallel on the same input, fuses the two
paths through per-path RMSNorm and averaging, then a SwiGLU FFN.

Parameters keep the reference's stacked ``[L, ...]`` layout and a Python
loop over layers takes the place of ``lax.scan``.  The Mamba path's
selective scan goes through ``core.dispatch.selective_scan_fwd`` (the
hand-written kernel on the card at every sequence length, its plain
version on the CPU); the causal depthwise conv, the projections and the
decode attention are plain PyTorch, as they are plain jnp in the
reference.  The decode state is O(1) in context: a ring KV window of
``min(max_len, window)`` positions, the f32 SSM state and the conv tail.
As in the reference, all layers use the sliding window.

The serving cache is updated in place (the reference returns new arrays);
``pos`` is a host int.

The first-order step's forward (``grad=True``) runs the two kernels' plain
versions, named at their call sites, since the kernels have no backward:
``flash_attention_plain`` with the window and ``selective_scan_plain``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.selective_scan import selective_scan_plain
from repro_torch.models import layers
from repro_torch.models.spec import PSpec
from repro_torch.models.transformer import TransformerLM, torch_dtype
from repro_torch.utils import shard_ctx


class HymbaLM:
    def __init__(self, cfg: ModelConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.dt_rank = max(1, math.ceil(cfg.d_model / 16))

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        c = self.cfg
        L, D, dh = c.n_layers, c.d_model, c.head_dim
        H, KV, F = c.n_heads, c.n_kv_heads, c.d_ff
        Di, N, Cw, dtr = self.d_inner, c.ssm_state, c.conv_width, self.dt_rank
        s = 1.0 / math.sqrt(D)
        si = 1.0 / math.sqrt(Di)
        blocks = {
            "ln1": PSpec((L, D), ("layers", "embed"), "zeros"),
            # attention path
            "wq": PSpec((L, D, H * dh), ("layers", "embed", "heads"), scale=s),
            "wk": PSpec((L, D, KV * dh), ("layers", "embed", "kv_heads"), scale=s),
            "wv": PSpec((L, D, KV * dh), ("layers", "embed", "kv_heads"), scale=s),
            "wo": PSpec((L, H * dh, D), ("layers", "heads", "embed"), scale=s),
            # mamba path
            "w_in": PSpec((L, D, 2 * Di), ("layers", "embed", "heads"), scale=s),
            "conv_w": PSpec((L, Cw, Di), ("layers", None, "heads"), scale=0.5),
            "w_bc": PSpec((L, Di, 2 * N), ("layers", "heads", None), scale=si),
            "w_dt1": PSpec((L, Di, dtr), ("layers", "heads", None), scale=si),
            "w_dt2": PSpec((L, dtr, Di), ("layers", None, "heads"), scale=1.0 / math.sqrt(dtr)),
            "dt_bias": PSpec((L, Di), ("layers", "heads"), "zeros"),
            "a_log": PSpec((L, Di, N), ("layers", "heads", None), "zeros"),
            "d_skip": PSpec((L, Di), ("layers", "heads"), "ones"),
            "w_ssm_out": PSpec((L, Di, D), ("layers", "heads", "embed"), scale=si),
            # path fusion (per-path norm scales)
            "beta_attn": PSpec((L, D), ("layers", "embed"), "zeros"),
            "beta_ssm": PSpec((L, D), ("layers", "embed"), "zeros"),
            # FFN
            "ln2": PSpec((L, D), ("layers", "embed"), "zeros"),
            "w_gate": PSpec((L, D, F), ("layers", "embed", "ff"), scale=s),
            "w_up": PSpec((L, D, F), ("layers", "embed", "ff"), scale=s),
            "w_down": PSpec((L, F, D), ("layers", "ff", "embed"), scale=1.0 / math.sqrt(F)),
        }
        return {
            "embed": PSpec((c.vocab_size, D), ("vocab", "embed"), scale=1.0),
            "blocks": blocks,
            "final_norm": PSpec((D,), ("embed",), "zeros"),
            "lm_head": PSpec((D, c.vocab_size), ("embed", "vocab"), scale=s),
        }

    _layer = TransformerLM._layer
    _rope = TransformerLM._rope
    _qkv = TransformerLM._qkv
    _ln1 = TransformerLM._ln1

    # ------------------------------------------------------------------
    # mamba path
    # ------------------------------------------------------------------
    def _ssm_scan(self, p, xc, dt, b_in, c_in, h0, grad=False):
        """xc, dt [B,S,Di]; b_in, c_in [B,S,N]; h0 [B,Di,N] f32 ->
        (y [B,S,Di] f32 with the D∘x skip, h_last).  ``grad``: the plain
        scan, which autograd can differentiate."""
        from repro_torch.core import dispatch

        a = -torch.exp(p["a_log"].float())  # [Di, N]
        scan = selective_scan_plain if grad else dispatch.selective_scan_fwd
        y, h_last = scan(xc.float(), dt.float(), a, b_in.float(), c_in.float(), h0)
        y = y + xc.float() * p["d_skip"].float()
        return y, h_last

    def _mamba(self, p, h, ssm_state=None, conv_state=None, grad=False):
        """h [B,S,D] (pre-normed) -> (out [B,S,D], ssm_state, conv_state)."""
        c = self.cfg
        B, S, _ = h.shape
        Di, N, Cw = self.d_inner, c.ssm_state, c.conv_width
        up = layers.weight_matmul(h, p["w_in"])
        xc, res = up[..., :Di], up[..., Di:]
        # causal depthwise conv (width Cw) with the carried state for decode
        if conv_state is None:
            ctx = F.pad(xc, (0, 0, Cw - 1, 0))
        else:
            ctx = torch.cat([conv_state.to(xc.dtype), xc], dim=1)
        w = p["conv_w"].float()  # [Cw, Di]
        ctxf = ctx.float()
        conv = ctxf[:, 0:S] * w[0]
        for j in range(1, Cw):
            conv = conv + ctxf[:, j:j + S] * w[j]
        xc = F.silu(conv).to(h.dtype)
        new_conv_state = ctx[:, S:] if Cw > 1 else None

        bc = layers.weight_matmul(xc, p["w_bc"])
        b_in, c_in = bc[..., :N], bc[..., N:]
        dt = layers.weight_matmul(layers.weight_matmul(xc, p["w_dt1"]), p["w_dt2"])
        dt = F.softplus(dt.float() + p["dt_bias"].float())
        if ssm_state is None:
            ssm_state = torch.zeros((B, Di, N), dtype=torch.float32, device=h.device)
        y, h_last = self._ssm_scan(p, xc, dt, b_in, c_in, ssm_state, grad)
        y = y.to(h.dtype) * F.silu(res.float()).to(h.dtype)
        return layers.weight_matmul(y, p["w_ssm_out"]), h_last, new_conv_state

    # ------------------------------------------------------------------
    # attention path and the block
    # ------------------------------------------------------------------
    def _attn(self, p, h, sin, cos, grad=False):
        c = self.cfg
        B, S, _ = h.shape
        q, k, v = self._qkv(p, h, sin, cos)
        if grad:  # no kernel has a backward: autograd runs through the plain version
            o = flash_attention_plain(q, k, v, causal=True, window=c.window)
        else:
            o = layers.attention(q, k, v, window=c.window,
                                 chunked_min_seq=c.attn_chunked_min_seq)
        return layers.weight_matmul(o.reshape(B, S, -1), p["wo"]), (k, v)

    def _fuse_ffn(self, p, x, attn_o, ssm_o):
        """x + the fused paths, then the SwiGLU FFN's residual."""
        c = self.cfg
        fused = 0.5 * (layers.rms_norm(attn_o, p["beta_attn"], c.norm_eps)
                       + layers.rms_norm(ssm_o, p["beta_ssm"], c.norm_eps))
        x = x + fused
        h2 = layers.rms_norm(x, p["ln2"], c.norm_eps)
        return x + layers.gated_mlp(h2, p["w_gate"], p["w_up"], p["w_down"], c.activation)

    def _block(self, p, x, sin, cos, grad=False):
        """One block: (x, (k, v), ssm h_last, conv tail)."""
        h = self._ln1(p, x)
        attn_o, kv = self._attn(p, h, sin, cos, grad)
        ssm_o, h_last, conv_tail = self._mamba(p, h, grad=grad)
        return self._fuse_ffn(p, x, attn_o, ssm_o), kv, h_last, conv_tail

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def hidden_states(self, params, batch, grad: bool = False):
        """Final-norm hidden states [B, S, D]; ``grad``: the attention and
        the scan run their plain versions, which autograd can differentiate
        (the first-order step's forward)."""
        c = self.cfg
        # a gather; its gradient sums in a fixed order (indexing's
        # accumulate=True backward on the CPU does not)
        x = F.embedding(batch["tokens"], shard_ctx.whole(params, "embed"))
        sin, cos = self._rope(torch.arange(x.shape[1], device=x.device))
        for i in range(c.n_layers):
            x = self._block(self._layer(params, i), x, sin, cos, grad)[0]
        return layers.rms_norm(x, shard_ctx.whole(params, "final_norm"), c.norm_eps)

    def loss_fn(self, params, batch, grad: bool = False, sums: bool = False):
        """Mean next-token cross-entropy (``sums``: its NLL sum and token
        count); ``grad`` as in :meth:`hidden_states`."""
        x = self.hidden_states(params, batch, grad)
        logits = layers.weight_matmul(x, shard_ctx.whole(params, "lm_head"))
        ce = layers.cross_entropy_sums if sums else layers.cross_entropy
        return ce(logits, batch["targets"], batch.get("mask"))

    # ------------------------------------------------------------------
    # serving: ring-window KV + SSM state (O(1) in context length)
    # ------------------------------------------------------------------
    def cache_capacity(self, max_len: int) -> int:
        c = self.cfg
        return min(max_len, c.window) if c.window > 0 else max_len

    def init_cache(self, batch_size: int, max_len: int, device=None):
        """The ring-window KV, SSM state and conv tail, zeroed; ``pos`` a
        host 0.  ``device="meta"``: the reference's ``abstract=True``
        stand-ins (``pos`` an int32 scalar)."""
        c = self.cfg
        L, B = c.n_layers, batch_size
        Tc = self.cache_capacity(max_len)
        Di, N, Cw = self.d_inner, c.ssm_state, c.conv_width
        dt = torch_dtype(c.decode_cache_dtype)
        dev = self.device if device is None else torch.device(device)
        return {
            "k": torch.zeros((L, B, Tc, c.n_kv_heads, c.head_dim), dtype=dt, device=dev),
            "v": torch.zeros((L, B, Tc, c.n_kv_heads, c.head_dim), dtype=dt, device=dev),
            "ssm": torch.zeros((L, B, Di, N), dtype=torch.float32, device=dev),
            "conv": torch.zeros((L, B, Cw - 1, Di), dtype=dt, device=dev),
            "pos": torch.empty((), dtype=torch.int32, device=dev) if dev.type == "meta" else 0,
        }

    def prefill(self, params, batch, max_len: int):
        """The full forward over the prompt, harvesting each layer's KV (the
        last Tc positions, rolled so position p sits in ring slot p % Tc),
        SSM state and conv tail.  Returns (last-position logits [B, V],
        cache)."""
        c = self.cfg
        x = params["embed"][batch["tokens"]]
        B, S, _ = x.shape
        sin, cos = self._rope(torch.arange(S, device=x.device))
        cache = self.init_cache(B, max_len)
        Tc = cache["k"].shape[2]
        for i in range(c.n_layers):
            x, (k, v), h_last, conv_tail = self._block(self._layer(params, i), x, sin, cos)
            if S >= Tc:
                shift = S % Tc
                k = torch.roll(k[:, S - Tc:], shift, dims=1)
                v = torch.roll(v[:, S - Tc:], shift, dims=1)
            cache["k"][i, :, :k.shape[1]] = k.to(cache["k"].dtype)
            cache["v"][i, :, :v.shape[1]] = v.to(cache["v"].dtype)
            cache["ssm"][i] = h_last
            if conv_tail is not None:
                cache["conv"][i] = conv_tail.to(cache["conv"].dtype)
        x = layers.rms_norm(x, params["final_norm"], c.norm_eps)
        logits = layers.weight_matmul(x[:, -1, :], params["lm_head"])
        cache["pos"] = S
        return logits, cache

    def decode_step(self, params, cache, tokens):
        """One token for the whole batch: tokens [B] -> logits [B, V]; the
        new KV lands in ring slot ``pos % Tc``, the SSM state and conv tail
        carry."""
        c = self.cfg
        pos = int(cache["pos"])
        Tc = cache["k"].shape[2]
        B = tokens.shape[0]
        x = params["embed"][tokens][:, None, :]  # [B, 1, D]
        sin, cos = self._rope(torch.tensor([pos], device=x.device))
        slot = pos % Tc
        valid = (torch.arange(Tc, device=x.device) <= pos) | (pos >= Tc)
        for i in range(c.n_layers):
            p = self._layer(params, i)
            k_l, v_l = cache["k"][i], cache["v"][i]
            h = self._ln1(p, x)
            q, k, v = self._qkv(p, h, sin, cos)
            k_l[:, slot] = k[:, 0].to(k_l.dtype)
            v_l[:, slot] = v[:, 0].to(v_l.dtype)
            o = layers.decode_attention(q, k_l, v_l, valid)
            attn_o = layers.weight_matmul(o.reshape(B, 1, -1), p["wo"])
            ssm_o, ssm_new, conv_new = self._mamba(p, h, ssm_state=cache["ssm"][i],
                                                   conv_state=cache["conv"][i])
            cache["ssm"][i] = ssm_new
            if conv_new is not None:
                cache["conv"][i] = conv_new.to(cache["conv"].dtype)
            x = self._fuse_ffn(p, x, attn_o, ssm_o)
        x = layers.rms_norm(x, params["final_norm"], c.norm_eps)
        logits = layers.weight_matmul(x[:, 0, :], params["lm_head"])
        cache["pos"] = pos + 1
        return logits, cache
