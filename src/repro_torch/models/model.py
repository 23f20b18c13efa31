"""Unified LM wrapper (counterpart of ``repro.models.model``): one object
per architecture exposing ``init``, ``loss_fn``, ``fo_loss_fn`` and the
serving paths.  The ``dense``, ``moe``, ``vlm`` and ``audio`` families
(``models.transformer``; a vlm or audio batch may carry prefix ``embeds
[B, P, D]``, the modality stubs), the ``hybrid`` family (``models.hymba``)
and the ``ssm`` family (``models.xlstm``) are ported; only the transformer
families have the paged serving paths.  The reference's input helpers are here
too: the abstract params and logical axes of the spec tree, the batch
layout of an assigned shape (:class:`~repro_torch.configs.base.ShapeConfig`),
its meta-tensor specs and :meth:`LM.make_inputs`, which draws the
reference's synthetic batch bit for bit."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.spec import abstract_params, init_params, logical_axes
from repro_torch.models.transformer import TransformerLM, torch_dtype
from repro_torch.models.xlstm import XLSTMLM
from repro_torch.utils import jax_random
from repro_torch.utils.device import resolve_device


_FAMILIES = {"dense": TransformerLM, "moe": TransformerLM, "vlm": TransformerLM,
             "audio": TransformerLM, "hybrid": HymbaLM, "ssm": XLSTMLM}


class LM:
    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"unknown model family {cfg.family!r}; expected one of {sorted(_FAMILIES)}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.impl = _FAMILIES[cfg.family](cfg, self.device)
        self._specs = self.impl.param_specs()

    # ---- parameters -------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    def init(self, key, shard=None) -> Any:
        """The reference's random parameters for ``key``
        (``utils.jax_random.PRNGKey(seed)``), drawn on this model's device
        (see models/spec.py).  With ``shard`` (a ``utils.shard_ctx.ShardCtx``)
        each leaf is this rank's shard, drawn alone: bitwise the whole
        draw's slice, and no rank draws or holds the whole model."""
        return init_params(self._specs, key, self.dtype, self.device,
                           None if shard is None else shard.slices)

    def abstract_params(self) -> Any:
        """Meta tensors of the params' shapes and dtypes."""
        return abstract_params(self._specs, self.dtype)

    def logical_axes(self) -> Any:
        """Each leaf's logical axis names (``distributed.sharding`` maps them
        onto a mesh)."""
        return logical_axes(self._specs)

    # ---- train ------------------------------------------------------------
    def loss_fn(self, params: Any, batch: Any) -> torch.Tensor:
        """Mean next-token cross-entropy (f32 scalar on the device); a
        forward without autograd, as ZO training never differentiates."""
        with torch.inference_mode():
            return self.impl.loss_fn(params, batch)

    def loss_sums(self, params: Any, batch: Any) -> tuple:
        """(NLL sum, token count) of the batch, f32 scalars on the device:
        what a sharded loss adds over the data lanes before it divides
        (``distributed.sharding.sharded_loss``)."""
        with torch.inference_mode():
            return self.impl.loss_fn(params, batch, sums=True)

    def fo_loss_fn(self, params: Any, batch: Any) -> torch.Tensor:
        """The same loss with autograd, for the first-order step
        (``optim.fo``), on every family.  The hand-written kernels have no
        backward (their wrappers raise under autograd), so the forward runs
        their plain versions, named at the call site: the attention's
        (``flash_attention_plain``) and the hybrid family's scan
        (``selective_scan_plain``).  The xLSTM forward runs no kernel."""
        return self.impl.loss_fn(params, batch, grad=True)

    # ---- serve ------------------------------------------------------------
    def prefill(self, params: Any, batch: Any, max_len: int):
        return self.impl.prefill(params, batch, max_len)

    def decode_step(self, params: Any, cache: Any, tokens: torch.Tensor):
        return self.impl.decode_step(params, cache, tokens)

    def init_cache(self, batch_size: int, max_len: int, device=None):
        """The family's decode cache on this model's device, or on
        ``device`` (``"meta"``: the reference's ``abstract=True`` specs)."""
        return self.impl.init_cache(batch_size, max_len, device)

    # ---- paged serving (continuous-batching engine) -----------------------
    @property
    def supports_paged_decode(self) -> bool:
        """Attention-family models serve through the paged engine; the
        recurrent (hybrid and ssm) families keep the dense decode path."""
        return hasattr(self.impl, "decode_step_paged")

    def init_paged_cache(self, n_pages: int, page_size: int):
        return self.impl.init_paged_cache(n_pages, page_size)

    def prefill_paged(self, params: Any, tokens: torch.Tensor, true_len: int):
        return self.impl.prefill_paged(params, tokens, true_len)

    def insert_pages(self, cache: Any, k_new, v_new, page_ids):
        return self.impl.insert_pages(cache, k_new, v_new, page_ids)

    def decode_step_paged(self, params, cache, block_tables, lengths, tokens):
        return self.impl.decode_step_paged(params, cache, block_tables, lengths, tokens)

    def verify_step_paged(self, params, cache, block_tables, lengths, tokens):
        return self.impl.verify_step_paged(params, cache, block_tables, lengths, tokens)

    # ---- inputs -----------------------------------------------------------
    def _batch_layout(self, shape: ShapeConfig) -> dict:
        """Sequence budget split between stub prefix embeds and tokens."""
        P = min(self.cfg.n_prefix_embeds, max(shape.seq_len - 1, 0))
        return {"prefix": P, "tokens": shape.seq_len - P}

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Meta-tensor stand-ins for a *training* batch of this shape."""
        lay = self._batch_layout(shape)
        B, P, S = shape.global_batch, lay["prefix"], lay["tokens"]
        batch = {
            "tokens": torch.empty((B, S), dtype=torch.int32, device="meta"),
            "targets": torch.empty((B, S), dtype=torch.int32, device="meta"),
        }
        if P > 0:
            batch["embeds"] = torch.empty((B, P, self.cfg.d_model), dtype=self.dtype,
                                          device="meta")
        return batch

    def decode_input_specs(self, shape: ShapeConfig) -> dict:
        """(cache, tokens) stand-ins for a decode-shape cell: one new token
        against a cache of ``shape.seq_len`` context (a windowed config's
        ring holds the window)."""
        B = shape.global_batch
        return {"cache": self.init_cache(B, shape.seq_len, device="meta"),
                "tokens": torch.empty((B,), dtype=torch.int32, device="meta")}

    def make_inputs(self, key, shape: ShapeConfig) -> dict:
        """The reference's synthetic batch for ``key`` (a ``jax_random`` key),
        on this model's device: ``randint`` tokens over the vocabulary, split
        into tokens and next-token targets, and for a prefix-embed family
        ``normal * 0.02`` embeds in the model dtype."""
        c = self.cfg
        lay = self._batch_layout(shape)
        B, P, S = shape.global_batch, lay["prefix"], lay["tokens"]
        kt, ke = jax_random.split(key)
        tokens = jax_random.randint(kt, (B, S + 1), 0, c.vocab_size).to(self.device)
        batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        if P > 0:
            embeds = jax_random.normal(ke, (B, P, c.d_model), self.device) * 0.02
            batch["embeds"] = embeds.to(self.dtype)
        return batch


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> LM:
    return LM(cfg, device)
