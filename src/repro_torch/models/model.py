"""Unified LM wrapper (counterpart of ``repro.models.model``): one object
per architecture exposing ``init``, ``loss_fn``, ``fo_loss_fn`` and the
serving paths.  The ``dense``, ``moe``, ``vlm`` and ``audio`` families
(``models.transformer``; a vlm or audio batch may carry prefix ``embeds
[B, P, D]``, the modality stubs), the ``hybrid`` family (``models.hymba``)
and the ``ssm`` family (``models.xlstm``) are ported; only the transformer
families have the paged serving paths."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.spec import init_params
from repro_torch.models.transformer import TransformerLM, torch_dtype
from repro_torch.models.xlstm import XLSTMLM
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

    def init(self, key) -> Any:
        """The reference's random parameters for ``key``
        (``utils.jax_random.PRNGKey(seed)``), drawn on this model's device
        (see models/spec.py)."""
        return init_params(self._specs, key, self.dtype, self.device)

    # ---- train ------------------------------------------------------------
    def loss_fn(self, params: Any, batch: Any) -> torch.Tensor:
        """Mean next-token cross-entropy (f32 scalar on the device); a
        forward without autograd, as ZO training never differentiates."""
        with torch.inference_mode():
            return self.impl.loss_fn(params, batch)

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

    def init_cache(self, batch_size: int, max_len: int):
        return self.impl.init_cache(batch_size, max_len)

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


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> LM:
    return LM(cfg, device)
