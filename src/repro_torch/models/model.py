"""Unified LM wrapper (counterpart of ``repro.models.model``): one object
per architecture exposing ``init``, ``loss_fn`` and the serving paths.
The ``dense`` family (``models.transformer``) and the ``hybrid`` family
(``models.hymba``) are ported; only the dense one has the paged serving
paths."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.spec import init_params
from repro_torch.models.transformer import TransformerLM, torch_dtype
from repro_torch.utils.device import resolve_device


_FAMILIES = {"dense": TransformerLM, "hybrid": HymbaLM}


class LM:
    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md Queue A, item "
                f"12b 'Other model families'); ported: {sorted(_FAMILIES)}"
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
        recurrent (hybrid) family keeps the dense decode path."""
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
