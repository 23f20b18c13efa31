"""Shared inputs for the port's parity tests (tests/test_torch_*.py): model
parameters made with numpy from a seed, in the reference's tree layout, so
the same values go to the reference (as jnp arrays) and to the port
(through ``repro_torch.models.bridge``).  Drawing them with numpy instead of
the reference's jitted init keeps the tests inside their time budget."""

import jax.numpy as jnp
import numpy as np

from repro_torch.models import build_model
from repro_torch.models.spec import PSpec


def numpy_params(cfg, seed: int, dtype=np.float32) -> dict:
    """normal * spec.scale for normal leaves; normal * 0.1 for the norm
    scales the reference initializes to zeros, so ``1 + scale`` is
    exercised.  ``dtype`` may be ``jnp.bfloat16`` (an ml_dtypes type)."""
    rng = np.random.default_rng(seed)
    specs = build_model(cfg, device="cpu").impl.param_specs()

    def make(node):
        if isinstance(node, PSpec):
            scale = node.scale if node.init == "normal" else 0.1
            return (rng.standard_normal(node.shape) * scale).astype(np.float32).astype(dtype)
        return {k: make(v) for k, v in node.items()}

    return make(specs)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)
