"""First-order baselines on torch autograd (counterpart of
``repro.optim.fo``): AdamW and SGD (with or without momentum), and the
backprop step that the trainer's ``--pretrain-steps`` runs so that ZO
fine-tuning starts from a trained point, as the paper's runs do.

An optimizer is an ``(init, update)`` pair over the port's nested-dict
param trees; ``update(grads, opt_state, params, step)`` returns new params
and a new state and keeps the reference's arithmetic: f32 moments,
``t = step + 1`` in f32 for the bias corrections, and
``p.f32 − lr·(m̂/(√v̂ + ε) + wd·p.f32)`` cast back to ``p``'s dtype, each op
rounded on its own.  The bias corrections divide as 0-dim tensors on the
params' device, so no backend turns the division into a multiply by a
reciprocal.

The step differentiates ``loss_fn`` with ``torch.autograd``.  The loss it is
given must run with autograd (``models.model.LM.fo_loss_fn``): the
hand-written kernels have no backward, and their wrappers raise under
autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_path, map_with_path


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]


def _zeros_f32(params) -> dict:
    return map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _by_path(tree) -> dict:
    return dict(flatten_with_path(tree))


def adamw(
    lr: float = 1e-3,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update(grads, state, params, step):
        f32 = np.float32
        t = f32(step) + f32(1.0)
        bc1 = f32(1.0) - f32(beta1) ** t
        bc2 = f32(1.0) - f32(beta2) ** t
        g_at, m_at, v_at = _by_path(grads), _by_path(state["m"]), _by_path(state["v"])
        dev = next(iter(m_at.values())).device
        d1, d2 = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (bc1, bc2))
        new_m, new_v = {}, {}

        def upd(path, p):
            g = g_at[path].float()
            m = beta1 * m_at[path] + (1.0 - beta1) * g
            v = beta2 * v_at[path] + (1.0 - beta2) * g * g
            pf = p.float()
            step_val = lr * (m / d1 / (torch.sqrt(v / d2) + eps) + weight_decay * pf)
            new_m[path], new_v[path] = m, v
            return (pf - step_val).to(p.dtype)

        new_p = map_with_path(upd, params)
        return new_p, {"m": map_with_path(lambda path, _: new_m[path], params),
                       "v": map_with_path(lambda path, _: new_v[path], params)}

    return Optimizer(init, update)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return {} if momentum == 0.0 else {"m": _zeros_f32(params)}

    def update(grads, state, params, step):
        g_at = _by_path(grads)
        if momentum == 0.0:
            return map_with_path(
                lambda path, p: (p.float() - lr * g_at[path].float()).to(p.dtype), params), state
        new_m = map_with_path(lambda path, m: momentum * m + g_at[path].float(), state["m"])
        m_at = _by_path(new_m)
        new_p = map_with_path(lambda path, p: (p.float() - lr * m_at[path]).to(p.dtype), params)
        return new_p, {"m": new_m}

    return Optimizer(init, update)


@dataclass
class FOTrainState:
    params: Any
    opt_state: Any
    step: int  # host int (the reference's int32 scalar)


def init_fo_state(params, optimizer: Optimizer) -> FOTrainState:
    return FOTrainState(params, optimizer.init(params), 0)


def build_fo_train_step(loss_fn, optimizer: Optimizer):
    """The backprop step, the paper's FT baseline: ``loss_fn(params, batch)``
    must run with autograd.  Returns the new state and ``{"loss": f32
    scalar}`` on the device."""

    def step_fn(state: FOTrainState, batch):
        flat = flatten_with_path(state.params)
        leaves = {path: w.detach().requires_grad_() for path, w in flat}
        params = map_with_path(lambda path, _: leaves[path], state.params)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        g_at = {path: torch.zeros_like(w) if g is None else g
                for (path, w), g in zip(flat, grads)}
        new_params, new_opt = optimizer.update(
            map_with_path(lambda path, _: g_at[path], state.params), state.opt_state,
            state.params, state.step)
        return FOTrainState(new_params, new_opt, state.step + 1), {"loss": loss.detach()}

    return step_fn
