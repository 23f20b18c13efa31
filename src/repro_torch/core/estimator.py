"""ZO methods: perturbation semantics and optimizer updates (counterpart
of ``repro.core.estimator``; the TeZO and MeZO families).

  tezo        G = κ·Σ_s τ_s (u_s∘v_s)                          [Alg. 1 L11]
  tezo_m      τ_M ← β₁τ_M + (1−β₁)κτ ;  G = recon(τ_M)          [L12-13]
  tezo_adam   + τ_V ← β₂τ_V + (1−β₂)κ²τ² ;  G = M/√(V+ε)        [L14-18]
  mezo        G = mean_i κ_i z_i, z ~ N(0, I) dense per leaf   (Malladi et al.)
  mezo_m      M ← β₁M + (1−β₁)G  (f32 per leaf)
  mezo_adam   + V ← β₂V + (1−β₂)G² ;  W ← W − lr·M/√(V+ε)

A method implements the transitions of ``core.zo_step``'s chained step:
``perturb`` (first perturb and flip), ``perturb_pair`` (the bridge),
``perturb_chain`` and ``update`` with an optional folded restore.  The leaf
math is ``core.dispatch``'s; the methods own the optimizer state.

Random draws.  Every τ and dense z a step needs is a pure function of
(step key, probe, leaf path).  A leaf the noise kernels cover draws its z
on the device from its key alone (``kernels.zo_noise``), inside each pass;
everything else — every τ and the z of the few leaves the kernels do not
cover — :meth:`ZOMethod.draws` makes on the host at the start of the step
(``utils.jax_random``, one vectorized pass) and sends to the device in one
pinned, non-blocking copy (:class:`StepNoise`).  Keys are host ints and
nothing is read back, so a step never waits on the device.  TeZO's
probe-mean folds run on the device over the flat concatenation of every
low-rank leaf's τ (elementwise, so the same bits as per-leaf folds).

The LOZO and SubZO families are not ported yet (ROADMAP.md Queue A item
10); :func:`get_method` raises for them.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.cpd import dense_key, init_factors, tau_key
from repro_torch.utils import jax_random
from repro_torch.utils.tree import flatten_with_path, map_with_path


@dataclass(frozen=True)
class ZOConfig:
    """Static configuration of a ZO fine-tuning run: the reference's fields
    that the ported code reads, under its names and defaults.  There is no
    ``kernel_mode`` (the tensor's device decides); the spectral-rank,
    LOZO and adaptive-q fields come with their modules (ROADMAP.md
    Queue A)."""

    method: str = "tezo_adam"
    rho: float = 1e-3
    lr: float = 1e-6
    rank: int = 64
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-5
    weight_decay: float = 0.0
    q_probes: int = 1
    seed: int = 0
    restore_mode: str = "inplace"  # inplace | unchained | exact
    probe_parallel: bool = False  # raises: ROADMAP.md Queue A item 13
    weight_quant: str = "none"  # raises unless "none": Queue A item 11
    lr_schedule: str = "const"  # const | cosine | linear_warmup_cosine
    warmup_steps: int = 0
    total_steps: int = 10_000

    def schedule(self, step: int) -> np.float32:
        """The learning rate at ``step``, on the host in f32 with the
        reference's arithmetic (estimator.py:118-135)."""
        f32 = np.float32
        lr = f32(self.lr)
        if self.lr_schedule == "const":
            return lr
        t = f32(min(int(step), self.total_steps))
        warm = (np.minimum(f32(1.0), (t + f32(1.0)) / f32(max(self.warmup_steps, 1)))
                if self.warmup_steps > 0 else f32(1.0))
        if self.lr_schedule in ("cosine", "linear_warmup_cosine"):
            span = f32(max(self.total_steps - self.warmup_steps, 1))
            prog = np.clip((t - f32(self.warmup_steps)) / span, f32(0.0), f32(1.0))
            return lr * warm * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * prog))
        raise ValueError(f"unknown lr_schedule {self.lr_schedule}")


def _decay_factor(lr, cfg: ZOConfig):
    """Decoupled weight-decay factor 1 − lr·wd (f32), or None."""
    if cfg.weight_decay == 0.0:
        return None
    return float(np.float32(1.0) - np.float32(lr) * np.float32(cfg.weight_decay))


class StepNoise:
    """Every τ and dense z of one step, on the device.

    Drawn on the host in one vectorized pass and copied to the device in one
    pinned, non-blocking copy.  Layout: ``[q, T]`` τ (the low-rank leaves'
    draws concatenated in path order, so :meth:`tau_flat` is the whole
    step's r-vector for a probe) followed by ``[q, D]`` dense z (f32 holding
    values already rounded to each leaf's dtype)."""

    def __init__(self, factors: dict, dense: dict, key_t, q: int, device):
        self.q = q
        self.key_t = key_t
        self._tau_meta, t_off = [], 0  # (path, offset, shape)
        for path in sorted(factors):
            f = factors[path]
            shape = f.batch + (f.rank,)
            self._tau_meta.append((path, t_off, shape))
            t_off += math.prod(shape)
        self._z_meta, z_off = [], 0  # (path, offset, shape, dtype)
        for path in sorted(dense):
            w = dense[path]
            self._z_meta.append((path, z_off, tuple(w.shape), w.dtype))
            z_off += w.numel()
        self.T, self.D = t_off, z_off

        keys, sizes = [], []
        for p in range(q):
            for path, _, shape in self._tau_meta:
                keys.append(tau_key(key_t, path, p))
                sizes.append(math.prod(shape))
        for p in range(q):
            for path, _, shape, _ in self._z_meta:
                keys.append(dense_key(key_t, path, p))
                sizes.append(math.prod(shape))
        host = jax_random.normal_many(keys, sizes)
        for p in range(q):  # dense z is drawn in f32 and rounded to the leaf dtype
            base = q * self.T + p * self.D
            for _, off, shape, dtype in self._z_meta:
                seg = host[base + off: base + off + math.prod(shape)]
                seg.copy_(seg.to(dtype).float())
        if torch.device(device).type == "cuda":
            host = host.pin_memory().to(device, non_blocking=True)
        self._buf = host
        self._tau = {}
        for p in range(q):
            for path, off, shape in self._tau_meta:
                start = p * self.T + off
                self._tau[path, p] = self._buf[start:start + math.prod(shape)].view(shape)
        self._z = {}
        for p in range(q):
            base = q * self.T + p * self.D
            for path, off, shape, dtype in self._z_meta:
                seg = self._buf[base + off: base + off + math.prod(shape)].view(shape)
                self._z[path, p] = seg.to(dtype)

    def tau(self, path: str, probe: int) -> torch.Tensor:
        return self._tau[path, probe]

    def taus(self, path: str, probes) -> list:
        return [self._tau[path, p] for p in probes]

    def tau_flat(self, probe: int) -> torch.Tensor:
        return self._buf[probe * self.T:(probe + 1) * self.T]

    def z(self, path: str, probe: int) -> torch.Tensor:
        return self._z[path, probe]

    def dense_z(self, path: str):
        """``probe -> z`` of one leaf drawn on the host (what the dense
        leaf ops take for a leaf the noise kernels do not cover)."""
        return functools.partial(self.z, path)

    def split(self, flat: torch.Tensor) -> dict:
        """A flat [T] vector back into per-leaf views keyed by path."""
        return {path: flat[off:off + math.prod(shape)].view(shape)
                for path, off, shape in self._tau_meta}

    def cat(self, per_leaf: dict) -> torch.Tensor:
        """Per-leaf r-vectors into one flat [T] vector in path order."""
        return torch.cat([per_leaf[path].reshape(-1) for path, _, _ in self._tau_meta])


def _out(out, path):
    return None if out is None else out[path]


def _restore_tau(noise: StepNoise, path, restore_probe):
    return None if restore_probe is None else noise.tau(path, restore_probe)


class ZOMethod:
    """Base class; all run state lives in the ``mstate`` dict.  ``out`` (a
    {path: tensor} dict or None) names where each transition writes: None
    updates the params in place.

    The base class routes the three perturb transitions leaf by leaf: a
    leaf with a CPD factor (:meth:`factors`) takes the TeZO kernels, any
    other the dense-noise ops (the noise kernels where the leaf is
    eligible, else the step's pre-drawn z)."""

    name: str = "base"

    def init(self, params, key, cfg: ZOConfig, ranks: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        raise NotImplementedError

    def factors(self, mstate) -> dict:
        """{path: CPDFactor} of the leaves perturbed in τ-space."""
        return {}

    def draws(self, params, mstate, key_t, cfg: ZOConfig) -> StepNoise:
        """The step's τ for every factor leaf and host z for every leaf that
        has no factor and does not fit the noise kernels; an eligible leaf
        needs nothing but its key."""
        factors = self.factors(mstate)
        dense = {}

        def visit(path, w):
            if path not in factors and not dispatch.noise_kernel_eligible(w):
                dense[path] = w
            return w

        map_with_path(visit, params)
        device = flatten_with_path(params)[0][1].device
        return StepNoise(factors, dense, key_t, cfg.q_probes, device)

    def perturb_chain(self, params, mstate, noise, probes, scales, cfg, out=None):
        """scalesᵢ·Z_pᵢ in chain order, one pass per leaf."""
        factors = self.factors(mstate)
        probes, scales = tuple(probes), tuple(scales)

        def f(path, w):
            if path in factors:
                return dispatch.perturb_chain_leaf(w, factors[path], noise.taus(path, probes),
                                                   scales, out=_out(out, path))
            return dispatch.noise_perturb_chain_leaf(
                w, noise.key_t, path, probes, scales, noise.dense_z(path), out=_out(out, path))

        return map_with_path(f, params)

    def perturb(self, params, mstate, noise, probe, scale, cfg, out=None):
        return self.perturb_chain(params, mstate, noise, [probe], [scale], cfg, out=out)

    def perturb_pair(self, params, mstate, noise, probe_a, scale_a, probe_b, scale_b,
                     cfg, out=None):
        """The bridge: restore probe a and perturb probe b in one pass."""
        return self.perturb_chain(params, mstate, noise, [probe_a, probe_b],
                                  [scale_a, scale_b], cfg, out=out)


# --------------------------------------------------------------------------
# TeZO family
# --------------------------------------------------------------------------


class TeZO(ZOMethod):
    """Plain TeZO (ZO-SGD in τ-space)."""

    name = "tezo"

    def init(self, params, key, cfg, ranks=None):
        return {"factors": init_factors(params, jax_random.fold_in(key, 1),
                                        default_rank=cfg.rank, ranks=ranks)}

    def factors(self, mstate):
        return mstate["factors"]

    @staticmethod
    def _ktau(noise: StepNoise, kappas, square=False) -> torch.Tensor:
        """mean_i κ_i τ_i (``square``: κ_i²τ_i²) over every low-rank leaf at
        once: the flat [T] r-vectors of the step."""
        return dispatch.kappa_fold(kappas, [noise.tau_flat(i) for i in range(noise.q)],
                                   square=square)

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        factors = mstate["factors"]
        decay = _decay_factor(lr, cfg)
        ktau = noise.split(self._ktau(noise, kappas))

        def f(path, w):
            if path in factors:
                return dispatch.sgd_update_leaf(
                    w, factors[path], ktau[path], lr, decay=decay,
                    restore_tau=_restore_tau(noise, path, restore_probe),
                    restore_scale=restore_scale)
            return dispatch.noise_sgd_update_leaf(
                w, noise.key_t, path, kappas, lr, noise.dense_z(path), decay=decay,
                restore_probe=restore_probe, restore_scale=restore_scale)

        return map_with_path(f, params), mstate


class TeZOMomentum(TeZO):
    """TeZO-m: momentum on κτ (r floats per leaf), dense momentum buffers on
    the dense leaves."""

    name = "tezo_m"

    def init(self, params, key, cfg, ranks=None):
        mstate = super().init(params, key, cfg, ranks)
        factors = mstate["factors"]
        mstate["tau_m"] = {
            p: torch.zeros(f.batch + (f.rank,), dtype=torch.float32, device=f.u.device)
            for p, f in factors.items()
        }
        dense_m = {}

        def visit(path, w):
            if path not in factors:
                dense_m[path] = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            return w

        map_with_path(visit, params)
        mstate["dense_m"] = dense_m
        return mstate

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        factors = mstate["factors"]
        decay = _decay_factor(lr, cfg)
        tm = cfg.beta1 * noise.cat(mstate["tau_m"]) + (1.0 - cfg.beta1) * self._ktau(
            noise, kappas)
        new_tau_m = noise.split(tm)
        new_dense_m = dict(mstate["dense_m"])

        def f(path, w):
            if path in factors:
                return dispatch.sgd_update_leaf(
                    w, factors[path], new_tau_m[path], lr, decay=decay,
                    restore_tau=_restore_tau(noise, path, restore_probe),
                    restore_scale=restore_scale)
            w, new_dense_m[path] = dispatch.noise_momentum_update_leaf(
                w, mstate["dense_m"][path], noise.key_t, path, kappas, lr, cfg.beta1,
                noise.dense_z(path), decay=decay, restore_probe=restore_probe,
                restore_scale=restore_scale)
            return w

        params = map_with_path(f, params)
        return params, {**mstate, "tau_m": new_tau_m, "dense_m": new_dense_m}


class TeZOAdam(TeZOMomentum):
    """TeZO-Adam with the separable second moment (Eq. 8)."""

    name = "tezo_adam"

    def init(self, params, key, cfg, ranks=None):
        mstate = super().init(params, key, cfg, ranks)
        mstate["tau_v"] = {p: torch.zeros_like(t) for p, t in mstate["tau_m"].items()}
        mstate["dense_v"] = {p: torch.zeros_like(m) for p, m in mstate["dense_m"].items()}
        return mstate

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        factors = mstate["factors"]
        decay = _decay_factor(lr, cfg)
        tm = cfg.beta1 * noise.cat(mstate["tau_m"]) + (1.0 - cfg.beta1) * self._ktau(
            noise, kappas)
        tv = cfg.beta2 * noise.cat(mstate["tau_v"]) + (1.0 - cfg.beta2) * self._ktau(
            noise, kappas, square=True)
        new_tau_m, new_tau_v = noise.split(tm), noise.split(tv)
        new_dense_m, new_dense_v = dict(mstate["dense_m"]), dict(mstate["dense_v"])

        def f(path, w):
            if path in factors:
                return dispatch.adam_update_leaf(
                    w, factors[path], new_tau_m[path], new_tau_v[path], lr, cfg.eps,
                    decay=decay, restore_tau=_restore_tau(noise, path, restore_probe),
                    restore_scale=restore_scale)
            w, new_dense_m[path], new_dense_v[path] = dispatch.noise_adam_update_leaf(
                w, mstate["dense_m"][path], mstate["dense_v"][path], noise.key_t, path, kappas,
                lr, cfg.beta1, cfg.beta2, cfg.eps, noise.dense_z(path), decay=decay,
                restore_probe=restore_probe, restore_scale=restore_scale)
            return w

        params = map_with_path(f, params)
        return params, {**mstate, "tau_m": new_tau_m, "tau_v": new_tau_v,
                        "dense_m": new_dense_m, "dense_v": new_dense_v}


# --------------------------------------------------------------------------
# MeZO family (Malladi et al., 2023): the dense baselines
# --------------------------------------------------------------------------


class MeZO(ZOMethod):
    """MeZO: every leaf perturbed with a dense N(0, I) z, ZO-SGD on it."""

    name = "mezo"

    def init(self, params, key, cfg, ranks=None):
        return {}

    def _moments(self, params) -> dict:
        return {path: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                for path, w in flatten_with_path(params)}

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        decay = _decay_factor(lr, cfg)

        def f(path, w):
            return dispatch.noise_sgd_update_leaf(
                w, noise.key_t, path, kappas, lr, noise.dense_z(path), decay=decay,
                restore_probe=restore_probe, restore_scale=restore_scale)

        return map_with_path(f, params), mstate


class MeZOMomentum(MeZO):
    """MeZO-m: an f32 momentum buffer per leaf."""

    name = "mezo_m"

    def init(self, params, key, cfg, ranks=None):
        return {"m": self._moments(params)}

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        decay = _decay_factor(lr, cfg)
        new_m = dict(mstate["m"])

        def f(path, w):
            w, new_m[path] = dispatch.noise_momentum_update_leaf(
                w, mstate["m"][path], noise.key_t, path, kappas, lr, cfg.beta1,
                noise.dense_z(path), decay=decay, restore_probe=restore_probe,
                restore_scale=restore_scale)
            return w

        params = map_with_path(f, params)
        return params, {"m": new_m}


class MeZOAdam(MeZO):
    """MeZO-Adam: dense f32 first and second moments per leaf."""

    name = "mezo_adam"

    def init(self, params, key, cfg, ranks=None):
        return {"m": self._moments(params), "v": self._moments(params)}

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        decay = _decay_factor(lr, cfg)
        new_m, new_v = dict(mstate["m"]), dict(mstate["v"])

        def f(path, w):
            w, new_m[path], new_v[path] = dispatch.noise_adam_update_leaf(
                w, mstate["m"][path], mstate["v"][path], noise.key_t, path, kappas, lr,
                cfg.beta1, cfg.beta2, cfg.eps, noise.dense_z(path), decay=decay,
                restore_probe=restore_probe, restore_scale=restore_scale)
            return w

        params = map_with_path(f, params)
        return params, {"m": new_m, "v": new_v}


METHODS: dict[str, ZOMethod] = {m.name: m for m in [
    TeZO(), TeZOMomentum(), TeZOAdam(), MeZO(), MeZOMomentum(), MeZOAdam()]}

NOT_PORTED = {"lozo": 10, "lozo_m": 10, "subzo": 10}


def get_method(name: str) -> ZOMethod:
    if name in NOT_PORTED:
        raise KeyError(
            f"ZO method {name!r} is not ported yet (ROADMAP.md Queue A item "
            f"{NOT_PORTED[name]}); the port has {sorted(METHODS)}"
        )
    if name not in METHODS:
        raise KeyError(f"unknown ZO method {name!r}; available: {sorted(METHODS)}")
    return METHODS[name]
