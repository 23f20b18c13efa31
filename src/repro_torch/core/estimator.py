"""ZO methods: perturbation semantics and optimizer updates (counterpart
of ``repro.core.estimator``; all nine methods).

  tezo        G = κ·Σ_s τ_s (u_s∘v_s)                          [Alg. 1 L11]
  tezo_m      τ_M ← β₁τ_M + (1−β₁)κτ ;  G = recon(τ_M)          [L12-13]
  tezo_adam   + τ_V ← β₂τ_V + (1−β₂)κ²τ² ;  G = M/√(V+ε)        [L14-18]
  mezo        G = mean_i κ_i z_i, z ~ N(0, I) dense per leaf   (Malladi et al.)
  mezo_m      M ← β₁M + (1−β₁)G  (f32 per leaf)
  mezo_adam   + V ← β₂V + (1−β₂)G² ;  W ← W − lr·M/√(V+ε)
  lozo        Z = U·Vᵀ, U lazy (fixed for ν steps), V fresh    (Chen et al.)
  lozo_m      momentum on the V side, reset when U rotates
  subzo       Z = U·Σ·Vᵀ, U, V orthonormal and lazy, Σ fresh  (Yu et al.)

A method implements the transitions of ``core.zo_step``'s chained step:
``begin_step`` (the lazy refreshes), ``perturb`` (first perturb and flip),
``perturb_pair`` (the bridge), ``perturb_chain`` and ``update`` with an
optional folded restore.  The leaf math is ``core.dispatch``'s (LOZO's and
SubZO's perturb chains call their kernel wrappers, ``lozo_chain_k`` and
``subzo_perturb``, directly); the methods own the optimizer state.

Random draws.  Every τ, Σ, V, U and dense z a step needs is a pure function
of (step key or window, probe, leaf path).  A leaf the noise kernels cover
draws its z on the device from its key alone (``kernels.zo_noise``), inside
each pass.  Everything small — every τ and the z of the few leaves the
kernels do not cover — :meth:`ZOMethod.draws` makes on the host at the
start of the step (``utils.jax_random``, one vectorized pass) and sends to
the device in one pinned, non-blocking copy (:class:`StepNoise`).  LOZO's
V (3.4 M normals per step at opt-125m's width and rank 24) and SubZO's Σ
cores (43 k, too slow on the host) are drawn on the device every step, and
LOZO's U once per window, kept outside the method state; SubZO's U and V
are drawn and orthonormalized on the device at each window boundary.  Keys
are host ints and nothing is read back, so a step never waits on the
device.  The probe-mean folds run on the device over the flat concatenation
of every low-rank leaf's draws (elementwise, so the same bits as per-leaf
folds).

Sharded state (``utils.shard_ctx``).  The params and the
leaf-shaped state are this rank's shards; every draw above is made whole on
every rank, at the whole leaf's shape, and cut where a leaf op takes it
(τ and Σ on the leaf's batch dims, U and u on its rows, V and v on its
columns, a dense z as the leaf), so each rank's slice is the unsharded
draw's.  τ-space moments stay whole on every rank; LOZO-m's V-side
momentum is gathered for its fold and cut again.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.cpd import dense_key, init_factors, is_lowrank_leaf, tau_key
from repro_torch.kernels.subzo_perturb import subzo_perturb
from repro_torch.kernels.tezo_perturb import lozo_chain_k
from repro_torch.utils import jax_random, shard_ctx
from repro_torch.utils.tree import flatten_with_path, fold_in_path, map_with_path


@dataclass(frozen=True)
class ZOConfig:
    """Static configuration of a ZO fine-tuning run: the reference's fields
    that the ported code reads, under its names and defaults.  There is no
    ``kernel_mode`` (the tensor's device decides)."""

    method: str = "tezo_adam"
    rho: float = 1e-3
    lr: float = 1e-6
    rank: int = 64  # the CP rank r of rank_mode "const"
    rank_mode: str = "const"  # const | spectral (Eq. 7 at setup: core.rank.select_ranks)
    rank_threshold: float = 0.25  # the spectral threshold (the paper's App. A.3: 20-35%)
    r_max: int = 64
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-5
    weight_decay: float = 0.0
    lazy_interval: int = 50  # LOZO/SubZO subspace refresh period ν
    q_probes: int = 1
    seed: int = 0
    restore_mode: str = "inplace"  # inplace | unchained | exact
    probe_parallel: bool = False  # the q probes over a mesh's data lanes (core.zo_step)
    adaptive_q: bool = False  # AdaZeta-style q growth by the launcher (core.adaptive)
    q_max: int = 16  # adaptive-q growth cap
    weight_quant: str = "none"  # none | nf4 | lut3 | lut4 (core.quant.QuantLeaf)
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


class ProbeDraws:
    """Per-probe draws of several leaves in one flat ``[q, T]`` buffer: row
    p holds every leaf's draw for probe p, concatenated in path order, so
    :meth:`flat` is a whole probe's draws for the probe-mean folds."""

    def __init__(self, shapes: dict, q: int):
        self.q = q
        self.meta, off = [], 0  # (path, offset, shape)
        for path in sorted(shapes):
            shape = tuple(shapes[path])
            self.meta.append((path, off, shape))
            off += math.prod(shape)
        self.T = off
        self._views: dict = {}

    def keys(self, key_fn, key) -> tuple[list, list]:
        """(keys, sizes) of the draws in buffer order; ``key_fn(key, path,
        probe)`` derives each one."""
        keys, sizes = [], []
        for p in range(self.q):
            for path, _, shape in self.meta:
                keys.append(key_fn(key, path, p))
                sizes.append(math.prod(shape))
        return keys, sizes

    def bind(self, buf: torch.Tensor) -> "ProbeDraws":
        self.buf = buf
        for p in range(self.q):
            for path, off, shape in self.meta:
                start = p * self.T + off
                self._views[path, p] = buf[start:start + math.prod(shape)].view(shape)
        return self

    def __call__(self, path: str, probe: int) -> torch.Tensor:
        return self._views[path, probe]

    def flat(self, probe: int) -> torch.Tensor:
        return self.buf[probe * self.T:(probe + 1) * self.T]

    def split(self, flat: torch.Tensor) -> dict:
        """A flat [T] vector back into per-leaf views keyed by path."""
        return {path: flat[off:off + math.prod(shape)].view(shape)
                for path, off, shape in self.meta}

    def cat(self, per_leaf: dict) -> torch.Tensor:
        """Per-leaf tensors into one flat [T] vector in path order."""
        return torch.cat([per_leaf[path].reshape(-1) for path, _, _ in self.meta])

    def fold(self, kappas, square: bool = False) -> torch.Tensor:
        """mean_i κ_i·d_i (``square``: κ_i²·d_i²) over every leaf at once."""
        return dispatch.kappa_fold(kappas, [self.flat(i) for i in range(self.q)],
                                   square=square)


class StepNoise:
    """The noise of one step, on the device.

    τ (TeZO's ``coef``, one :class:`ProbeDraws` of the ``tau`` shapes) and
    the dense z of the leaves no kernel draws for are drawn on the host in
    one vectorized pass and copied to the device in one pinned,
    non-blocking copy: ``[q, T]`` τ, then ``[q, D]`` dense z (f32 holding
    values already rounded to each leaf's dtype).  A leaf with a rank mask
    (``tau_masks``, host f32 (..., r)) has each probe's τ multiplied by it
    on the host before the copy, as the reference's ``sample_tau`` does on
    the device.  The factors a method draws on the device come in whole:
    SubZO's ``coef`` (its Σ cores), LOZO's ``u`` (its window's factor per
    leaf) and ``v`` (the fresh factors), each from :func:`_device_draws`."""

    def __init__(self, dense: dict, key_t, q: int, device, *, tau: Optional[dict] = None,
                 tau_masks: Optional[dict] = None, coef: Optional[ProbeDraws] = None,
                 u: Optional[dict] = None, v: Optional[ProbeDraws] = None):
        self.q, self.key_t = q, key_t
        self.u, self.v = u or {}, v
        host_coef = ProbeDraws(tau or {}, q)
        self._z_meta, z_off = [], 0  # (path, offset, shape, dtype)
        for path in sorted(dense):
            w = dense[path]
            self._z_meta.append((path, z_off, tuple(w.shape), w.dtype))
            z_off += w.numel()
        self.D = z_off

        keys, sizes = host_coef.keys(tau_key, key_t)
        for p in range(q):
            for path, _, shape, _ in self._z_meta:
                keys.append(dense_key(key_t, path, p))
                sizes.append(math.prod(shape))
        host = jax_random.normal_many(keys, sizes)
        T = host_coef.T
        for path, off, shape in host_coef.meta:
            mask = (tau_masks or {}).get(path)
            if mask is None:
                continue
            for p in range(q):  # a multiply, not a select: -τ·0 is -0 there too
                host[p * T + off: p * T + off + math.prod(shape)].view(shape).mul_(mask)
        for p in range(q):  # dense z is drawn in f32 and rounded to the leaf dtype
            base = q * T + p * self.D
            for _, off, shape, dtype in self._z_meta:
                seg = host[base + off: base + off + math.prod(shape)]
                seg.copy_(seg.to(dtype).float())
        if torch.device(device).type == "cuda":
            host = host.pin_memory().to(device, non_blocking=True)
        self.coef = host_coef.bind(host[:q * T]) if coef is None else coef
        self._z = {}
        for p in range(q):
            base = q * T + p * self.D
            for path, off, shape, dtype in self._z_meta:
                seg = host[base + off: base + off + math.prod(shape)].view(shape)
                self._z[path, p] = seg.to(dtype)

    def z(self, path: str, probe: int) -> torch.Tensor:
        return shard_ctx.like(path, self._z[path, probe])

    def dense_z(self, path: str):
        """``probe -> z`` of one leaf drawn on the host (what the dense
        leaf ops take for a leaf the noise kernels do not cover)."""
        return functools.partial(self.z, path)


def _out(out, path):
    return None if out is None else out[path]


def _restore(draws, path, restore_probe, cut=shard_ctx.lead):
    """One leaf's restore operand for ``update``: None, the draw of one
    probe, or (``restore_probe`` a tuple) the draws of a whole chain in
    order — the probe-parallel step restores the 3q-delta trajectory —
    each cut to this rank's shard by ``cut``."""
    if restore_probe is None:
        return None
    if isinstance(restore_probe, (list, tuple)):
        return [cut(path, draws(path, p)) for p in restore_probe]
    return cut(path, draws(path, restore_probe))


def _dense_leaves(params, covered) -> dict:
    """{path: leaf} of the leaves that are not in ``covered`` and do not fit
    the noise kernels: their z is drawn on the host (a sharded leaf by its
    whole meta view)."""
    dense = {}

    def visit(path, w):
        w = shard_ctx.view(path, w)
        if path not in covered and not dispatch.noise_kernel_eligible(w):
            dense[path] = w
        return w

    map_with_path(visit, params)
    return dense


def _whole_batch(path: str, batch: tuple) -> tuple:
    """A leaf's leading (batch) dims, whole when the leaf is sharded."""
    return tuple(shard_ctx.whole_shape(path, tuple(batch) + (0, 0))[:-2])


def _device(params):
    return flatten_with_path(params, atomic=True)[0][1].device


class ZOMethod:
    """Base class; all run state lives in the ``mstate`` dict.  ``out`` (a
    {path: tensor} dict or None) names where each transition writes: None
    updates the params in place.

    The base class routes the perturb transitions leaf by leaf: a leaf the
    method perturbs in low rank goes to :meth:`lowrank_chain`, any other to
    the dense-noise ops (the noise kernels where the leaf is eligible, else
    the step's pre-drawn z)."""

    name: str = "base"

    def init(self, params, key, cfg: ZOConfig, ranks: Optional[dict] = None,
             rank_masks: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def begin_step(self, mstate, key_t, step: int, cfg: ZOConfig) -> dict:
        """The state at the top of step ``step``, before the draws (the
        lazy-subspace refreshes); the identity unless a method refreshes."""
        return mstate

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        """The optimizer step from the [q] κ vector, the restore deltas
        first in the same pass: ``restore_probe`` one probe id (the chained
        step's last restore) or a tuple of them with a tuple of scales (the
        probe-parallel step's whole trajectory)."""
        raise NotImplementedError

    def factors(self, mstate) -> dict:
        """{path: CPDFactor} of the leaves perturbed in τ-space."""
        return {}

    def draws(self, params, mstate, key_t, cfg: ZOConfig, step: int = 0,
              cache: Optional[dict] = None) -> StepNoise:
        """The step's τ for every factor leaf and host z for every leaf that
        has no factor and does not fit the noise kernels, for probes 0 ..
        ``cfg.q_probes`` - 1 (the ensemble's n members are probes 0 .. n-1);
        an eligible leaf needs nothing but its key.  ``cache`` is the run's
        own dict (the step function keeps one) for what a method reuses
        across steps."""
        factors = self.factors(mstate)
        return StepNoise(_dense_leaves(params, factors), key_t, cfg.q_probes, _device(params),
                         tau={p: _whole_batch(p, f.batch) + (f.rank,)
                              for p, f in factors.items()},
                         tau_masks={p: f.rank_mask for p, f in factors.items()
                                    if f.rank_mask is not None})

    def lowrank_chain(self, path, w, mstate, noise, probes, scales, out):
        """The chain on one of the method's low-rank leaves, or None if
        ``path`` is not one."""
        factors = self.factors(mstate)
        if path not in factors:
            return None
        return dispatch.perturb_chain_leaf(
            w, factors[path], [shard_ctx.lead(path, noise.coef(path, p)) for p in probes],
            scales, out=out)

    def perturb_chain(self, params, mstate, noise, probes, scales, cfg, out=None):
        """scalesᵢ·Z_pᵢ in chain order, one pass per leaf."""
        probes, scales = tuple(probes), tuple(scales)

        def f(path, w):
            res = self.lowrank_chain(path, w, mstate, noise, probes, scales, _out(out, path))
            if res is not None:
                return res
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

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
        return {"factors": init_factors(params, jax_random.fold_in(key, 1),
                                        default_rank=cfg.rank, ranks=ranks,
                                        rank_masks=rank_masks)}

    def factors(self, mstate):
        return mstate["factors"]

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        factors = mstate["factors"]
        decay = _decay_factor(lr, cfg)
        ktau = noise.coef.split(noise.coef.fold(kappas))

        def f(path, w):
            if path in factors:
                return dispatch.sgd_update_leaf(
                    w, factors[path], shard_ctx.lead(path, ktau[path]), lr, decay=decay,
                    restore_tau=_restore(noise.coef, path, restore_probe),
                    restore_scale=restore_scale)
            return dispatch.noise_sgd_update_leaf(
                w, noise.key_t, path, kappas, lr, noise.dense_z(path), decay=decay,
                restore_probe=restore_probe, restore_scale=restore_scale)

        return map_with_path(f, params), mstate


class TeZOMomentum(TeZO):
    """TeZO-m: momentum on κτ (r floats per leaf), dense momentum buffers on
    the dense leaves."""

    name = "tezo_m"

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
        mstate = super().init(params, key, cfg, ranks, rank_masks)
        factors = mstate["factors"]
        mstate["tau_m"] = {  # whole on every rank, as τ is
            p: torch.zeros(_whole_batch(p, f.batch) + (f.rank,), dtype=torch.float32,
                           device=f.u.device)
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
        tm = (cfg.beta1 * noise.coef.cat(mstate["tau_m"])
              + (1.0 - cfg.beta1) * noise.coef.fold(kappas))
        new_tau_m = noise.coef.split(tm)
        new_dense_m = dict(mstate["dense_m"])

        def f(path, w):
            if path in factors:
                return dispatch.sgd_update_leaf(
                    w, factors[path], shard_ctx.lead(path, new_tau_m[path]), lr, decay=decay,
                    restore_tau=_restore(noise.coef, path, restore_probe),
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

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
        mstate = super().init(params, key, cfg, ranks, rank_masks)
        mstate["tau_v"] = {p: torch.zeros_like(t) for p, t in mstate["tau_m"].items()}
        mstate["dense_v"] = {p: torch.zeros_like(m) for p, m in mstate["dense_m"].items()}
        return mstate

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        factors = mstate["factors"]
        decay = _decay_factor(lr, cfg)
        tm = (cfg.beta1 * noise.coef.cat(mstate["tau_m"])
              + (1.0 - cfg.beta1) * noise.coef.fold(kappas))
        tv = (cfg.beta2 * noise.coef.cat(mstate["tau_v"])
              + (1.0 - cfg.beta2) * noise.coef.fold(kappas, square=True))
        new_tau_m, new_tau_v = noise.coef.split(tm), noise.coef.split(tv)
        new_dense_m, new_dense_v = dict(mstate["dense_m"]), dict(mstate["dense_v"])

        def f(path, w):
            if path in factors:
                return dispatch.adam_update_leaf(
                    w, factors[path], shard_ctx.lead(path, new_tau_m[path]),
                    shard_ctx.lead(path, new_tau_v[path]), lr, cfg.eps,
                    decay=decay, restore_tau=_restore(noise.coef, path, restore_probe),
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

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
        return {}

    def _moments(self, params) -> dict:
        """f32 zeros per leaf, a QuantLeaf's of its dense shape."""
        return {path: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                for path, w in flatten_with_path(params, atomic=True)}

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

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
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

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
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


# --------------------------------------------------------------------------
# LOZO (Chen et al., 2024): Z = U·Vᵀ, lazy U
# --------------------------------------------------------------------------


def _lowrank_rank(w, cfg: ZOConfig) -> int:
    return min(cfg.rank, w.shape[-2], w.shape[-1])


def _lozo_u_key(base_key, window: int, path: str):
    return fold_in_path(jax_random.fold_in(base_key, window), path + "#U")


def _lozo_v_key(key_t, path: str, probe: int):
    return fold_in_path(jax_random.fold_in(key_t, probe), path + "#V")


def _sigma_key(key_t, path: str, probe: int):
    return fold_in_path(jax_random.fold_in(key_t, probe), path + "#S")


def _lozo_u(leaf, base_key, path: str, step: int, interval: int, rank: int, device="cpu"):
    """LOZO's lazy factor: a pure function of the window index step // ν,
    so it stays fixed for ν steps without being stored."""
    shape = tuple(leaf.shape[:-2]) + (leaf.shape[-2], rank)
    return jax_random.normal(_lozo_u_key(base_key, step // interval, path), shape, device)


def _lozo_v(leaf, key_t, path: str, probe: int, rank: int, device="cpu"):
    shape = tuple(leaf.shape[:-2]) + (leaf.shape[-1], rank)
    return jax_random.normal(_lozo_v_key(key_t, path, probe), shape, device)


def _sigma(key_t, path: str, probe: int, rank: int, batch: tuple, device="cpu"):
    return jax_random.normal(_sigma_key(key_t, path, probe), tuple(batch) + (rank, rank), device)


def _device_draws(shapes: dict, q: int, key_fn, key, device,
                  cache: Optional[dict] = None) -> ProbeDraws:
    """Every probe's draw of every entry of ``shapes`` (``key_fn(key, name,
    probe)`` derives each key), on the device in one vectorized pass.  With
    the run's ``cache`` the :class:`~repro_torch.utils.jax_random.NormalDraws`
    is the run's, which keeps each layout's index tensors, so per step only
    the keys go to the device; without it the layout is a one-off."""
    draws = ProbeDraws(shapes, q)
    normals = (jax_random.NormalDraws(device) if cache is None else
               cache.setdefault("normals", jax_random.NormalDraws(device)))
    return draws.bind(normals(*draws.keys(key_fn, key)))


class LOZO(ZOMethod):
    """LOZO: every low-rank leaf perturbed with U·Vᵀ, U drawn once per window
    of ν steps and V fresh per step and probe; ZO-SGD on the V side."""

    name = "lozo"

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
        return {"base_key": jax_random.key_data(jax_random.fold_in(key, 7))}

    @staticmethod
    def _window_u(cache: dict, leaves: dict, base_key, window: int, device) -> dict:
        """{path: U} of the window: drawn on the device at the first step
        of a window and kept in the run's ``cache`` (outside the method
        state, whose checkpoint keeps the reference's layout) for the rest
        of it."""
        shapes = {p: tuple(w.shape[:-2]) + (w.shape[-2], r) for p, (w, r) in leaves.items()}
        ident = (jax_random.as_key(base_key), window, tuple(sorted(shapes.items())))
        if cache.get("u_ident") != ident:
            cache.pop("u", None)  # free the last window's first
            # once per window: a one-off layout, not one the run keeps
            u = _device_draws(shapes, 1, lambda key, p, _: _lozo_u_key(key, window, p), base_key,
                              device)
            cache["u"] = {p: u(p, 0) for p in shapes}
            cache["u_ident"] = ident
        return cache["u"]

    def draws(self, params, mstate, key_t, cfg, step=0, cache=None):
        """Host z for the dense leaves; on the device, the window's U and
        every probe's fresh V for the low-rank leaves."""
        leaves = {}

        def visit(path, w):
            w = shard_ctx.view(path, w)
            if is_lowrank_leaf(path, w):
                leaves[path] = (w, _lowrank_rank(w, cfg))
            return w

        map_with_path(visit, params)
        device = _device(params)
        cache = {} if cache is None else cache
        u = self._window_u(cache, leaves, mstate["base_key"], step // cfg.lazy_interval, device)
        v = _device_draws({p: tuple(w.shape[:-2]) + (w.shape[-1], r)
                           for p, (w, r) in leaves.items()},
                          cfg.q_probes, _lozo_v_key, key_t, device, cache)
        return StepNoise(_dense_leaves(params, leaves), key_t, cfg.q_probes, device, u=u, v=v)

    def lowrank_chain(self, path, w, mstate, noise, probes, scales, out):
        if path not in noise.u:
            return None
        return lozo_chain_k(w, shard_ctx.rows(path, noise.u[path]),
                            [shard_ctx.cols(path, noise.v(path, p)) for p in probes], list(scales),
                            out=out)

    def _v_update(self, mstate, noise, kappas, cfg) -> tuple[dict, dict]:
        """({path: the V-side signal of the update}, the new mstate)."""
        return noise.v.split(noise.v.fold(kappas)), mstate

    def _dense_update(self, w, mstate, noise, path, kappas, lr, cfg, decay, restore_probe,
                      restore_scale):
        """One dense leaf's update; ``mstate`` is the new state, which it
        may complete."""
        return dispatch.noise_sgd_update_leaf(
            w, noise.key_t, path, kappas, lr, noise.dense_z(path), decay=decay,
            restore_probe=restore_probe, restore_scale=restore_scale)

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        decay = _decay_factor(lr, cfg)
        kv, mstate = self._v_update(mstate, noise, kappas, cfg)

        def f(path, w):
            if path in noise.u:
                return dispatch.lozo_update_leaf(
                    w, shard_ctx.rows(path, noise.u[path]), shard_ctx.cols(path, kv[path]), lr,
                    decay=decay, restore_v=_restore(noise.v, path, restore_probe, shard_ctx.cols),
                    restore_scale=restore_scale)
            return self._dense_update(w, mstate, noise, path, kappas, lr, cfg, decay,
                                      restore_probe, restore_scale)

        return map_with_path(f, params), mstate


class LOZOMomentum(LOZO):
    """LOZO-m: momentum on the fresh V side ([..., n, r] per low-rank leaf,
    dense f32 on the others), reset when the lazy U rotates."""

    name = "lozo_m"

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
        mstate = super().init(params, key, cfg, ranks, rank_masks)
        vm = {}

        def visit(path, w):
            device, w = w.device, shard_ctx.view(path, w)
            if is_lowrank_leaf(path, w):
                shape = tuple(w.shape[:-2]) + (w.shape[-1], _lowrank_rank(w, cfg))
            else:
                shape = tuple(w.shape)
            vm[path] = torch.zeros(shape, dtype=torch.float32, device=device)
            return w

        map_with_path(visit, params)
        mstate["v_m"] = shard_ctx.mstate_cut("v_m", vm)
        return mstate

    def begin_step(self, mstate, key_t, step, cfg):
        if step % cfg.lazy_interval:
            return mstate
        return {**mstate, "v_m": {p: torch.zeros_like(m) for p, m in mstate["v_m"].items()}}

    def _v_update(self, mstate, noise, kappas, cfg):
        """The low-rank leaves' momentum; the dense leaves' entries of the
        new ``v_m`` still hold the old momentum until their update.  Sharded,
        the low-rank entries are gathered whole for the fold and the new
        ones cut again as they are stored."""
        old = shard_ctx.mstate_whole("v_m", {p: mstate["v_m"][p] for p in noise.u})
        vm = noise.v.split(cfg.beta1 * noise.v.cat(old)
                           + (1.0 - cfg.beta1) * noise.v.fold(kappas))
        stored = shard_ctx.mstate_cut("v_m", vm)
        return vm, {**mstate, "v_m": {**mstate["v_m"], **stored}}

    def _dense_update(self, w, mstate, noise, path, kappas, lr, cfg, decay, restore_probe,
                      restore_scale):
        w, mstate["v_m"][path] = dispatch.noise_momentum_update_leaf(
            w, mstate["v_m"][path], noise.key_t, path, kappas, lr, cfg.beta1,
            noise.dense_z(path), decay=decay, restore_probe=restore_probe,
            restore_scale=restore_scale)
        return w


# --------------------------------------------------------------------------
# SubZO / SubZero (Yu et al., 2024): Z = U·Σ·Vᵀ with orthonormal lazy U, V
# --------------------------------------------------------------------------


def _fresh_uv(shapes: dict, base_key, window: int, device) -> tuple[dict, dict]:
    """The window's orthonormal factors of every leaf, ``shapes`` {path:
    (batch, m, n, r)}: Gaussians drawn on the device in one pass, then a
    reduced QR per leaf (``torch.linalg.qr``; the reference's
    ``jnp.linalg.qr`` agrees within 1e-6 with the same column signs)."""
    g = {}
    for path, (batch, m, n, r) in shapes.items():
        g[path, "#U"] = tuple(batch) + (m, r)
        g[path, "#V"] = tuple(batch) + (n, r)
    draws = _device_draws(g, 1, lambda key, name, _: fold_in_path(key, name[0] + name[1]),
                          jax_random.fold_in(base_key, window), device)
    q = {name: torch.linalg.qr(draws(name, 0)).Q.contiguous() for name in g}
    return ({p: q[p, "#U"] for p in shapes}, {p: q[p, "#V"] for p in shapes})


class SubZO(ZOMethod):
    """SubZO: every low-rank leaf perturbed with U·Σ·Vᵀ, U and V orthonormal
    and refreshed every ν steps, the r×r core Σ fresh per step and probe;
    ZO-SGD on the core."""

    name = "subzo"

    def init(self, params, key, cfg, ranks=None, rank_masks=None):
        base = jax_random.fold_in(key, 11)
        shapes = {}

        def visit(path, w):
            w = shard_ctx.view(path, w)
            if is_lowrank_leaf(path, w):
                shapes[path] = (tuple(w.shape[:-2]), w.shape[-2], w.shape[-1],
                                _lowrank_rank(w, cfg))
            return w

        map_with_path(visit, params)
        U, V = _fresh_uv(shapes, base, 0, _device(params))
        return {"base_key": jax_random.key_data(base),
                "U": {p: shard_ctx.rows(p, u) for p, u in U.items()},
                "V": {p: shard_ctx.cols(p, v) for p, v in V.items()}}

    def begin_step(self, mstate, key_t, step, cfg):
        """A fresh subspace at every window boundary.  The host knows the
        step, so the QR runs only there (the reference computes it every
        step and selects it)."""
        if step % cfg.lazy_interval:
            return mstate
        U, V = mstate["U"], mstate["V"]
        shapes = {}
        for p, u in U.items():
            *batch, m, n = shard_ctx.whole_shape(p, tuple(u.shape[:-1]) + (V[p].shape[-2],))
            shapes[p] = (tuple(batch), m, n, u.shape[-1])
        device = next(iter(U.values())).device if U else "cpu"
        U, V = _fresh_uv(shapes, mstate["base_key"], step // cfg.lazy_interval, device)
        return {**mstate, "U": {p: shard_ctx.rows(p, u) for p, u in U.items()},
                "V": {p: shard_ctx.cols(p, v) for p, v in V.items()}}

    def draws(self, params, mstate, key_t, cfg, step=0, cache=None):
        """z for the dense leaves on the host; Σ for every low-rank leaf on
        the device (43 k normals per probe at opt-125m's width and rank 24,
        which the host's torch ops draw slower than the step's device
        work)."""
        U = mstate["U"]
        device = _device(params)
        shapes = {p: _whole_batch(p, u.shape[:-2]) + (u.shape[-1],) * 2 for p, u in U.items()}
        sigma = _device_draws(shapes, cfg.q_probes, _sigma_key, key_t, device, cache)
        return StepNoise(_dense_leaves(params, U), key_t, cfg.q_probes, device, coef=sigma)

    def lowrank_chain(self, path, w, mstate, noise, probes, scales, out):
        if path not in mstate["U"]:
            return None
        sigmas = torch.stack([shard_ctx.lead(path, noise.coef(path, p)) for p in probes], dim=-3)
        return subzo_perturb(w, mstate["U"][path], mstate["V"][path], sigmas, list(scales),
                             out=out)

    def update(self, params, mstate, noise, kappas, lr, cfg, restore_probe=None,
               restore_scale=0.0):
        decay = _decay_factor(lr, cfg)
        sbar = noise.coef.split(noise.coef.fold(kappas))

        def f(path, w):
            if path in mstate["U"]:
                return dispatch.subzo_update_leaf(
                    w, mstate["U"][path], mstate["V"][path], shard_ctx.lead(path, sbar[path]), lr,
                    decay=decay,
                    restore_sigma=_restore(noise.coef, path, restore_probe),
                    restore_scale=restore_scale)
            return dispatch.noise_sgd_update_leaf(
                w, noise.key_t, path, kappas, lr, noise.dense_z(path), decay=decay,
                restore_probe=restore_probe, restore_scale=restore_scale)

        return map_with_path(f, params), mstate


METHODS: dict[str, ZOMethod] = {m.name: m for m in [
    TeZO(), TeZOMomentum(), TeZOAdam(), MeZO(), MeZOMomentum(), MeZOAdam(), LOZO(),
    LOZOMomentum(), SubZO()]}


def get_method(name: str) -> ZOMethod:
    if name not in METHODS:
        raise KeyError(f"unknown ZO method {name!r}; available: {sorted(METHODS)}")
    return METHODS[name]
