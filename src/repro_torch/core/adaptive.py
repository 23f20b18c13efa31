"""AdaZeta-style adaptive probe-count controller (host-level; the port's
copy of ``repro.core.adaptive``).

AdaZeta (arXiv 2406.18060) grows the ZO query budget as training
progresses: extra probes cut estimator variance exactly when the loss
surface flattens and the per-probe κ signal drowns in sampling noise.
The schedule stays entirely on the host: the step is built for a fixed q,
so growth happens between steps by rebuilding the step function with
``dataclasses.replace(cfg, q_probes=new_q)`` (the launcher does this at log
boundaries, where it reads the metrics anyway; method state carries
nothing q-shaped, so the rebuild is the whole cost).

The growth signal is the step metric ``kappa_var`` — the dispersion of
the q per-probe κ estimates — normalized by the squared mean κ magnitude
so it is scale-free.  When the EMA of that relative dispersion stays
above ``ratio`` for ``patience`` consecutive observations, q doubles
(AdaZeta's geometric schedule), capped at ``q_max``.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AdaptiveQ:
    """Host-side controller: feed it (kappa_var, kappa_abs) per log window.

    ``observe`` returns the new q when it decides to grow, else None.
    """

    q: int
    q_max: int = 16
    beta: float = 0.8        # EMA coefficient on the relative dispersion
    ratio: float = 1.0       # grow while EMA(var/|κ|²) stays above this
    patience: int = 2        # consecutive hot windows required to grow
    eps: float = 1e-12
    ema: float | None = field(default=None, init=False)
    hot: int = field(default=0, init=False)

    def observe(self, kappa_var: float, kappa_abs: float) -> int | None:
        rel = float(kappa_var) / (float(kappa_abs) ** 2 + self.eps)
        self.ema = (
            rel if self.ema is None
            else self.beta * self.ema + (1.0 - self.beta) * rel
        )
        if self.q >= self.q_max:
            return None
        if self.ema > self.ratio:
            self.hot += 1
        else:
            self.hot = 0
        if self.hot < self.patience:
            return None
        self.hot = 0
        self.q = min(2 * self.q, self.q_max)
        return self.q
