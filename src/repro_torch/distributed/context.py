"""The launcher's mesh, for code that needs it without a parameter
(counterpart of ``repro.distributed.context``).  The reference's
``compat_shard_map`` has no counterpart: a rank of the port runs its own
process, not a shard_map region."""

from __future__ import annotations

from typing import Optional

_CURRENT = None


def set_current_mesh(mesh: Optional[object]) -> None:
    global _CURRENT
    _CURRENT = mesh


def current_mesh() -> Optional[object]:
    return _CURRENT
