"""The launcher's mesh, for code that needs it without a parameter
(counterpart of ``repro.distributed.context``).  It lives in
``utils.shard_ctx``, which registers a sharded run's mesh as the current
one; the reference's ``compat_shard_map`` has no counterpart: a rank of
the port runs its own process, not a shard_map region."""

from repro_torch.utils.shard_ctx import current_mesh, set_current_mesh

__all__ = ["current_mesh", "set_current_mesh"]
