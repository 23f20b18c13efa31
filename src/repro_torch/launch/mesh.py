"""The host mesh: D x M ranks on one machine over torch.distributed
(counterpart of ``repro.launch.mesh``).

The reference shards over a jax ``Mesh`` of devices with axes ("data",
"model"); the port runs one process per rank, and rank r sits at data
index r // M and model index r % M, as the reference reshapes its devices
to (D, M).  What the ranks exchange today is the probe-parallel step's 2q
losses a step, on a gloo group: gloo serves on the CPU and beside the card
alike (the losses cross the host anyway), and the one-card machine cannot
give two ranks NCCL on one GPU.  Sharded parameters and their device
collectives are ROADMAP.md Queue A item 13b.

:func:`host_ranks` starts the ranks of one command: under ``torchrun`` (or
as a rank it spawned) the process joins the group its environment names;
otherwise it spawns ranks 1 .. N−1 of the same command and is rank 0.
"""

from __future__ import annotations

import os
import socket
import subprocess
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.utils.device import host_sync_allowed

_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class HostMesh:
    """This process's place on a ``data`` x ``model`` mesh of ranks, and
    the gloo group that joins them (None on a one-rank mesh)."""

    data: int
    model: int
    rank: int = 0
    group: Optional[Any] = None

    axis_names = ("data", "model")

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce_losses(self, f_mat: Optional[torch.Tensor], q: int,
                          device) -> torch.Tensor:
        """The sum over the ranks of each rank's [q, 2] f32 loss rows (None
        for a rank that holds no probe), on ``device``.  The copy of the 2q
        floats to the host is the probe-parallel step's one wait on the
        card; the sync guard is lifted for it alone."""
        with host_sync_allowed():
            host = torch.zeros((q, 2), dtype=torch.float32) if f_mat is None else f_mat.cpu()
            if self.group is not None:
                dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
        if torch.device(device).type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def parse_mesh(arg: str) -> tuple[int, int]:
    """``host:D,M`` → (D, M)."""
    kind, _, dims = arg.partition(":")
    try:
        d, m = (int(x) for x in dims.split(","))
    except ValueError:
        d = m = 0
    if kind != "host" or d < 1 or m < 1:
        raise ValueError(f"--mesh expects host:D,M, got {arg!r}")
    return d, m


def make_host_mesh(data: int = 1, model: int = 1) -> HostMesh:
    """The D x M mesh of this process's torch.distributed job (its world
    size must be D·M), on a gloo group; a 1 x 1 mesh needs no job."""
    n = data * model
    if not dist.is_initialized():
        if n == 1:
            return HostMesh(data, model)
        raise RuntimeError(
            f"a {data} x {model} host mesh needs {n} ranks: start them with "
            "host_ranks (the training CLI's --mesh does) or under torchrun"
        )
    if dist.get_world_size() != n:
        raise ValueError(f"a {data} x {model} mesh needs {n} ranks; the job has "
                         f"{dist.get_world_size()}")
    group = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return HostMesh(data, model, dist.get_rank(), group)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextmanager
def host_ranks(world: int, command: list):
    """Run the body as one of ``world`` local ranks of a gloo job; yields
    this process's rank.  Under a launcher (``RANK`` and ``WORLD_SIZE`` set,
    as torchrun and this function set them) the process joins that job.
    Otherwise it spawns ``command`` (argv of a process that enters this
    function again) for ranks 1 .. world−1 and takes rank 0 itself; on the
    way out it waits for them, and raises if any failed or if its own body
    did (after stopping them).  A one-rank job starts nothing."""
    if world == 1:
        yield 0
        return
    children: list = []
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"the job has {os.environ['WORLD_SIZE']} ranks; the mesh "
                             f"needs {world}")
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = int(os.environ["MASTER_PORT"])
    else:
        rank, addr, port = 0, "localhost", _free_port()
        for r in range(1, world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       MASTER_ADDR=addr, MASTER_PORT=str(port))
            children.append(subprocess.Popen(command, env=env))
    ok = False
    try:
        dist.init_process_group("gloo", init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank, timeout=_TIMEOUT)
        yield rank
        ok = True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for child in children:
            if not ok:
                child.terminate()
            child.wait()
    failed = [r for r, child in enumerate(children, 1) if child.returncode != 0]
    if failed:
        raise RuntimeError(f"rank(s) {failed} of the {world}-rank job failed")
