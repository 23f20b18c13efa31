"""The host mesh: D x M ranks on one machine over torch.distributed
(counterpart of ``repro.launch.mesh``).

The reference shards over a jax ``Mesh`` of devices with axes ("data",
"model"); the port runs one process per rank, and rank r sits at data
index r // M and model index r % M, as the reference reshapes its devices
to (D, M).  The ranks exchange the probe-parallel step's 2q losses on a
gloo group, and the sharded step's (``distributed.sharding``) all-gathers
of parameter shards, loss and κ partial sums and the expert-parallel MoE's
sums.  Those go through :meth:`HostMesh.all_gather`, whose backend follows
from the job's layout (:func:`collective_backend`): NCCL on the card when
every rank has a card of its own, else gloo, staged through pinned host
memory on the card (CPU ranks, or ranks that share one card: NCCL refuses
two ranks on one GPU).  The choice is made once, from the layout, and never
after an error.

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
    """This process's place on a ``data`` x ``model`` mesh of ranks, the
    gloo group that joins them (None on a one-rank mesh) and the backend of
    :meth:`all_gather` (``"gloo"``, or ``"nccl"`` with its own group)."""

    data: int
    model: int
    rank: int = 0
    group: Optional[Any] = None
    backend: str = "gloo"
    nccl_group: Optional[Any] = None

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

    def coords(self, rank: int | None = None) -> dict:
        """{axis: index} of ``rank`` (this rank by default)."""
        r = self.rank if rank is None else rank
        return {"data": r // self.model, "model": r % self.model}

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: every rank's ``t`` in rank order, on t's
        device.  gloo stages the card's tensors through pinned host memory
        (the copy to the host is a wait on the card, allowed here alone);
        NCCL gathers on the card (one card per rank)."""
        if self.group is None:
            return t[None].clone()
        if self.backend == "nccl":
            out = torch.empty((self.world,) + tuple(t.shape), dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t.contiguous(), group=self.nccl_group)
            return out
        with host_sync_allowed():  # as bytes: gloo takes any dtype so
            host = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
            parts = [torch.empty_like(host) for _ in range(self.world)]
            dist.all_gather(parts, host, group=self.group)
        out = torch.stack(parts)
        if t.device.type == "cuda":
            out = out.pin_memory().to(t.device, non_blocking=True)
        return out.view(t.dtype).view((self.world,) + tuple(t.shape))

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


def collective_backend(world: int, device) -> str:
    """The backend of a job's device collectives, from its layout: NCCL
    when the ranks run on the card and each has a card of its own (rank r
    on ``cuda:r``), else gloo (CPU ranks, or ranks sharing one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world > 1 and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(mesh: "HostMesh | None", device):
    """The device a rank runs on: its own card ``cuda:rank`` under NCCL,
    else ``device`` (the shared card or the CPU)."""
    if mesh is not None and mesh.backend == "nccl":
        return torch.device("cuda", mesh.rank)
    return torch.device(device)


def make_host_mesh(data: int = 1, model: int = 1, device="cpu") -> HostMesh:
    """The D x M mesh of this process's torch.distributed job (its world
    size must be D·M), on a gloo group, with an NCCL group beside it when
    :func:`collective_backend` picks NCCL for ``device``; a 1 x 1 mesh needs
    no job."""
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
    backend = collective_backend(n, device)
    nccl_group = dist.new_group(backend="nccl") if backend == "nccl" else None
    return HostMesh(data, model, dist.get_rank(), group, backend, nccl_group)


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
