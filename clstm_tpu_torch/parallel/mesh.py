"""Ranks, devices and batch rows for data-parallel training (port of
clstm_tpu/parallel/mesh.py).

The JAX package drives a 1-D device mesh from one controller. The port runs
one process per rank under ``torch.distributed``, each rank executing the
same program on its own device: a ``Mesh`` here is this process's place in
that group (its rank, the group's size, its device and the backend).

The backend rule (``backend_for``): NCCL where every rank has a card of its
own; gloo on the CPU and where several ranks share one card, which NCCL
refuses ("Duplicate GPU detected"). gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` and stages them through the host. The rule
is a choice made before the group starts, not a fallback: a backend that
fails to start raises.

Devices: rank r takes ``cuda:LOCAL_RANK`` when the caller asks for ``cuda``;
where the caller names a device (``cuda:0``, ``cpu``), every rank takes that
device and the ranks share it. A rank that asks for CUDA where there is none
raises (utils/config.py::torch_device).

Launch: ``launch`` starts N ranks with torch.multiprocessing's ``spawn``
(CUDA cannot be forked) over a file store in a temporary directory; a
launcher such as ``torchrun`` sets RANK, WORLD_SIZE, LOCAL_RANK and
MASTER_ADDR/MASTER_PORT, which ``make_mesh`` reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing

from clstm_tpu_torch.utils.config import torch_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's rank in the data-parallel process group ``group`` of
    ``size`` ranks, the device it computes on and the group's backend."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object

    @property
    def main(self) -> bool:
        """Rank 0: the rank that prints, writes logs and saves."""
        return self.rank == 0

    def rows(self, B: int) -> slice:
        """This rank's rows of a global batch of B:
        [rank*B/n, (rank+1)*B/n), as shard_batch lays them out, so rank 0's
        row 0 is global row 0."""
        if B % self.size:
            raise ValueError(f"batch of {B} rows does not divide over "
                             f"{self.size} ranks")
        n = B // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        dist.all_reduce(t, op=op, group=self.group)

    def broadcast(self, t: torch.Tensor) -> None:
        """``t`` from rank 0 to every rank, in place."""
        dist.broadcast(t, 0, group=self.group)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def backend_for(device: torch.device, shared: bool) -> str:
    """NCCL when every rank has a card of its own; gloo on the CPU and where
    ranks share one card."""
    return "nccl" if device.type == "cuda" and not shared else "gloo"


def rank_device(device, local_rank: int, size: int):
    """-> (this rank's device, whether the ranks share it): ``cuda`` without
    an index means cuda:LOCAL_RANK; a named device is shared by every rank
    (where there is more than one)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev, shared = torch.device("cuda", local_rank), False
    else:
        shared = size > 1
    return torch_device(dev), shared


def make_mesh(n: Optional[int] = None, device="cuda", *,
              rank: Optional[int] = None,
              init_method: Optional[str] = None) -> Mesh:
    """Join (or start) the data-parallel group and return this rank's Mesh.

    Without ``rank``, the rank, size and local rank come from the
    environment a launcher sets (RANK, WORLD_SIZE, LOCAL_RANK; the store
    from MASTER_ADDR/MASTER_PORT, ``init_method`` "env://"); ``launch``
    passes ``rank`` and a file store instead. ``n``, where given, must be
    the group's size. Rank 0 prints the backend and the devices."""
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no torch.distributed environment (RANK, "
                               "WORLD_SIZE): start the ranks with launch() "
                               "or a launcher such as torchrun")
        rank = int(os.environ["RANK"])
        size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        if n is None:
            raise ValueError("make_mesh(rank=...) needs the group's size n")
        size, local_rank = n, rank
    if n is not None and n != size:
        raise ValueError(f"mesh of {n} asked for in a group of {size} ranks")
    dev, shared = rank_device(device, local_rank, size)
    backend = backend_for(dev, shared)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=size,
            **({"device_id": dev} if backend == "nccl" else {}))
    elif dist.get_backend() != backend or dist.get_world_size() != size:
        raise RuntimeError(f"the process group runs {dist.get_backend()} "
                           f"over {dist.get_world_size()} ranks; this mesh "
                           f"needs {backend} over {size}")
    if rank == 0:
        print(f"# torch.distributed: {size} ranks over {backend} on "
              + (f"{dev}, shared" if shared else
                 f"{dev.type}, one device a rank"), flush=True)
    return Mesh(rank=rank, size=size, device=dev, backend=backend,
                group=dist.group.WORLD)


def shard_rows(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every array or tensor of a global batch dict
    (host-side "texts" dropped, as shard_batch drops them)."""
    return {k: v[mesh.rows(len(v))] for k, v in batch.items()
            if k != "texts"}


def pack(tensors) -> torch.Tensor:
    """Tensors -> one flat f32 buffer (a copy), for one collective."""
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def unpack(flat: torch.Tensor, like) -> list:
    """The inverse of pack: views of ``flat`` shaped (and typed) as
    ``like``."""
    out, at = [], 0
    for t in like:
        v = flat[at:at + t.numel()].view(t.shape)
        out.append(v if v.dtype == t.dtype else v.to(t.dtype))
        at += t.numel()
    return out


@torch.no_grad()
def replicate(state, mesh: Mesh):
    """Make every rank's TrainState rank 0's: the parameters and velocity in
    one broadcast of one flat buffer, the step counter in another. In place;
    returns ``state``."""
    names = [n for n, _ in state.net.named_parameters()]
    params = [p for _, p in state.net.named_parameters()]
    vel = [state.velocity[n] for n in names]
    flat = pack(params + vel).to(mesh.device)
    mesh.broadcast(flat)
    for t, v in zip(params + vel, unpack(flat, params + vel)):
        t.copy_(v)
    step = torch.tensor([state.step], dtype=torch.int64, device=mesh.device)
    mesh.broadcast(step)
    state.step = int(step.item())
    return state


def gather_rows(tensors, mesh: Mesh, B: int) -> list:
    """Each rank's rows of [b, ...] tensors -> the full [B, ...] tensors on
    every rank, in one all_reduce of zero-filled full-size buffers: each
    rank writes only its own rows, so the sum is exact."""
    rows = mesh.rows(B)
    full = [t.new_zeros((B,) + tuple(t.shape[1:]), dtype=torch.float32)
            for t in tensors]
    for f, t in zip(full, tensors):
        f[rows] = t.float()
    flat = pack(full)
    mesh.all_reduce(flat)
    return [v.to(t.dtype) for v, t in zip(unpack(flat, full), tensors)]


def plan_checksum(arrays, rng: Optional[np.random.RandomState]) -> int:
    """A 63-bit digest of an epoch plan (its index arrays) and of the
    RandomState that drew it, for plan_guard."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    if rng is not None:
        _, key, pos, *_ = rng.get_state()
        h.update(key.tobytes())
        h.update(np.int64(pos).tobytes())
    return int.from_bytes(h.digest(), "little") >> 1


def plan_guard(checksum: int, mesh: Mesh) -> None:
    """Raise on every rank unless every rank drew the same epoch plan: one
    all_reduce MAX of (c, -c). Every rank draws its plan from a RandomState
    seeded alike, so one extra draw on one rank would otherwise desync the
    ranks without a sound."""
    t = torch.tensor([checksum, -checksum], dtype=torch.int64,
                     device=mesh.device)
    mesh.all_reduce(t, op=dist.ReduceOp.MAX)
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise RuntimeError(
            f"rank {mesh.rank}: the epoch plan differs across ranks "
            f"(checksums {lo}..{hi}): a rank drew from its RandomState "
            "what the others did not")


def mesh_size(n: int, device) -> int:
    """The ranks of the CLIs' ``mesh=N`` (the JAX package's rule): 0 means
    every visible card, N is clamped to the card count, 1 opts out. Where
    the caller names one device (``cuda:0``, ``cpu``) the ranks share it:
    N ranks as asked, and 0 means 1."""
    dev = torch_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return n if n > 0 else 1
    count = torch.cuda.device_count()
    return min(n if n > 0 else count, count)


@contextlib.contextmanager
def quiet_unless_main(mesh: Optional[Mesh]):
    """Standard output of ranks other than 0 goes nowhere: the ranks run the
    same program, and rank 0 speaks for them."""
    if mesh is None or mesh.main:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def _rank_main(rank: int, n: int, fn, args: tuple, device: str,
               tmp: str, build_dir: str) -> None:
    from clstm_tpu_torch.ops import _build
    _build.BUILD_DIR = Path(build_dir)   # the library launch() built
    if torch.device(device).type == "cpu" and "OMP_NUM_THREADS" not in \
            os.environ:
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mesh = make_mesh(n, device, rank=rank,
                     init_method="file://" + os.path.join(tmp, "store"))
    try:
        with quiet_unless_main(mesh):
            rc = fn(*args, mesh=mesh)
    finally:
        sys.stdout.flush()
        dist.destroy_process_group()
    if mesh.main:
        with open(os.path.join(tmp, "rc"), "w") as f:
            f.write(str(int(rc or 0)))


def launch(fn, n: int, args: tuple, device) -> int:
    """Run ``fn(*args, mesh=Mesh)`` on ``n`` ranks started here with
    torch.multiprocessing's ``spawn``, on ``device`` as make_mesh resolves
    it. ``fn`` must be importable by name (the ranks start from a fresh
    interpreter). The CUDA kernels and the native I/O library are built
    first, so the ranks load them instead of racing to compile them; the
    ranks take this process's kernel build directory (enable_compile_cache).
    On
    the CPU each rank takes cpu_count // n intra-op threads, unless
    OMP_NUM_THREADS sets them. A failure on any rank stops the others and
    raises here. -> rank 0's return value (0 for None)."""
    from clstm_tpu_torch.io import native
    from clstm_tpu_torch.ops import _build
    if torch_device(device).type == "cuda":
        _build.build()
    native.build()
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n, fn, args, str(device), tmp,
                              str(_build.BUILD_DIR)), nprocs=n,
            join=True, start_method="spawn")
        with open(os.path.join(tmp, "rc")) as f:
            return int(f.read())


def run_ranks(fn, args: tuple, mesh_n: int, device) -> int:
    """The CLIs' entry to data parallelism: ``fn(*args, mesh=...)`` on the
    ranks ``mesh=N`` asks for. Under a launcher that set WORLD_SIZE (such as
    torchrun) this process is one of its ranks, and ``mesh`` must be 0 or
    WORLD_SIZE; otherwise N = mesh_size(mesh_n, device) ranks are started
    here when N > 1, and one process runs with mesh None when N is 1.
    -> rank 0's exit code."""
    if "WORLD_SIZE" in os.environ:
        size = int(os.environ["WORLD_SIZE"])
        if mesh_n not in (0, size):
            raise ValueError(f"mesh={mesh_n} under a launcher of {size} "
                             "ranks: use mesh=0 or mesh=WORLD_SIZE")
        if size == 1:
            return fn(*args, mesh=None)
        mesh = make_mesh(size, device)
        try:
            with quiet_unless_main(mesh):
                return fn(*args, mesh=mesh)
        finally:
            dist.destroy_process_group()
    n = mesh_size(mesh_n, device)
    if n == 1:
        return fn(*args, mesh=None)
    return launch(fn, n, args, device)
