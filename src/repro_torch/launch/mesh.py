"""Meshes of ranks for tensor-parallel serving (torch twin of
``repro.launch.mesh``), and starting the ranks.

A JAX mesh lays devices out on named axes; here the devices are ranks of
an initialised ``torch.distributed`` process group, one process each.
`make_host_mesh` lays the group's ranks out as data x model (row-major)
and returns a `HostMesh`: its ``.shape`` is the mapping {"data": d,
"model": m} that ``serve.validate`` reads, and it carries this rank's
model-axis group, its coordinates and its device. `make_production_mesh`
is the shape of the production mesh alone (no devices), for the training
sharding rules.

`spawn(fn, n, *args)` starts n ranks (the ``spawn`` start method: fork is
unsafe once CUDA is initialised), joins them into one process group
through a ``FileStore`` and returns what ``fn(*args)`` returned on each
(`start` returns at once, and its `Ranks.join()` waits). A rank that
raises, dies or outlasts the timeout fails the call; the other ranks are
killed.

Backends: NCCL needs one card per rank; gloo runs anywhere, on the CPU or
with every rank sharing one card (its collectives then go through host
memory, ``distributed.collectives``). `rank_device` picks the device.
"""
from __future__ import annotations

import datetime
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.sharding import AbstractMesh


class HostMesh:
    """data x model ranks of the initialised process group, seen from one
    rank: `shape` {"data", "model"}; `rank` (global) and `coords` on each
    axis; `ranks`, the global ranks of this rank's model-axis row in
    model order; `group`, that row's process group (None when model is
    1), and `ctrl`, a gloo group over the same ranks for objects;
    `backend` and `device`."""

    def __init__(self, data: int, model: int, *, rank: int = 0,
                 ranks: tuple = (0,), group=None, ctrl=None,
                 backend: str = "gloo", device=None):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.coords = {"data": rank // model, "model": rank % model}
        self.ranks = tuple(ranks)
        self.group = group
        self.ctrl = ctrl
        self.backend = backend
        self.device = torch.device(device if device is not None else "cpu")

    @property
    def model_rank(self) -> int:
        return self.coords["model"]

    def __repr__(self) -> str:
        return (f"HostMesh(data={self.shape['data']}, "
                f"model={self.shape['model']}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single pod (256 chips) or 2x16x16 two pods (512 chips), as a
    shape without devices."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def rank_device(rank: int, backend: str) -> torch.device:
    """The device of a rank: cuda:<rank mod cards> under NCCL (one card
    per rank), cuda:0 under gloo when a card is present (every rank on the
    one card), else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cuda", 0)


def make_host_mesh(*, data: int | None = None, model: int = 1,
                   device=None) -> HostMesh:
    """A data x model mesh over the ranks of the initialised process group
    (one rank, without one). Validates the shape against the world size,
    so a bad --mesh-model fails with an actionable message. Every rank
    must call it (new process groups are made collectively). `device`
    defaults to `rank_device`."""
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if model < 1:
        raise ValueError(f"mesh model axis must be >= 1, got {model}")
    if data is None:
        data = max(n // model, 1)
    if data < 1:
        raise ValueError(f"mesh data axis must be >= 1, got {data}")
    if data * model > n:
        raise ValueError(
            f"mesh ({data} data x {model} model = {data * model} ranks) "
            f"exceeds the {n} visible rank(s) of the process group (world "
            f"size {n}); shrink the mesh, or start {data * model} ranks, "
            f"each calling torch.distributed.init_process_group with "
            f"world_size={data * model} (repro_torch.launch.mesh.spawn, "
            f"or `python -m repro_torch.launch.serve --mesh-model N`)")
    if n == 1:
        return HostMesh(data, model, device=device)
    rank = dist.get_rank()
    if rank >= data * model:
        raise ValueError(f"rank {rank} lies outside the {data} x {model} "
                         f"mesh of a world of {n}")
    backend = dist.get_backend()
    group = ctrl = None
    row = rank // model
    ranks = tuple(range(row * model, (row + 1) * model))
    if model > 1:
        for r in range(data):           # collective: every rank makes all
            members = list(range(r * model, (r + 1) * model))
            g = (dist.group.WORLD if data * model == n and data == 1
                 else dist.new_group(members))
            c = g if backend == "gloo" else dist.new_group(members,
                                                          backend="gloo")
            if r == row:
                group, ctrl = g, c
    return HostMesh(data, model, rank=rank, ranks=ranks, group=group,
                    ctrl=ctrl, backend=backend,
                    device=device if device is not None
                    else rank_device(rank, backend))


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def _rank_entry(rank: int, nprocs: int, store: str, backend: str,
                timeout: float, out_dir: str, fn, args) -> None:
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store, nprocs), rank=rank,
            world_size=nprocs,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


class Ranks:
    """Ranks started by `start`: `join()` waits for their results, `kill()`
    ends any still running."""

    def __init__(self, fn, nprocs: int, args: tuple, backend: str,
                 timeout: float, tmp_dir: str | None):
        self.name = getattr(fn, "__name__", str(fn))
        self.timeout = timeout
        self.work = tempfile.mkdtemp(prefix="repro_torch_ranks_",
                                     dir=tmp_dir)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
            r, nprocs, os.path.join(self.work, "store"), backend, timeout,
            self.work, fn, args)) for r in range(nprocs)]
        self.deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.kill()
            raise

    def join(self) -> list:
        """Each rank's result, by rank. Raises RuntimeError, with the
        traceback of every failed rank, when a rank fails, and TimeoutError
        past the deadline; either way every rank still running is killed
        first."""
        procs = self.procs
        try:
            while any(p.is_alive() for p in procs):
                if any(not p.is_alive() and p.exitcode != 0 for p in procs):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(
                        f"{len(procs)} ranks of {self.name} did not finish "
                        f"within {self.timeout:.0f} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs], timeout=0.2)
            self.kill()                 # the others wait on a failed rank
            failed = []
            for r, p in enumerate(procs):
                if p.exitcode != 0:
                    err = os.path.join(self.work, f"{r}.err")
                    text = (open(err).read() if os.path.exists(err)
                            else f"exit code {p.exitcode}\n")
                    failed.append(f"--- rank {r} ---\n{text}")
            if failed:
                raise RuntimeError("a rank failed:\n" + "".join(failed))
            out = []
            for r in range(len(procs)):
                with open(os.path.join(self.work, f"{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self.kill()
            shutil.rmtree(self.work, ignore_errors=True)

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            if p.pid is not None:
                p.join(timeout=10)


def start(fn, nprocs: int, *args, backend: str = "gloo",
          timeout: float = 600.0, tmp_dir: str | None = None) -> Ranks:
    """Start ``fn(*args)`` on `nprocs` new ranks of one process group (rank
    r is the r-th process; `fn` must be importable by name, and every
    argument and result picklable) and return at once. `timeout` bounds
    the whole run and each collective. The store and the results live in
    a fresh directory under `tmp_dir` (default: the system's), removed
    at `join()`."""
    return Ranks(fn, nprocs, args, backend, timeout, tmp_dir)


def spawn(fn, nprocs: int, *args, backend: str = "gloo",
          timeout: float = 600.0, tmp_dir: str | None = None) -> list:
    """`start` the ranks and `join` them: each rank's result, by rank."""
    return start(fn, nprocs, *args, backend=backend, timeout=timeout,
                 tmp_dir=tmp_dir).join()
