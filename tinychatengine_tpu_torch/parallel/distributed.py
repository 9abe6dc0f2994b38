"""Process groups, the rank launcher and the mesh-axis handle
(counterpart of the JAX package's ``parallel/distributed.py``).

JAX drives every device from one process through ``shard_map``; the port
runs one process per rank (SPMD) over ``torch.distributed``:

    from tinychatengine_tpu_torch.parallel import distributed
    distributed.initialize("tcp://localhost:29500", num_processes=2,
                           process_id=rank)
    mesh = distributed.make_multihost_mesh(n_model=2)

or lets ``launch`` spawn the ranks and collect what each returns:

    results = distributed.launch(fn, world=2)   # fn(rank, world) per rank

The collectives run on gloo, which takes host tensors: a tensor on the
card goes through a pinned host buffer and back (``Axis``), so the card
and the CPU tests reduce bf16 partials on the same code path. gloo calls
are host calls, so a forward that makes them cannot be captured in a CUDA
graph (``tp.TPForward.capturable``).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tinychatengine_tpu_torch.core.device import resolve_device

# calls per collective since ``reset_stats``, under the names of the XLA
# ops that JAX's lowered programs hold, and the host seconds inside them
STATS = {"all_reduce": 0, "all_gather": 0, "collective_permute": 0,
         "all_to_all": 0, "broadcast": 0, "seconds": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k == "seconds" else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """``torch.distributed.init_process_group``; a no-op when a group
    already exists. coordinator_address: an init method
    (``tcp://localhost:29500``, ``file:///path``). Without one the group
    comes from the environment (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``) when it is set, and otherwise this is a
    single-process run with no group. An explicit set-up that fails
    raises: it never degrades silently to a single process."""
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
        return
    if all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
        dist.init_process_group(backend, init_method="env://")


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_info() -> dict:
    """Ranks are the port's devices: one process drives one device."""
    return {"process_index": rank(), "process_count": world_size(),
            "local_devices": 1, "global_devices": world_size()}


# -- the launcher ---------------------------------------------------------

def _rank_main(local_rank: int, fn, world: int, init_file: str,
               out_dir: str, args: tuple, cuda: bool) -> None:
    # one intra-op thread: ranks on one host would otherwise each start
    # one per core and contend (20-50x slower on the CPU)
    torch.set_num_threads(1)
    if cuda:  # rank r drives card r % cards
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    initialize(f"file://{init_file}", world, local_rank)
    try:
        out = fn(local_rank, world, *args)
        with open(os.path.join(out_dir, f"rank{local_rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # the parent reads this; the exception also ends the process
        Path(out_dir, f"rank{local_rank}.err").write_text(
            traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: Sequence = (), device=None):
    """Run ``fn(rank, world, *args)`` in ``world`` processes started with
    the ``spawn`` method, each with one torch intra-op thread, joined in
    one gloo group through a file store of their own (a fresh temporary
    directory, so launches in parallel never share one). ``fn`` must be
    importable by name (a module-level function) and its return value
    picklable. Returns each rank's result in rank order; a rank that
    raises fails the launch with its traceback. device: the ranks' kind
    of device, the card (``None``, raising without one; rank r drives
    card r % cards, so ranks may share one) or ``"cpu"``."""
    cuda = resolve_device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="tce_ranks_") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, os.path.join(tmp, "store"), tmp,
                              tuple(args), cuda),
            nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except Exception as exc:
            errs = sorted(Path(tmp).glob("rank*.err"))
            detail = "\n".join(p.read_text() for p in errs)
            raise RuntimeError(f"a rank failed:\n{detail or exc}") from exc
        out = []
        for r in range(world):
            with open(Path(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# -- mesh axes --------------------------------------------------------------

_GROUPS: dict[tuple, object] = {}


def group(ranks: Sequence[int]):
    """The process group of ``ranks``, made once. As with
    ``torch.distributed.new_group``, every rank of the world makes every
    group, in the same order; a rank outside it gets a non-member
    handle."""
    key = tuple(int(r) for r in ranks)
    g = _GROUPS.get(key)
    if g is None:
        g = dist.new_group(list(key))
        _GROUPS[key] = g
    return g


@contextlib.contextmanager
def _timed():
    t = time.perf_counter()
    try:
        yield
    finally:
        STATS["seconds"] += time.perf_counter() - t


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A host tensor gloo can take: a card tensor copied into a pinned
    buffer (the copy waits for the card), a host tensor made contiguous."""
    if x.is_cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf
    return x.contiguous().clone()


class Axis:
    """One mesh axis seen from this rank: ``size``, this rank's ``index``
    along it (JAX's ``axis_index``) and the collectives over the ranks that
    share every other mesh coordinate with it (JAX's ``psum``, tiled
    ``all_gather`` and ``ppermute`` over the axis name). A size-1 axis
    calls nothing."""

    def __init__(self, name: str, ranks: Sequence[int], index: int):
        self.name = name
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = _GROUPS.get(self.ranks)

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, ranks={self.ranks}, index={self.index})"

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis, returned in x's dtype on x's device. bf16 and
        f16 partials are summed in f32 and rounded once, as XLA's CPU
        all-reduce sums them: gloo's own bf16 sum rounds after every hop
        and at 4 ranks parts from XLA's in about a third of the elements
        (ROADMAP.md, Queue 3)."""
        if self.size == 1:
            return x
        STATS["all_reduce"] += 1
        with _timed():
            h = _to_host(x)
            if h.dtype in (torch.bfloat16, torch.float16):
                h = h.float()
            dist.all_reduce(h, group=self.group)
            return h.to(x.device, x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The axis' shards concatenated along ``dim`` in axis order (JAX's
        ``all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return x
        STATS["all_gather"] += 1
        with _timed():
            h = _to_host(x)
            parts = [torch.empty_like(h) for _ in range(self.size)]
            dist.all_gather(parts, h, group=self.group)
            return torch.cat(parts, dim=dim).to(x.device)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Each rank sends x to the rank ``shift`` places on along the axis
        (cyclically) and returns what the rank ``shift`` places before it
        sent (JAX's ``ppermute`` with pairs (i, i + shift))."""
        if self.size == 1:
            return x
        STATS["collective_permute"] += 1
        with _timed():
            h = _to_host(x)
            out = torch.empty_like(h)
            to = self.ranks[(self.index + shift) % self.size]
            frm = self.ranks[(self.index - shift) % self.size]
            ops = [dist.P2POp(dist.isend, h, to, group=self.group),
                   dist.P2POp(dist.irecv, out, frm, group=self.group)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return out.to(x.device)


class Mesh:
    """A grid of world ranks with named axes, row-major over ``shape``
    (JAX's ``Mesh`` over devices). Every rank of the world makes every
    mesh, in the same order (the SPMD host program), since each makes
    the process groups of the mesh and of each line along each axis.
    ``member``: whether this rank lies in it; a member has ``coords``
    (axis name -> index) and one ``Axis`` per name (``mesh[name]``).
    ``group`` spans the whole mesh."""

    def __init__(self, names: Sequence[str], shape: Sequence[int],
                 ranks: Optional[Sequence[int]] = None):
        self.axis_names = tuple(names)
        n = int(np.prod(shape))
        ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
        if len(ranks) != n:
            raise ValueError(f"{len(ranks)} ranks for a mesh of {n}")
        if n > world_size():
            raise ValueError(f"a mesh of {n} ranks in a world of "
                             f"{world_size()}")
        self.grid = np.asarray(ranks).reshape(tuple(shape))
        self.shape = dict(zip(self.axis_names, self.grid.shape))
        self.ranks = tuple(ranks)
        self.group = group(self.ranks) if n > 1 else None
        for ax in range(self.grid.ndim):  # each line along each axis
            lines = np.moveaxis(self.grid, ax, -1).reshape(
                -1, self.grid.shape[ax])
            for line in lines if lines.shape[1] > 1 else ():
                group(line.tolist())
        me = rank()
        self.member = me in self.ranks
        self.axes: dict[str, Axis] = {}
        self.coords: dict[str, int] = {}
        if not self.member:
            return
        where = tuple(int(i) for i in np.argwhere(self.grid == me)[0])
        self.coords = dict(zip(self.axis_names, where))
        for ax, name in enumerate(self.axis_names):
            line = list(where)
            line[ax] = slice(None)
            self.axes[name] = Axis(name, self.grid[tuple(line)].tolist(),
                                   where[ax])

    def __getitem__(self, name: str) -> Axis:
        return self.axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks})"

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """x from world rank ``src`` to every rank of the mesh, on x's
        device (the ranks that follow a host program whose forward runs on
        a sub-mesh; ``tp.make_tp_forward(followers=...)``)."""
        if len(self.ranks) == 1:
            return x
        STATS["broadcast"] += 1
        with _timed():
            h = _to_host(x)
            dist.broadcast(h, src=src, group=self.group)
            return h.to(x.device)


def make_multihost_mesh(n_model: Optional[int] = None,
                        ranks: Optional[Sequence[int]] = None) -> Mesh:
    """("data", "model") mesh over the world (or ``ranks``): the model
    axis over neighbouring ranks, which share a host, and the data axis
    across them. n_model defaults to the ranks on this host
    (``LOCAL_WORLD_SIZE``, else the world)."""
    ranks = list(range(world_size())) if ranks is None else list(ranks)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    n_model = n_model or local
    if len(ranks) % n_model:
        raise ValueError(f"{len(ranks)} ranks do not split into model "
                         f"groups of {n_model}")
    return Mesh(("data", "model"), (len(ranks) // n_model, n_model), ranks)
