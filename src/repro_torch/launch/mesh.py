"""The vocab-parallel mesh as a process group (the twin of
`repro/launch/mesh.py`).

The reference's mesh is one process driving several devices (`shard_map`
over a ``("model",)`` axis).  PyTorch's idiom is one process per rank:
every rank runs the same program on the same batches, holds the
replicated parameters whole and only its own block of the vocab-sharded
table, and the collectives of `pm.collectives.MeshBackend` move rows
between the blocks.  A rank's device is its card, and the group is NCCL
there (one card per rank: NCCL refuses two ranks on one card); on the
CPU the group is gloo.  Nothing falls back from one to the other.

`make_model_mesh` wraps the default process group of a program that has
already started it; `init_group` starts it for one rank, and `run_ranks`
starts ``n`` ranks of a function in fresh processes (the tests, and any
launcher) and returns what each rank returned.

`make_production_mesh` is the reference's production mesh, (16, 16) over
``("data", "model")`` or (2, 16, 16) over ``("pod", "data", "model")``,
as a `DeviceMesh` over a ``"fake"`` process group of 256 or 512 ranks in
this one process: DTensor programs on it propagate shardings and issue
collectives that move nothing, which is what the dry run
(`launch.dryrun`) traces.  The sharding rules (`launch.sharding`) read
only a mesh's axis names and sizes, through `axis_size` and `batch_axes`,
from a `DeviceMesh`, a `ModelGroup` or a plain `MeshShape`.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

#: seconds a rank waits in a collective or for the group to form before it
#: fails (a stuck rank then raises instead of hanging its caller)
GROUP_TIMEOUT_S = 120

# the tensor forms of all-gather and reduce-scatter: torch 2.13 renamed
# them (the old names warn there); older torch has only the old names
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclass(frozen=True, eq=False)
class ModelGroup:
    """One rank's view of the vocab-parallel mesh: the process group, this
    rank, the number of ranks and the rank's device."""

    group: Any
    rank: int
    size: int
    device: torch.device


def make_model_mesh(n_shards: int = 0) -> ModelGroup:
    """The vocab-parallel mesh over the default process group, which must
    be started (`init_group`, `run_ranks`) and hold exactly ``n_shards``
    ranks (0: whatever it holds)."""
    if not dist.is_initialized():
        raise RuntimeError("the mesh needs a started process group "
                           "(launch.mesh.init_group or run_ranks)")
    world = dist.get_world_size()
    n = n_shards or world
    if n != world:
        raise ValueError(f"mesh of {n} shards over a process group of "
                         f"{world} ranks")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return ModelGroup(dist.group.WORLD, dist.get_rank(), world, device)


def gather_ranks(x: torch.Tensor, mesh: ModelGroup) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on every rank), stacked in rank
    order: one all-gather, which every rank must enter."""
    out = x.new_empty((mesh.size * x.numel(),))
    _all_gather(out, x.contiguous().view(-1), group=mesh.group)
    return out.view((mesh.size,) + tuple(x.shape))


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices: what the sharding
    rules read (the reference's rules read only ``mesh.shape`` and
    ``mesh.axis_names``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a `DeviceMesh`, a `ModelGroup` (the one axis
    ``"model"``), a `MeshShape` or no mesh (None: no axis)."""
    if mesh is None:
        return {}
    if isinstance(mesh, ModelGroup):
        return {"model": mesh.size}
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: str = "model") -> int:
    """Ranks along mesh axis ``name`` (1 for an axis the mesh lacks, or
    no mesh)."""
    return mesh_axes(mesh).get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def make_production_mesh(multi_pod: bool = False):
    """The production mesh as a `DeviceMesh` over a ``"fake"`` process
    group in this process: (16, 16) over ``("data", "model")``, or
    ``multi_pod`` (2, 16, 16) over ``("pod", "data", "model")``.  Nothing
    is allocated and no collective moves data.

    A dry run is a process of its own, as the reference's is with its
    host-device flag: this starts the default process group (`fake_mesh`)
    and raises if the process already has a real one."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return fake_mesh((16, 16), ("data", "model"))


def make_host_mesh():
    """The degenerate 1 x 1 ``("data", "model")`` mesh for runs on one
    host device: a `DeviceMesh` over a one-rank ``"fake"`` process group
    (`fake_mesh`), where every placement is whole and nothing moves."""
    return fake_mesh((1, 1), ("data", "model"))


def fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A `DeviceMesh` of ``shape`` over ``names`` on a ``"fake"`` default
    process group of as many ranks, this process rank 0 (a fake group of
    another size is replaced; a real group raises)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a fake mesh needs a fake process group; "
                               "this process has a real "
                               f"{dist.get_backend()!r} one")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=world,
                                store=FakeStore())
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def init_group(rank: int, world_size: int, init_file: str, *,
               device, timeout_s: float = GROUP_TIMEOUT_S) -> ModelGroup:
    """Start this process's rank of the default process group through the
    file ``init_file`` (every rank names the same file; a file cannot
    collide between concurrent runs as a TCP port can): NCCL for a CUDA
    ``device`` (without an index: the current card), which becomes the
    current card, and gloo for the CPU.
    Returns the mesh over it."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(init_file)}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return make_model_mesh(world_size)


def _rank_main(rank: int, n: int, fn: Callable, args: tuple, tmp: str,
               dev_type: str, timeout_s: float) -> None:
    # this rank's standard error (and a traceback on a fatal signal) goes
    # to a file that `run_ranks` reports from if the rank fails
    log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
    os.dup2(log.fileno(), 2)
    faulthandler.enable(log)
    if dev_type == "cpu":
        # n ranks share the host's cores: one thread each
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank)
    init_group(rank, n, os.path.join(tmp, "init"), device=device,
               timeout_s=timeout_s)
    try:
        out = fn(*args)
        # no rank leaves the group (closing its connections) while a peer
        # may still be exchanging with it
        dist.barrier()
    except BaseException:
        # into this rank's log: the launcher reports every rank's, whichever
        # rank's failure it sees first
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _logs(tmp: str, n: int, tail: int = 4000) -> str:
    """The end of each rank's standard error."""
    out = []
    for r in range(n):
        path = os.path.join(tmp, f"rank{r}.log")
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                text = f.read()[-tail:]
            out.append(f"--- rank {r} stderr ---\n{text}")
    return "\n".join(out)


def run_ranks(fn: Callable, n: int, *args, device="cpu",
              timeout_s: float = GROUP_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` ranks, each a fresh (spawned) process in
    which the default process group is started (`init_group`), and
    return the ranks' results in rank order.  ``fn`` must be importable
    by name and its result picklable.  ``device="cuda"`` puts rank k on
    card k over NCCL; ``"cpu"`` runs gloo, one thread per rank.

    If a rank raises or dies, the others are stopped and the error is
    raised here with the end of each rank's standard error; if the ranks have not all finished after ``timeout_s`` seconds
    (which also bounds each collective's wait), all are stopped and
    `TimeoutError` is raised."""
    dev_type = torch.device(device).type
    if dev_type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"{n} ranks need {n} cards (NCCL takes one card "
                         f"per rank); {torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(n, fn, args, tmp, dev_type, timeout_s),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks of {fn.__name__} did "
                                       f"not finish in {timeout_s} s")
        except ProcessException as e:
            raise RuntimeError(f"{e}\n{_logs(tmp, n)}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
