"""Process groups and the device mesh (port of ``moka_tpu/parallel/mesh.py``).

JAX puts every device in one ``Mesh`` and lets XLA insert the collectives
its sharding annotations imply.  The port runs one process a rank, started
by ``torchrun`` (or ``torch.multiprocessing``), names its collectives
(``parallel.comm``) and keeps the axes: ``make_mesh`` returns a
``torch.distributed`` ``DeviceMesh`` with dims ("data", "fsdp", "model").
A rank's device is ``cuda:LOCAL_RANK % device_count()``, or the CPU when
the caller asks for it; NCCL groups serve CUDA ranks and gloo groups CPU
ones.

Two groups of a rank carry the training step's collectives: its data
group (``data_parallel_group``: the ranks of its model coordinate over
data x fsdp, which split the batch and sum the gradients) and its model
group (``model_parallel_group``: the ranks that hold the other parts of
its layers' projections, ``parallel.tensor``).  The ranks of one model
group feed the same samples.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist

from moka_tpu_torch.core.config import MeshConfig
from moka_tpu_torch.core.device import resolve_device

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXES = (AXIS_DATA, AXIS_FSDP, AXIS_MODEL)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives: ``spec`` names a mesh axis (or a tuple of axes,
    or None) per dim, as JAX's ``PartitionSpec`` does, and ``memory_kind``
    is "device" or "pinned_host"."""
    spec: tuple = ()
    memory_kind: str = "device"


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def process_rank() -> int:
    """The ``torch.distributed`` rank when a group is initialized, else 0."""
    return dist.get_rank() if initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(device=None) -> None:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL when the ranks run on the card, gloo on the CPU.
    Without that environment, or with a group already started, it does
    nothing (one process)."""
    if initialized() or "RANK" not in os.environ or \
            "WORLD_SIZE" not in os.environ:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count()`` unless
    ``device`` names one (an index, or the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def make_mesh(cfg: MeshConfig | None = None):
    """A ("data", "fsdp", "model") ``DeviceMesh`` over every rank of the
    default group (``cfg`` None: all of them on fsdp, the ZeRO-3-style
    default).  Raises when the mesh's size is not the world size.  With
    data, fsdp and model all above 1 it also builds each model
    coordinate's data x fsdp group (every rank creates every one of them,
    in the same order, as ``dist.new_group`` requires) and keeps this
    rank's on the mesh for ``data_parallel_group``."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    if cfg is None:
        cfg = MeshConfig(data=1, fsdp=n, model=1)
    if cfg.num_devices != n:
        raise ValueError(f"mesh {cfg} wants {cfg.num_devices} devices, "
                         f"have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (cfg.data, cfg.fsdp, cfg.model),
                            mesh_dim_names=AXES)
    if min(cfg.data, cfg.fsdp, cfg.model) > 1:
        ranks = mesh.mesh.reshape(cfg.data * cfg.fsdp, cfg.model)
        me = mesh.get_local_rank(AXIS_MODEL)
        for m in range(cfg.model):
            group = dist.new_group(ranks[:, m].tolist())
            if m == me:
                mesh._moka_data_group = group
    return mesh


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of a ``DeviceMesh``, of a ``MeshConfig``
    (the rule functions take either), or 1 without a mesh."""
    if mesh is None:
        return 1
    if isinstance(mesh, MeshConfig):
        return getattr(mesh, name)
    if name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def data_parallel_group(mesh):
    """The group over which the batch is split: the data x fsdp ranks of
    this rank's model coordinate; the gradients and the loss are summed
    over it.  None without a mesh.  That is the group of the mesh's one
    split axis, or, with both above 1, the default group when the model
    axis is 1 (``make_mesh`` spans it) and the group ``make_mesh`` built
    for this model coordinate when it is not."""
    if mesh is None:
        return None
    split = [a for a in (AXIS_DATA, AXIS_FSDP) if axis_size(mesh, a) > 1]
    if len(split) < 2:
        return mesh.get_group(split[0] if split else AXIS_FSDP)
    group = getattr(mesh, "_moka_data_group", None)
    if group is not None:
        return group
    if axis_size(mesh, AXIS_MODEL) > 1 or mesh.size() != world_size():
        raise ValueError(f"a mesh split over data and fsdp needs its data "
                         f"group from make_mesh (model axis "
                         f"{axis_size(mesh, AXIS_MODEL)}, {mesh.size()} of "
                         f"{world_size()} ranks)")
    return dist.group.WORLD


def model_parallel_group(mesh):
    """The ranks that split this rank's projections (the mesh's ``model``
    sub-group of this rank); None without a mesh."""
    if mesh is None:
        return None
    return mesh.get_group(AXIS_MODEL)


def data_parallel_index(mesh) -> tuple[int, int]:
    """(this rank's index in the data x fsdp group, the group's size)."""
    group = data_parallel_group(mesh)
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def host_local_batch_size(global_batch: int, mesh) -> int:
    """Samples this process feeds a step.  The batch is split over the
    processes that feed distinct samples: the ranks of one model group
    feed the same ones, so a rank's share is the global batch over
    world / model (one process: all of it); a batch the data x fsdp size
    does not divide warns, as in JAX (the split is by process)."""
    world = max(world_size() // axis_size(mesh, AXIS_MODEL), 1)
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"host count {world}")
    n_data = axis_size(mesh, AXIS_DATA) * axis_size(mesh, AXIS_FSDP)
    if global_batch % n_data:
        warnings.warn(f"global batch {global_batch} not divisible by "
                      f"data-parallel size {n_data}; batch arrays cannot be "
                      f"evenly device-sharded (ok for replicated feeding)",
                      stacklevel=2)
    return global_batch // world


def batch_sharding(mesh) -> Placement:
    """The batch dim split over both data-parallel axes: each rank holds
    its own samples (``data_parallel_group``)."""
    return Placement(((AXIS_DATA, AXIS_FSDP),))


def replicated(mesh) -> Placement:
    return Placement(())


def free_port() -> int:
    """A free TCP port on localhost, for a world started on one host."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _world_entry(rank: int, fn, world: int, port: int, backend: str,
                 args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    fn(rank, *args)
    # only after success: an NCCL group whose peers wait in a collective
    # blocks its destroy until the watchdog's timeout, where a rank that
    # raised should exit at once (``wait_world`` then ends the others)
    dist.destroy_process_group()


def start_world(fn, world: int, args: tuple = (), backend: str = "gloo"):
    """Spawn ``world`` processes on this host, each in one default process
    group (``backend`` over ``tcp://localhost``), running ``fn(rank,
    *args)`` (a module-level function).  Returns the
    ``torch.multiprocessing`` context without waiting: ``join(timeout)``
    it until it returns True (it raises if a rank failed).  Ranks that
    share one GPU need gloo: NCCL refuses two ranks on a device."""
    import torch.multiprocessing as tmp
    return tmp.start_processes(
        _world_entry, args=(fn, world, free_port(), backend, tuple(args)),
        nprocs=world, join=False, start_method="spawn")


def run_world(fn, world: int, args: tuple = (), backend: str = "gloo",
              timeout: float = 600.0) -> None:
    """``start_world`` and wait for it, at most ``timeout`` seconds (then
    the ranks are killed and it raises)."""
    ctx = start_world(fn, world, args, backend)
    wait_world(ctx, timeout)


def wait_world(ctx, timeout: float = 600.0) -> None:
    import time
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            raise TimeoutError(f"the world did not finish in {timeout} s")
