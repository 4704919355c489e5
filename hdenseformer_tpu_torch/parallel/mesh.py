"""Data parallel over ``torch.distributed``: the port's counterpart of
``hdenseformer_tpu/parallel/mesh.py``.

JAX drives its n devices from one process through one ``Mesh``: the batch
is sharded over the ``data`` axis, the parameters replicated, and XLA
inserts the collectives. Torch runs one process per card, started by
``torchrun`` (or by the JAX package's launch contract, which
``maybe_distributed_init`` also reads); each process holds the replicated
model on its own card and a contiguous share of every global batch. A
``Mesh`` here is that process's view of the default process group: its
rank, the world size and its device.

JAX's semantics are kept: one sharded step equals one step of one process
on the global batch. Entering a mesh (``with mesh:``) makes every reduction
over the batch axis global while the block runs:

- the weighted losses' sums and ``topk``'s per-voxel vector
  (``losses/losses.py``), in-step dice and the confusion matrix
  (``metrics/``), and BatchNorm's training statistics
  (``models/layers.py``), through ``global_sum`` and ``global_cat``;
- every random draw of a training forward and of the on-card augmentation
  (``sharded_draw``): a rank draws the global batch's values from the same
  generator state and keeps its own rows, so its masks are the ones one
  process would draw for its samples;
- the train step averages the gradients over the ranks
  (``all_reduce_gradients``).

Gradients: the loss is the same global value on every rank, and the
collectives' backward all-reduces the incoming gradient (the semantics of
``torch.distributed.nn.functional.all_reduce``), so each rank's gradient is
the world size times its share of the global gradient; their mean is the
global gradient. The collectives take CUDA tensors under NCCL and under
gloo (which has no CUDA all-gather: ``global_cat`` is an all-reduce of a
zero-padded buffer).

Outside a mesh, or with one process, every helper is the identity and the
port computes exactly what it computes without this module. A mesh made
with ``always_reduce`` runs the collectives at world size 1 too (each one
the identity): how one card exercises a data-parallel step's collectives.

On a card the data-parallel steps and ``predict_volume(mesh=...)`` are
captured as CUDA graphs with their collectives inside, JAX's one SPMD
program a step (``utils/graphs.py``). NCCL's collectives capture; gloo's
run through the host and cannot, so a capture under gloo on a card raises
(``check_capturable``): the caller passes ``capture=False``.
"""
from __future__ import annotations

import contextvars
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("hdf_mesh", default=None)


class Mesh:
    """One process's view of the data-parallel world (the default process
    group): ``rank``, ``world_size`` and ``device``. ``with mesh:`` makes the
    batch reductions of the block global (module docstring)."""

    def __init__(self, rank: int, world_size: int, device: torch.device,
                 always_reduce: bool = False):
        self.rank, self.world_size = rank, world_size
        self.device = torch.device(device)
        self.always_reduce = always_reduce
        self._tokens: List[contextvars.Token] = []

    @property
    def reduces(self) -> bool:
        """Whether the block's reductions run the collectives: with more
        than one rank, or with ``always_reduce``."""
        return self.world_size > 1 or self.always_reduce

    def __enter__(self) -> "Mesh":
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._tokens.pop())

    @property
    def group(self):
        """The process group (the default one; None without a world)."""
        return dist.group.WORLD if dist.is_initialized() else None

    def __repr__(self) -> str:
        return f"Mesh(rank={self.rank}, world_size={self.world_size}, device={self.device})"

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier()


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``with mesh:`` block where it reduces (more
    than one rank, or ``always_reduce``), else None."""
    mesh = _ACTIVE.get()
    return mesh if mesh is not None and mesh.reduces else None


def check_capturable(mesh: Optional[Mesh]) -> None:
    """Raise where a CUDA graph would hold collectives it cannot capture: a
    reducing ``mesh`` on a card whose backend is not NCCL (gloo's
    collectives run through the host)."""
    if mesh is None or not mesh.reduces or mesh.device.type != "cuda":
        return
    backend = dist.get_backend() if dist.is_initialized() else None
    if backend != "nccl":
        raise RuntimeError(
            f"a CUDA graph cannot capture the {backend} backend's collectives (they run "
            "through the host): pass capture=False, or use NCCL on the card")


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(1, torch.cuda.device_count())


def maybe_distributed_init(device=None, backend: Optional[str] = None) -> bool:
    """Initialise ``torch.distributed`` when the process was launched as one
    of several; returns whether a process group exists.

    Two launch contracts: torchrun's (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and the JAX
    package's (``JAX_COORDINATOR_ADDRESS`` as host:port,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``; torch cannot detect a cluster
    as JAX does, so both counts are required). Without either, nothing
    happens. The backend is ``backend``, else NCCL for a CUDA ``device``
    (None is the card) and gloo for the CPU; under NCCL the process's
    current card is set to ``cuda:LOCAL_RANK`` first.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        init = dict(init_method="env://")
    elif env.get("JAX_COORDINATOR_ADDRESS"):
        if not (env.get("JAX_NUM_PROCESSES") and env.get("JAX_PROCESS_ID")):
            raise ValueError("JAX_COORDINATOR_ADDRESS needs JAX_NUM_PROCESSES and "
                             "JAX_PROCESS_ID: torch does not detect a cluster")
        init = dict(init_method=f"tcp://{env['JAX_COORDINATOR_ADDRESS']}",
                    world_size=int(env["JAX_NUM_PROCESSES"]), rank=int(env["JAX_PROCESS_ID"]))
    else:
        return False
    if backend is None:
        backend = "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(_local_rank() if "LOCAL_RANK" in env
                              else init.get("rank", 0) % max(1, torch.cuda.device_count()))
    dist.init_process_group(backend=backend, **init)
    return True


def _no_card() -> RuntimeError:
    return RuntimeError("no CUDA device: the port runs on the GPU unless the caller "
                        "passes device='cpu'")


def local_device(device=None) -> torch.device:
    """This process's device: ``device`` as given, except that a CUDA device
    without an index (None is one) is ``cuda:LOCAL_RANK``. None raises
    without a card: ``device="cpu"`` asks for the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise _no_card()
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _local_rank())
    return device


def local_mesh_devices(n: Optional[int] = None) -> list:
    """This host's cards (``cuda:0`` ...), the first ``n``; raises without
    a card."""
    if not torch.cuda.is_available():
        raise _no_card()
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n is not None:
        if n > len(devs):
            raise ValueError(f"requested {n} devices, have {len(devs)}")
        devs = devs[:n]
    return devs


def make_mesh(n_devices: Optional[int] = None, device=None,
              always_reduce: bool = False) -> Mesh:
    """The data-parallel mesh of this process over the default process
    group (one process of one rank where none is initialised).
    ``n_devices`` None takes the world as it is; any other value must be the
    world size. ``device`` is this rank's (``local_device``: None is the
    card, and raises without one; ``"cpu"`` is the host). ``always_reduce``
    runs the collectives at world size 1 too (``Mesh``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} processes, one a device "
            f"(torchrun --nproc-per-node {n_devices}), but the world has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(rank, world, local_device(device), always_reduce)


def shard_batch(mesh: Mesh, batch: Dict) -> Dict[str, torch.Tensor]:
    """This rank's contiguous share of a global host batch whose leading
    size is a multiple of the world size, on the mesh's device (through
    pinned memory without blocking on a card)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        n = v.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"{k}: a batch of {n} does not split over {mesh.world_size} ranks")
        share = n // mesh.world_size
        t = torch.from_numpy(np.ascontiguousarray(v[mesh.rank * share:(mesh.rank + 1) * share]))
        if mesh.device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(mesh.device, non_blocking=True)
    return out


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the active mesh (``x`` itself
    outside one), differentiable (module docstring)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if x.requires_grad:
        return _GlobalSum.apply(x)
    y = x.clone()
    dist.all_reduce(y)
    return y


def global_cat(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order (``x`` outside
    a mesh), differentiable; every rank's ``x`` has one shape."""
    mesh = active_mesh()
    if mesh is None:
        return x
    n = x.shape[0]
    buf = torch.zeros((mesh.world_size * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_copy(0, torch.arange(mesh.rank * n, (mesh.rank + 1) * n,
                                         device=x.device), x)
    return global_sum(buf)


def global_any(flag: torch.Tensor) -> torch.Tensor:
    """A bool tensor, true where it is true on any rank."""
    if active_mesh() is None:
        return flag
    return global_sum(flag.to(torch.int32)) > 0


def sharded_draw(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` of a random tensor whose dim 0 is this rank's share of
    the batch. Under a mesh it draws the global batch's ``(world * n, ...)``
    and returns this rank's rows: the values one process would draw for the
    same samples."""
    mesh = active_mesh()
    shape = tuple(shape)
    if mesh is None:
        return draw(shape)
    n = shape[0]
    full = draw((mesh.world_size * n,) + shape[1:])
    return full[mesh.rank * n:(mesh.rank + 1) * n]


def all_reduce_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> None:
    """Average the gradients of ``params`` over the mesh's ranks, in place,
    as one flat all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if not mesh.reduces or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.world_size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
