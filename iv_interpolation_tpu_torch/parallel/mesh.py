"""Device mesh over ``torch.distributed`` ranks (port of
``iv_interpolation_tpu/parallel/mesh.py``).

The JAX package shards a batch over a ``jax.sharding.Mesh`` inside one
program and XLA splits the work across the devices. PyTorch runs one
process per device instead (a rank), so the port's mesh is SPMD over
ranks: every rank runs the same code, owns one device and computes its
block of each batch's rows (its chunk of a timeline); the rows go back
to the caller by :func:`gather_rows`, the counterpart of the JAX
controller reading a sharded array back.

The world: ``torchrun`` or ``python -m torch.distributed.run`` launches
the ranks, and :func:`init_world` initialises the default group from
their environment (``env://``) the first time a mesh is asked for. A
rank's device is ``cuda:{LOCAL_RANK % device_count}``, or the CPU when
the caller asks for it. The backend is ``nccl`` only when every local
rank has a card of its own, else ``gloo`` (CPU ranks, or ranks sharing a
card); the choice follows that rule alone and is logged. A failed
initialisation raises: nothing goes on as a single process.

Every group has a timeout (``IVTPU_DIST_TIMEOUT_S``, 300 s by default),
so a rank that stops answering fails the others instead of hanging them.
It bounds the longest wait at one collective: rank 0's store read while
the others wait for its broadcast, or the slowest rank's batch. A store
or batch slower than that needs a larger value; a launcher that wants a
hang to fail fast, as the tests' do, sets a smaller one.
Objects and flags travel on a gloo group of their own; tensors on the
mesh's axis groups, through host memory where the backend is gloo (gloo
gathers no CUDA tensors).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from iv_interpolation_tpu_torch.monitoring.logging import get_logger
# canonical definition lives in utils (shared with pipeline.ingest);
# re-exported here because every mesh consumer pads through this module
from iv_interpolation_tpu_torch.utils import pad_to_multiple  # noqa: F401

_log = get_logger("mesh")
#: the launcher's variables: a rank's own child processes must not
#: inherit them, or they would join (or wait for) the rank's world
WORLD_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "GROUP_RANK",
             "GROUP_WORLD_SIZE", "ROLE_NAME", "ROLE_RANK", "ROLE_WORLD_SIZE", "MASTER_ADDR",
             "MASTER_PORT", "IVTPU_DIST_INIT", "TORCHELASTIC_RUN_ID",
             "TORCHELASTIC_RESTART_COUNT", "TORCHELASTIC_MAX_RESTARTS",
             "TORCHELASTIC_USE_AGENT_STORE", "TORCHELASTIC_ERROR_FILE")
#: the world of this process: backend, device type, the control group
_WORLD: dict = {}
#: meshes by (shape, axis names): their groups are made once per world
_MESHES: Dict[tuple, "Mesh"] = {}
# gathers carry these dtypes as bytes (gloo has no bool, int16 or
# bfloat16 collectives; a gather is a copy, so the bits survive)
_BYTES = (torch.bool, torch.bfloat16, torch.float16, torch.int16)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def launched_world() -> int:
    """The world size this process belongs to: the initialised group's,
    else the launcher's ``WORLD_SIZE`` (1 without a launcher)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", 1)


def choose_backend(device, local_world: int) -> str:
    """``nccl`` when the ranks run on the card and every local rank has a
    card of its own; else ``gloo``. NCCL refuses two ranks on one card."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda`` becomes ``cuda:{LOCAL_RANK % count}``
    under a launched world; any other device is returned as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and launched_world() > 1:
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {_env_int('RANK', 0)} cannot reach a card")
        return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())
    return dev


def init_world(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: Optional[float] = None) -> str:
    """Initialise the default process group (once) and return its
    backend. ``init_method`` defaults to ``IVTPU_DIST_INIT`` (a file
    rendezvous, as ``parallel.dryrun.start_world`` gives its ranks), else
    ``env://``, the launcher's environment; a caller that launches nothing
    passes ``init_method``, ``world_size`` and ``rank``. Raises when the
    group cannot be made."""
    if init_method is None:
        init_method = os.environ.get("IVTPU_DIST_INIT", "env://")
    if dist.is_initialized():
        return _WORLD.get("backend") or dist.get_backend()
    size = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    me = rank if rank is not None else _env_int("RANK", 0)
    local_world = _env_int("LOCAL_WORLD_SIZE", size)
    dev = torch.device(device)
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {me} cannot reach a card")
        torch.cuda.set_device(_env_int("LOCAL_RANK", me) % torch.cuda.device_count())
    timeout = datetime.timedelta(seconds=timeout_s if timeout_s is not None
                                 else float(os.environ.get("IVTPU_DIST_TIMEOUT_S", 300)))
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=me,
                            timeout=timeout)
    _WORLD.update(backend=backend, device_type=dev.type, timeout=timeout)
    _log.info("world: rank %d of %d, backend %s (%s ranks, %d local, %d cards)", me, size,
              backend, dev.type, local_world,
              torch.cuda.device_count() if dev.type == "cuda" else 0)
    return backend


def shutdown_world() -> None:
    """Destroy the default group and forget the meshes built on it."""
    _MESHES.clear()
    _WORLD.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_info() -> dict:
    """The world as a run's JSON reports it."""
    if not (dist.is_available() and dist.is_initialized()):
        return {"size": 1, "rank": 0, "backend": None}
    return {"size": dist.get_world_size(), "rank": dist.get_rank(),
            "backend": _WORLD.get("backend") or dist.get_backend()}


def _ctrl_group():
    """The gloo group that carries objects and flags."""
    if "ctrl" not in _WORLD:
        backend = _WORLD.get("backend") or dist.get_backend()
        _WORLD["ctrl"] = (dist.group.WORLD if backend == "gloo"
                          else dist.new_group(backend="gloo", timeout=_WORLD.get("timeout")))
    return _WORLD["ctrl"]


class _Axis(NamedTuple):
    size: int
    index: int            # this rank's coordinate along the axis
    ranks: Tuple[int, ...]  # the global ranks of this rank's group, in order
    group: object          # None for a group of one in a larger world


class Mesh:
    """A mesh of ranks: ``shape`` (axis name -> size, as ``dict(mesh.shape)``
    reads in the JAX package), ``axis_names``, ``devices`` (the rank of each
    mesh position), this rank's ``device`` and its ``axes`` (size,
    coordinate, group)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.devices = np.arange(math.prod(self.shape.values())).reshape(tuple(self.shape.values()))
        self.size = int(self.devices.size)
        self.initialised = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.initialised else 0
        self.backend = world_info()["backend"]
        self.device = rank_device(device)
        coords = np.argwhere(self.devices == self.rank)[0]
        self.axes: Dict[str, _Axis] = {}
        for i, name in enumerate(self.axis_names):
            # one group per line of the mesh along axis i, made in the same
            # order on every rank (dist.new_group is collective)
            lines = np.moveaxis(self.devices, i, -1).reshape(-1, self.devices.shape[i])
            mine = None
            for line in lines:
                ranks = tuple(int(r) for r in line)
                group = None
                if self.initialised and len(ranks) == self.size:
                    # the whole world (at world 1 too: its collectives run)
                    group = dist.group.WORLD
                elif len(ranks) > 1:
                    group = dist.new_group(list(ranks), timeout=_WORLD.get("timeout"))
                if self.rank in ranks:
                    mine = _Axis(len(ranks), int(coords[i]), ranks, group)
            self.axes[name] = mine

    @property
    def is_leader(self) -> bool:
        """Rank 0: the one that reads and writes the store and prints."""
        return self.rank == 0

    def block(self, rows: int, axis: Optional[str] = None) -> Optional[Tuple[int, int]]:
        """(lo, hi) of this rank's contiguous block of ``rows`` rows along
        ``axis`` (default: the first), or None where the rows stay whole
        (fewer rows than ranks, or not a multiple of them)."""
        ax = self.axes[axis or self.axis_names[0]]
        if ax.size <= 1 or rows < ax.size or rows % ax.size:
            return None
        per = rows // ax.size
        return ax.index * per, (ax.index + 1) * per

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank}, device={self.device})"


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "slice"),
              device="cuda") -> Mesh:
    """A mesh over every rank of the launched world (initialised here
    when it is not yet). ``shape`` defaults to ``(world, 1, ...)``; a
    product other than the world size raises. Without a launcher the
    world is this process alone, so only a mesh of one rank is made."""
    if launched_world() > 1 and not dist.is_initialized():
        init_world(device)
    n = launched_world()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    key = (shape, tuple(axis_names), dist.is_initialized())
    if key not in _MESHES:
        _MESHES[key] = Mesh(shape, axis_names, device)
    mesh = _MESHES[key]
    mesh.device = rank_device(device)
    return mesh


def pipeline_mesh(mesh_shape: Optional[Sequence[int]],
                  axis_names: Sequence[str] = ("data",),
                  device="cuda") -> Optional[Mesh]:
    """The pipeline's mesh from the config knobs
    (``processing.mesh_shape`` / ``mesh_axis_names``), or None when
    sharding would be a no-op.

    ``None`` sizes the mesh to the launched world and is None at world 1;
    a shape whose product is 1 gives None. A product larger than the
    world raises ("needs N ranks; M launched"), and so does a smaller one
    in a world of several ranks: every launched rank takes part (the JAX
    package refuses a partial mesh across processes the same way). Axis
    names are extended with generated ones, or cut, to the shape's rank."""
    n = launched_world()
    if mesh_shape is None:
        if n == 1:
            return None
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in mesh_shape)
    need = math.prod(shape)
    if need <= 1:
        return None
    if need > n:
        raise ValueError(f"processing.mesh_shape={shape} needs {need} ranks; {n} launched "
                         f"(start the ranks with torchrun or python -m "
                         f"torch.distributed.run --nproc-per-node {need})")
    if need != n:
        raise ValueError(f"processing.mesh_shape={shape} covers {need} of {n} launched "
                         f"ranks; a mesh takes every rank of the world")
    names = tuple(axis_names)[:len(shape)]
    names = names + tuple(f"ax{i}" for i in range(len(names), len(shape)))
    return make_mesh(shape, names, device=device)


def _take(a, lo: int, hi: int, axis: int = 0):
    index = [slice(None)] * a.ndim
    index[axis] = slice(lo, hi)
    return a[tuple(index)]


def shard_rows(mesh: Optional[Mesh], *arrays, expect_dim0: Optional[int] = None):
    """This rank's contiguous block of dim 0 of each array (a tensor or a
    numpy array), along the mesh's first axis. An array passes through
    unchanged on any of: ``mesh is None``, a None array, a scalar, a dim
    0 smaller than the axis or not a multiple of it, or, when
    ``expect_dim0`` is given, a dim 0 other than it. One definition
    serves the runner, the surface task and the streaming session."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    out = []
    for a in arrays:
        nd = getattr(a, "ndim", 0)
        if a is not None and nd >= 1 and (expect_dim0 is None or a.shape[0] == expect_dim0):
            rows = mesh.block(a.shape[0])
            if rows is not None:
                a = _take(a, *rows)
        out.append(a)
    return out if len(out) > 1 else out[0]


def _shard_dim(mesh: Mesh, a, dim: int, mesh_axis: str):
    rows = mesh.block(a.shape[dim], mesh_axis)
    if rows is None and mesh.shape[mesh_axis] > 1:
        raise ValueError(f"dim {dim} of {tuple(a.shape)} does not split over "
                         f"{mesh_axis}={mesh.shape[mesh_axis]}")
    return a if rows is None else _take(a, *rows, axis=dim)


def shard_batch(mesh: Mesh, *arrays, axis: int = 0):
    """This rank's block of each array's ``axis`` dim over the mesh's
    ``data`` axis (which must exist and divide the dim)."""
    out = [_shard_dim(mesh, a, axis, "data") for a in arrays]
    return out if len(out) > 1 else out[0]


def surface_batch_sharding(mesh: Mesh, shard_expiries: bool = False):
    """The placement of (B, E, ...) surface batches: a function that takes
    this rank's block of B over ``data`` and, when ``shard_expiries``, of
    E over ``slice``."""

    def place(a):
        a = _shard_dim(mesh, a, 0, "data")
        return _shard_dim(mesh, a, 1, "slice") if shard_expiries else a

    return place


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def _to_wire(mesh: Mesh, t: torch.Tensor, reduce: bool = False) -> torch.Tensor:
    """The tensor a collective carries: on the host where the backend is
    gloo (the one place the port routes card tensors through host memory),
    contiguous; for a gather the dtypes gloo lacks as their bytes, for a
    reduction as float32 (int64 for bool)."""
    x = t.detach()
    if mesh.backend == "gloo" and x.device.type != "cpu":
        x = x.cpu()
    x = x.contiguous()
    if x.dtype in _BYTES:
        if reduce:
            return x.to(torch.int64 if x.dtype == torch.bool else torch.float32)
        return x.view(torch.uint8)
    return x


def _from_wire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if x.dtype != like.dtype:
        x = x.view(like.dtype) if x.dtype == torch.uint8 else x.to(like.dtype)
    return x.to(like.device)


def _axes(mesh: Mesh, axis) -> Tuple[str, ...]:
    if axis is None:
        return (mesh.axis_names[0],)
    return (axis,) if isinstance(axis, str) else tuple(axis)


def all_gather(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = None,
               dim: int = 0) -> torch.Tensor:
    """Every member's ``t`` along ``axis`` (default: the first),
    concatenated along ``dim`` in the members' mesh order."""
    ax = mesh.axes[_axes(mesh, axis)[0]]
    if ax.group is None:
        return t
    x = _to_wire(mesh, t)
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return _from_wire(torch.cat(parts, dim=dim), t)


def psum(mesh: Mesh, t: torch.Tensor, axis=None) -> torch.Tensor:
    """Sum of ``t`` over the members of each named axis in turn (a tuple
    of names sums over all of them)."""
    for name in _axes(mesh, axis):
        ax = mesh.axes[name]
        if ax.group is None:
            continue
        x = _to_wire(mesh, t, reduce=True).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ax.group)
        t = _from_wire(x, t)
    return t


def _gather_tensor(mesh: Mesh, t: torch.Tensor, dst: Optional[int]):
    ax = mesh.axes[mesh.axis_names[0]]
    x = _to_wire(mesh, t)
    if dst is None:
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x, group=ax.group)
        return _from_wire(torch.cat(parts), t)
    root = ax.ranks[dst]
    parts = [torch.empty_like(x) for _ in range(ax.size)] if mesh.rank == root else None
    dist.gather(x, parts, dst=root, group=ax.group)
    return _from_wire(torch.cat(parts), t) if parts is not None else None


def _gather_tree(mesh: Mesh, x, dst: Optional[int]):
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.Tensor):
        return _gather_tensor(mesh, x, dst) if x.ndim else x
    if isinstance(x, np.ndarray):
        out = _gather_tensor(mesh, torch.from_numpy(np.ascontiguousarray(x)), dst)
        return None if out is None else out.numpy()
    if isinstance(x, dict):
        return {k: _gather_tree(mesh, v, dst) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_gather_tree(mesh, v, dst) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_gather_tree(mesh, v, dst) for v in x)
    return x


def gather_rows(mesh: Optional[Mesh], *trees, rows: Optional[int] = None,
                dst: Optional[int] = None):
    """The whole rows of each block, in rank order: the inverse of
    :func:`shard_rows` along the mesh's first axis. Each argument is a
    tensor, a numpy array or a dict / tuple / NamedTuple of them (scalars
    and None pass through). ``rows`` is the batch's whole dim 0: where
    :func:`shard_rows` left it whole, nothing is gathered. ``dst=None``
    gives every rank the rows; ``dst=0`` gives them to the axis's first
    member alone and None to the others."""
    if mesh is None or mesh.axes[mesh.axis_names[0]].group is None \
            or (rows is not None and mesh.block(rows) is None):
        return trees if len(trees) > 1 else trees[0]
    out = tuple(_gather_tree(mesh, t, dst) for t in trees)
    return out if len(out) > 1 else out[0]


def broadcast_object(mesh: Optional[Mesh], obj=None, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (pickled, on the control
    group)."""
    if mesh is None or not mesh.initialised or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_ctrl_group())
    return box[0]


def gather_objects(mesh: Optional[Mesh], obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    if mesh is None or not mesh.initialised or mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=_ctrl_group())
    return out


def any_rank(mesh: Optional[Mesh], flag: bool) -> bool:
    """Whether ``flag`` holds on any rank."""
    if mesh is None or not mesh.initialised or mesh.size == 1:
        return bool(flag)
    x = torch.tensor([int(bool(flag))])
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_ctrl_group())
    return bool(x.item())


def from_leader(mesh: Optional[Mesh], fn):
    """``fn()`` run on rank 0 alone, its value on every rank; its
    exception is raised on every rank. Without a mesh, ``fn()``."""
    if mesh is None or not mesh.initialised or mesh.size == 1:
        return fn()
    box = None
    if mesh.is_leader:
        try:
            box = (True, fn())
        except Exception as e:  # noqa: BLE001 — re-raised on every rank
            box = (False, e)
    ok, value = broadcast_object(mesh, box)
    if not ok:
        raise value
    return value


def worst_code(code: int) -> int:
    """The largest of every rank's ``code`` (an exit code), on every rank
    of the initialised world."""
    if not (dist.is_available() and dist.is_initialized()):
        return code
    x = torch.tensor([int(code)])
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_ctrl_group())
    return int(x.item())


class RankError(RuntimeError):
    """A rank of the mesh failed; raised on every rank, so all of them
    take the same branch."""


def agree(mesh: Optional[Mesh], err: Optional[BaseException]) -> None:
    """Share each rank's error before a gather: raise :class:`RankError`
    on every rank when any rank had one (the message names the first
    failing rank), return when none had."""
    if mesh is None or not mesh.initialised or mesh.size == 1:
        if err is not None:
            raise err
        return
    mine = None
    if err is not None:
        mine = str(err) if isinstance(err, RankError) else \
            f"rank {mesh.rank}: {type(err).__name__}: {err}"
    failed = [m for m in gather_objects(mesh, mine) if m is not None]
    if failed:
        raise RankError(failed[0]) from err


def collect(mesh: Optional[Mesh], fn, rows: int):
    """The mesh rule for one batch of ``rows`` rows: ``fn()`` computes this
    rank's block (a tree of tensors, as :func:`gather_rows` takes); under a
    mesh the rank waits for its device work, so a device error surfaces
    here, the ranks share their errors (:func:`agree` raises on every rank
    when any failed), and rank 0 gathers the whole rows. Returns them on
    rank 0 and None on the other ranks; without a mesh, ``fn()``."""
    out, err = None, None
    try:
        out = fn()
        if mesh is not None and mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
    except Exception as e:  # noqa: BLE001 — shared before the gather
        err = e
    agree(mesh, err)
    out = gather_rows(mesh, out, rows=rows, dst=0)
    return out if mesh is None or mesh.is_leader else None


# ----------------------------------------------------------------------
# the store as every rank sees it
# ----------------------------------------------------------------------
class RankStore:
    """A store under a mesh: rank 0 reads and writes the real store; each
    read's result (or its exception) is broadcast, so every rank packs
    the same batches whatever the backend (a memory store lives in one
    process); the other ranks' writes are dropped. Every rank must make
    the same reads in the same order, which SPMD code does."""

    _READS = ("read", "list_symbols", "count", "tables")

    def __init__(self, store, mesh: Mesh):
        self.store = store if mesh.is_leader else None
        self.mesh = mesh

    def _broadcast(self, name: str, *args, **kwargs):
        return from_leader(self.mesh, lambda: getattr(self.store, name)(*args, **kwargs))

    def __getattr__(self, name):
        if name in self._READS:
            return lambda *a, **kw: self._broadcast(name, *a, **kw)
        if self.mesh.is_leader:
            return getattr(self.store, name)
        raise AttributeError(f"rank {self.mesh.rank} holds no store ({name!r})")

    def write(self, table: str, df, **kwargs) -> int:
        if self.mesh.is_leader:
            return self.store.write(table, df, **kwargs)
        return len(df)


def rank_store(store, mesh: Optional[Mesh]):
    """``store`` as every rank of ``mesh`` sees it (itself without one)."""
    if mesh is None or isinstance(store, RankStore):
        return store
    return RankStore(store, mesh)
