"""The data-parallel mesh over processes: port of
``pingpong_tpu/parallel/mesh.py`` on ``torch.distributed``.

The JAX package spans devices with one logical mesh in one SPMD program
and lets XLA insert the collectives. The port runs one process per card:

* the mesh's ``data`` axis is the process group; rank ``r`` owns card
  ``cuda:LOCAL_RANK`` (``initialize_distributed`` selects it), or the CPU;
* the ``model`` axis is reserved and size 1 unless asked for, as in JAX;
  with ``num_model > 1`` the data axis of a process is the group of the
  ranks that share its model index;
* the env batch (and, in the sharded learner layout, the replay) splits
  into contiguous rank blocks along its leading axis (``shard_batch``);
  parameters and optimizer state are replicated: every rank computes the
  same values (``replicate`` broadcasts rank 0's where they could differ);
* collectives are explicit calls: ``all_gather_cat`` (rank order),
  ``all_reduce_`` (SUM or MAX) and ``broadcast_``, each inside a span of
  the program's tracer (``utils/trace.py``: ``mesh::all_gather``,
  ``mesh::all_reduce``, ``mesh::broadcast``) that lasts until the
  collective is done, so with tracing on a profile of an iteration reads
  the collectives' time. The backend follows the
  device: NCCL for CUDA tensors, gloo for CPU tensors (gloo also carries
  these three collectives for CUDA tensors, which lets several ranks share
  one card in a check).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pingpong_tpu_torch.config.schema import MeshConfig
from pingpong_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` x ``model`` mesh over the ranks, seen from one rank."""

    shape: Dict[str, int]
    data_axis: str = "data"
    model_axis: str = "model"
    rank: int = 0                  # this process's index on the data axis
    group: Any = None              # the data axis's group (None: the world)

    @property
    def n_data(self) -> int:
        return self.shape[self.data_axis]


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(cfg: Optional[MeshConfig] = None,
                world: Optional[int] = None) -> Mesh:
    """``num_data`` x ``num_model`` over the ``world`` ranks (the process
    group's size by default, 1 without one); ``num_data = -1`` takes every
    rank the model axis leaves. Raises when the mesh does not cover the
    ranks, as the JAX function does for devices."""
    cfg = cfg or MeshConfig()
    n_world, rank = _world()
    n = n_world if world is None else int(world)
    num_model = max(1, cfg.num_model)
    num_data = cfg.num_data if cfg.num_data > 0 else n // num_model
    if num_data * num_model != n:
        raise ValueError(
            f"mesh {num_data}x{num_model} does not cover {n} devices")
    group = None
    if num_model > 1 and n_world == n > 1:
        # every rank creates every group (new_group is collective)
        groups = [dist.new_group([d * num_model + m for d in range(num_data)])
                  for m in range(num_model)]
        group = groups[rank % num_model]
    return Mesh(shape={cfg.data_axis: num_data, cfg.model_axis: num_model},
                data_axis=cfg.data_axis, model_axis=cfg.model_axis,
                rank=rank // num_model if n_world == n else 0, group=group)


def data_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's contiguous block of a leading axis of ``n_rows``."""
    n = mesh.n_data
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over {n} data shards")
    per = n_rows // n
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(tree, mesh: Mesh, dim: int = 0):
    """Every tensor of a nest (NamedTuple, list, tuple or dict) cut to this
    rank's block along ``dim``, as contiguous copies."""
    def cut(x):
        sl = data_sharding(mesh, x.shape[dim])
        return x[(slice(None),) * dim + (sl,)].contiguous().clone()
    return _tree_map(cut, tree)


def replicate(tree, mesh: Mesh):
    """Every tensor of a nest set to data rank 0's values, in place."""
    return _tree_map(lambda x: broadcast_(x, mesh), tree)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _src(mesh: Mesh, data_rank: int) -> int:
    """The global rank of ``data_rank`` in this rank's data group."""
    if mesh.group is None:
        return data_rank
    return dist.get_global_rank(mesh.group, data_rank)


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    with trace.span("mesh::all_gather"):
        dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def all_reduce_(x: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """In-place SUM (or MAX) over the data axis; every rank gets the same
    bits."""
    with trace.span("mesh::all_reduce"):
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=mesh.group)
    return x


def broadcast_(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """In place: data rank ``src``'s ``x`` on every rank."""
    with trace.span("mesh::broadcast"):
        dist.broadcast(x, src=_src(mesh, src), group=mesh.group)
    return x


def broadcast_values(values: Sequence[float], mesh: Optional[Mesh],
                     device) -> List[float]:
    """Data rank 0's numbers on every rank (float64 on ``device``)."""
    if mesh is None or mesh.n_data == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    return trace.readback(broadcast_(t, mesh))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group (a no-op in a single process and when the
    group exists already). With the arguments None it reads torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
    ``LOCAL_RANK``); ``coordinator_address`` is ``host:port`` of rank 0.
    The backend follows the device: NCCL when a card is present (the rank's
    card ``cuda:LOCAL_RANK`` becomes its current device), gloo on the CPU;
    ``backend`` asks for another (gloo for several ranks on one card)."""
    if not dist.is_available() or dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "WORLD_SIZE" not in env:
        return
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)


def free_port() -> int:
    """A free TCP port on ``localhost`` for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def is_coordinator() -> bool:
    """True on the process that owns checkpoint, database, plot and log
    writes (rank 0); a single process is always the coordinator."""
    return _world()[1] == 0


def mesh_for_world(cfg: Optional[MeshConfig]) -> Optional[Mesh]:
    """The mesh of the loops and the CLI: one over the process group when
    it has more than one rank, else None (the single-device learner)."""
    if cfg is None or _world()[0] <= 1:
        return None
    return create_mesh(cfg)


class RankBlocks:
    """The data-parallel helpers of a learner bound to one rank of a mesh
    (``self.mesh``; None runs everything on the whole batch)."""

    mesh: Optional[Mesh] = None

    def _blk(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (a contiguous copy)."""
        return x if self.mesh is None else shard_batch(x, self.mesh, dim)

    def _cat(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's block of ``x`` in rank order (collective)."""
        if self.mesh is None:
            return x
        return all_gather_cat(x, self.mesh, dim)

    def _tiling(self, tile_rows: int, n_global: int, b_local: int):
        """``(tile, tile0, whole)`` of a rollout kernel's call on this rank:
        its block, ``tile0`` its first global tile; or, as the JAX learners
        do, the whole batch on every rank (``whole``) when the block does
        not split into whole tiles."""
        tile = min(tile_rows, b_local)
        if self.mesh is None:
            return tile, 0, False
        if b_local % tile:
            return min(tile_rows, n_global), 0, True
        return tile, self.mesh.rank * (b_local // tile), False

    def _sum_counts(self, counts: torch.Tensor, ret_sum) -> Tuple[list, float]:
        """The episode counts and return sum of the whole batch (one
        all-reduce under a mesh)."""
        v = torch.cat([counts.to(torch.float64).reshape(-1),
                       torch.as_tensor(ret_sum, dtype=torch.float64,
                                       device=counts.device).reshape(1)])
        if self.mesh is not None:
            all_reduce_(v, self.mesh)
        v = trace.readback(v)
        return [int(c) for c in v[:-1]], float(v[-1])

    def _reducer(self):
        """A step's done count summed over the ranks (None: no mesh)."""
        if self.mesh is None:
            return None
        return lambda x: all_reduce_(x, self.mesh)
