"""Data-parallel training over processes, the 2-D (data x space) mesh of
processes and tile-parallel inference over local devices (counterpart of
``jspsr_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh and lets XLA insert
the collectives. The port follows PyTorch's layout instead:

- **Training: one process per GPU.** ``init_distributed(p)`` joins the
  process group that ``distributed: true`` (or ``JSPSR_DISTRIBUTED``)
  asks for, as the JAX CLI's ``jax.distributed.initialize`` does
  (``jspsr_tpu/cli/main.py:48-81``): ``distributed_kwargs``
  ``{coordinator_address, num_processes, process_id}`` give the address,
  world size and rank; without them torchrun's environment (``env://``)
  does. Each process trains on its own device with ``train_batch_size``
  rows (the JAX package's per-process batch), on the loader's shard
  ``rank::world``. The train step all-reduces its gradients
  (``all_reduce_grads``) and the model's BatchNorm takes its statistics
  over the global batch (``nn.layers.BatchNorm2d``), so a step over
  ``world`` processes is the step on their concatenated batch.
  ``replicate_state`` broadcasts rank 0's parameters, buffers and
  optimizer state.
- **Inference and eval: one process, several local devices.** A ``Mesh``
  is a list of local devices; ``Mesh.split_forward`` runs one slice of a
  batch on each with a replica of the model there and gathers the
  results. A list may name one device twice (a one-card host, the CPU).

- **The 2-D (data x space) spatially sharded forward: one process per
  block.** ``make_2d_mesh(n_data, n_space)`` lays the process group out as
  the JAX package's ``reshape(n_data, n_space)`` of its devices: rank r is
  at (r // n_space, r % n_space), with a data group per space index and a
  space group per data index. ``spatial_sharding(mesh2d)`` gives each rank
  its block of an NCHW batch (its rows of the batch, its slab of image
  rows: ``P("data", "space")`` on NHWC), gathers results back, and opens
  the context in which the layers that need a neighbour's rows exchange
  them (``parallel/spatial.py`` says which, and why processes).
"""

from __future__ import annotations

import contextlib
import copy
import os
import sys
import weakref
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# a collective (or the group's rendezvous) that waits longer than this
# fails instead of waiting for torch's default of 30 minutes
DIST_TIMEOUT_S = 600


def process_group():
    """The default process group where one is initialised, else None:
    what the train step, BatchNorm and drop path reduce over."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank_world(group=None) -> tuple[int, int]:
    """(rank, world size) of this process in ``group`` (default: the
    default group); (0, 1) without one."""
    group = group or process_group()
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


# the group of the data-parallel train step running now (``data_parallel``)
_STEP_GROUP = None


@contextlib.contextmanager
def data_parallel(group):
    """Within it, a train-mode forward is one rank's share of a step over
    ``group``: ``nn.layers.BatchNorm2d`` takes the global batch's
    statistics and PVT's drop path draws the global batch's masks.
    ``train.step.make_train_step`` enters it (with the default group, if
    one exists) around its forward and backward; any other forward stays
    per process, group or not. ``group`` None changes nothing. A module
    global, not a thread-local: the backward (and a ``remat`` recompute
    in it) may run on autograd's device threads."""
    global _STEP_GROUP
    prev, _STEP_GROUP = _STEP_GROUP, group
    try:
        yield
    finally:
        _STEP_GROUP = prev


def step_group():
    """The group of the data-parallel step running now, else None."""
    return _STEP_GROUP


# the spatial sharding whose context is open (``SpatialSharding.active``)
_SHARDING = None


def active_sharding():
    """The ``SpatialSharding`` whose context is open now, else None: what
    the layers of ``parallel/spatial.py``'s list read. A module global, as
    ``data_parallel``'s group, for autograd's device threads."""
    return _SHARDING


def local_rank(rank: int | None = None) -> int:
    """The index of this process's GPU on its host: torchrun's
    ``LOCAL_RANK``, else the rank (``rank``, the group's, or ``RANK``)
    modulo the host's GPU count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = (dist.get_rank() if process_group() is not None
                else int(os.environ.get("RANK", 0)))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(n, 1)


def init_distributed(p, device="cuda", backend: str | None = None,
                     timeout_s: float = DIST_TIMEOUT_S) -> int:
    """Join the process group ``p`` asks for (``distributed: true`` or the
    ``JSPSR_DISTRIBUTED`` environment variable); returns this process's
    rank (0 when not distributed). Call it before any device use.

    ``distributed_kwargs: {coordinator_address, num_processes,
    process_id}`` map to ``init_process_group(init_method=
    "tcp://<coordinator_address>", world_size=num_processes,
    rank=process_id)``; without them torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` are read (``env://``).
    The backend is ``nccl`` for ``device`` on CUDA and ``gloo`` on the
    CPU unless ``backend`` names one; on CUDA the process's GPU
    (``local_rank()``) is made current first."""
    if not (p.get("distributed") or os.environ.get("JSPSR_DISTRIBUTED")):
        return 0
    if process_group() is not None:
        return dist.get_rank()
    kw = dict(p.get("distributed_kwargs") or {})
    if kw:
        init = {"init_method": f"tcp://{kw['coordinator_address']}",
                "world_size": int(kw["num_processes"]),
                "rank": int(kw["process_id"])}
    else:
        init = {"init_method": "env://"}
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed training on CUDA needs a card; "
                               "pass device='cpu' (CLI: --device cpu) for a "
                               "gloo group on the CPU")
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local_rank(init.get("rank")))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s),
                            **init)
    print(f"[distributed] process {dist.get_rank()}/{dist.get_world_size()} "
          f"up, backend {dist.get_backend()}", file=sys.stderr)
    return dist.get_rank()


def process_device(device) -> torch.device:
    """The device this process trains on: an unindexed ``cuda`` becomes
    ``cuda:<local rank>`` in a process group (rank n of a host uses its
    n-th GPU); anything else stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and \
            process_group() is not None:
        return torch.device("cuda", local_rank())
    return dev


# ---------------------------------------------------------------------------
# collectives of the train step
# ---------------------------------------------------------------------------

def _through_flat(tensors, collective, device) -> None:
    """Run ``collective`` on one flat buffer per dtype holding
    ``tensors`` (in their order, on ``device``), then copy the result back
    into each."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in ts])
        collective(flat)
        off = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n


def all_reduce_grads(params, group=None, average: bool = True) -> None:
    """The mean gradient over the process group, in place: one flat
    buffer per dtype in parameter order, summed, then divided by the world
    size (XLA's one gradient all-reduce). Nothing without a group. With
    ``average`` False the sum: under a 2-D mesh each rank's loss is its
    block's share of the whole batch's (``parallel/spatial.py``), so the
    summed gradient is the whole batch's."""
    group = group or process_group()
    if group is None:
        return
    grads = [q.grad for q in params]
    world = dist.get_world_size(group)

    def reduce(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if average:
            flat.div_(world)

    _through_flat(grads, reduce, grads[0].device)


def reduce_step_outputs(out: dict, group=None) -> dict:
    """A train step's loss dict the same on every rank: each loss the mean
    over the ranks, a ``*_min`` / ``*_max`` monitor entry the minimum /
    maximum; one all-reduce per kind. Unchanged without a group."""
    group = group or process_group()
    if group is None or not out:
        return out
    world = dist.get_world_size(group)
    kinds = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
             "mean": dist.ReduceOp.SUM}
    by_kind = {}
    for k in out:
        kind = k.rsplit("_", 1)[-1] if k.endswith(("_min", "_max")) \
            else "mean"
        by_kind.setdefault(kind, []).append(k)
    reduced = dict(out)
    for kind, keys in by_kind.items():
        flat = torch.stack([out[k].float() for k in keys])
        dist.all_reduce(flat, op=kinds[kind], group=group)
        if kind == "mean":
            flat = flat / world
        reduced.update({k: flat[i].to(out[k].dtype)
                        for i, k in enumerate(keys)})
    return reduced


def all_gather_list(x: torch.Tensor, group=None) -> list:
    """The ranks' ``x`` (equal shapes) in rank order. The collective copies
    bytes, so the input and the outputs are contiguous alike (a tensor
    with other strides, an autograd gradient among them, is copied
    first). A bf16 tensor travels as its bytes (a uint8 view, exact):
    gloo's collectives refuse int16, and which take bf16 depends on the
    build."""
    x = x.contiguous()
    wire = (x.reshape(-1).view(torch.uint8) if x.dtype == torch.bfloat16
            else x)
    parts = [torch.empty_like(wire, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    if wire is x:
        return parts
    return [p.view(x.dtype).view(x.shape) for p in parts]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along dim 0 in rank
    order: the global batch whose shards the ranks hold."""
    return torch.cat(all_gather_list(x, group))


def global_rows(batch: int) -> tuple[int, int]:
    """(global batch, this rank's first row) for a per-rank ``batch``:
    under an open spatial sharding, the whole batch over the data axis and
    the first row of this rank's data index (every rank of a space group
    holds the same batch rows); in the data-parallel step running now, its
    group's; (batch, 0) outside both."""
    if _SHARDING is not None:
        m = _SHARDING.mesh
        return batch * m.n_data, batch * m.data_index
    group = step_group()
    if group is None:
        return batch, 0
    rank, world = rank_world(group)
    return batch * world, batch * rank


def _state_tensors(model, optimizer) -> list:
    tensors = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        for g in optimizer.param_groups:
            for q in g["params"]:
                st = optimizer.state.get(q, {})
                tensors += [st[k] for k in sorted(st)
                            if torch.is_tensor(st[k])]
    return tensors


def replicate_state(model: torch.nn.Module, optimizer=None,
                    group=None) -> None:
    """Broadcast rank 0's parameters, buffers and optimizer state to every
    rank, in place (nothing without a group). The JAX package relies on
    its seeded init and checkpoint loads being the same on every process;
    the port broadcasts, so a rank whose state differed (another init, a
    file read differently) cannot train on apart."""
    group = group or process_group()
    if group is None:
        return
    dev = next(model.parameters()).device
    _through_flat(_state_tensors(model, optimizer),
                  lambda flat: dist.broadcast(flat, 0, group=group), dev)


def broadcast_value(value):
    """Rank 0's ``value`` (any picklable object) on every rank; ``value``
    itself without a group. Decisions that read the file system or the
    scores of one rank's eval go through here, so that every rank takes
    the same branch and no collective is left waiting."""
    if process_group() is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_ranks_agree(ok: bool) -> bool:
    """True on every rank when ``ok`` is true on every rank."""
    if process_group() is None:
        return bool(ok)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, bool(ok))
    return all(out)


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if process_group() is not None:
        dist.barrier()


def is_writer() -> bool:
    """Whether this process writes the run's shared files (checkpoints):
    rank 0, as in the JAX package (``jspsr_tpu/train/checkpoint.py:59``)."""
    return rank_world()[0] == 0


# ---------------------------------------------------------------------------
# the mesh of local devices
# ---------------------------------------------------------------------------

class Mesh:
    """The local devices that one process splits a batch over, with the
    rank and world size of its process group (0 and 1 without one).

    ``split_forward`` runs slice i of a batch on ``devices[i]`` with a
    replica of the model on that device: the model itself where it lives
    there, else a copy made once and refreshed whenever the model's
    tensors have changed since (an optimizer step, a load)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.rank, self.world = rank_world()
        self._replicas = weakref.WeakKeyDictionary()

    @property
    def size(self) -> int:
        return len(self.devices)

    def key(self) -> tuple:
        """A hashable name of the mesh's devices (a runner cache's key)."""
        return tuple(str(d) for d in self.devices)

    def replicas(self, model: torch.nn.Module) -> list:
        """One model per mesh entry, each on its entry's device (a module
        that holds no tensor runs anywhere: itself)."""
        tensors = [*model.parameters(), *model.buffers()]
        if not tensors:
            return [model] * self.size
        home = tensors[0].device
        cache = self._replicas.setdefault(model, {})
        stamp = tuple((id(t), t._version) for t in tensors)
        out = []
        for dev in self.devices:
            if _same_device(dev, home):
                out.append(model)
                continue
            # ordinary tensors, also when called under inference_mode
            with torch.inference_mode(False), torch.no_grad():
                hit = cache.get(str(dev))
                if hit is None:
                    hit = [None, copy.deepcopy(model).to(dev)]
                    cache[str(dev)] = hit
                if hit[0] != stamp:
                    hit[1].load_state_dict(model.state_dict())
                    hit[0] = stamp
            hit[1].train(model.training)
            out.append(hit[1])
        return out

    def split_forward(self, model, inputs: list, call=None,
                      out_device=None) -> list:
        """Run ``call(replica, slice)`` (default ``replica(slice)``) on each
        mesh entry's slice of the batch ``inputs`` (a list of tensors
        split along dim 0, which must divide by the mesh size), each on
        its device's current stream; returns the outputs per entry, each
        moved to ``out_device`` where given (tensors, or dicts and
        tuples of them)."""
        call = call or (lambda m, xs: m(xs))
        pieces = shard_batch(self, inputs)
        outs = []
        for dev, replica, piece in zip(self.devices, self.replicas(model),
                                       pieces):
            with _on(dev):
                outs.append(call(replica, piece))
        if out_device is not None:
            outs = [_to(o, out_device) for o in outs]
        return outs


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (every local GPU by default: ``cuda:0``,
    ``cuda:1``, ...). Raises where no device is given and there is no
    card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() without devices needs CUDA; "
                               "name the devices (e.g. ['cpu', 'cpu'])")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def as_mesh(mesh) -> Mesh | None:
    """A ``mesh=`` argument as a Mesh: None stays None, a Mesh stays as
    it is, a list of devices becomes one."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return make_mesh(list(mesh))


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    ia = a.index if a.index is not None else torch.cuda.current_device()
    ib = b.index if b.index is not None else torch.cuda.current_device()
    return ia == ib


def _on(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _to(obj, device):
    if torch.is_tensor(obj):
        return obj.to(device, non_blocking=True)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree) -> list:
    """``tree`` (tensors or numpy arrays, in lists, tuples or dicts) split
    along dim 0 into one equal slice per mesh entry, slice i on
    ``mesh.devices[i]`` as a tensor: the pieces of the JAX package's
    batch-sharded array, in its order. The batch must divide by the mesh
    size."""
    n = mesh.size
    batch = int(np.shape(_leaves(tree)[0])[0])
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over {n} devices")
    rows = batch // n

    def piece(i, dev):
        def cut(x):
            x = x[i * rows:(i + 1) * rows]
            x = torch.as_tensor(np.ascontiguousarray(x)) \
                if isinstance(x, np.ndarray) else x
            return x.to(dev, non_blocking=True)
        return _map(cut, tree)

    return [piece(i, dev) for i, dev in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# the 2-D (data x space) mesh of processes
# ---------------------------------------------------------------------------

class Mesh2D:
    """A process group laid out as ``n_data`` x ``n_space``: this rank's
    place (``data_index``, ``space_index``), the group of its space index
    across the data axis (``data_group``), the group of its data index
    across the space axis (``space_group``, which a row slab's halos and
    pools reduce over) and the whole group (``group``, which train-mode
    BatchNorm and the losses reduce over)."""

    def __init__(self, n_data, n_space, rank, group, data_group,
                 space_group):
        self.n_data, self.n_space = n_data, n_space
        self.rank, self.world = rank, n_data * n_space
        self.data_index, self.space_index = divmod(rank, n_space)
        self.group = group
        self.data_group, self.space_group = data_group, space_group


def make_2d_mesh(n_data: int, n_space: int, group=None) -> Mesh2D:
    """The 2-D mesh over ``group`` (the default process group), whose
    world must be ``n_data * n_space``: rank r at (r // n_space, r %
    n_space), row-major as the JAX package's ``reshape(n_data, n_space)``
    (``jspsr_tpu/parallel/mesh.py:82-86``). Every rank builds every data
    and space group (``dist.new_group``), in one order: data groups by
    space index, then space groups by data index."""
    group = group or process_group()
    if group is None:
        raise RuntimeError("make_2d_mesh needs a process group of "
                           f"n_data * n_space = {n_data * n_space} ranks "
                           "(init_distributed, or parallel.spawn.run_ranks)")
    world = dist.get_world_size(group)
    if world != n_data * n_space:
        raise ValueError(f"make_2d_mesh({n_data}, {n_space}) needs a world "
                         f"of {n_data * n_space} ranks, the group has "
                         f"{world}")
    ranks = dist.get_process_group_ranks(group)
    timeout = timedelta(seconds=DIST_TIMEOUT_S)
    rank = dist.get_rank(group)
    data_groups = [dist.new_group([ranks[d * n_space + s]
                                   for d in range(n_data)], timeout=timeout)
                   for s in range(n_space)]
    space_groups = [dist.new_group([ranks[d * n_space + s]
                                    for s in range(n_space)], timeout=timeout)
                    for d in range(n_data)]
    d, s = divmod(rank, n_space)
    return Mesh2D(n_data, n_space, rank, group, data_groups[s],
                  space_groups[d])


class SpatialSharding:
    """NCHW batches over a ``Mesh2D``: rows of the batch over the data
    axis, image rows (H) over the space axis, as the JAX package's
    ``P("data", "space")`` on NHWC (``jspsr_tpu/parallel/mesh.py:89-92``).

    ``shard(x)`` is this rank's block of a whole batch, ``gather(y)`` the
    whole batch from every rank's block (on every rank), and inside
    ``active()`` a model's forward on the blocks computes the whole batch's
    blocks (``parallel/spatial.py``)."""

    def __init__(self, mesh: Mesh2D):
        self.mesh = mesh

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole NCHW batch ``x``: batch rows
        ``[d * B/n_data, (d+1) * B/n_data)``,
        image rows ``[s * H/n_space, (s+1) * H/n_space)``, contiguous.
        Refuses a batch that does not divide by ``n_data`` and an H that
        does not divide by ``n_space`` (a model's own row multiple:
        ``parallel.spatial.check_rows``)."""
        m = self.mesh
        if x.dim() != 4:
            raise ValueError(f"shard takes NCHW batches, got shape "
                             f"{tuple(x.shape)}")
        b, _, h, _ = x.shape
        if b % m.n_data:
            raise ValueError(f"batch {b} does not divide over the data "
                             f"axis's {m.n_data} ranks")
        if h % m.n_space:
            raise ValueError(f"H = {h} does not divide over the space "
                             f"axis's {m.n_space} ranks")
        rb, rh = b // m.n_data, h // m.n_space
        return x[m.data_index * rb:(m.data_index + 1) * rb, :,
                 m.space_index * rh:(m.space_index + 1) * rh].contiguous()

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The whole batch, on every rank, from every rank's NCHW block
        ``y`` (equal shapes): the slabs concatenated along H in space order,
        then the data rows along the batch in data order. Not
        differentiable."""
        m = self.mesh
        rows = torch.cat(all_gather_list(y.detach(), m.space_group), dim=2)
        return torch.cat(all_gather_list(rows, m.data_group))

    @contextlib.contextmanager
    def active(self):
        """Within it, a forward on this rank's block is that block of the
        whole batch's forward (``parallel/spatial.py``)."""
        global _SHARDING
        prev, _SHARDING = _SHARDING, self
        try:
            yield self
        finally:
            _SHARDING = prev


def spatial_sharding(mesh: Mesh2D) -> SpatialSharding:
    """The sharding of NCHW batches over ``mesh``'s (data, space) axes."""
    return SpatialSharding(mesh)


def pad_batch_to(tree, batch: int):
    """Pad dim 0 of every leaf up to ``batch`` by repeating its last row,
    so that the batch divides over a mesh; returns (padded tree, real
    count), as ``jspsr_tpu/parallel/mesh.py:95-110``. Numpy leaves stay
    numpy, tensors stay tensors."""
    def pad(x):
        n = x.shape[0]
        if n >= batch:
            return x
        if torch.is_tensor(x):
            return torch.cat([x, x[-1:].expand(batch - n, *x.shape[1:])])
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[-1:], batch - n, axis=0)])

    real = int(np.shape(_leaves(tree)[0])[0])
    return _map(pad, tree), real
