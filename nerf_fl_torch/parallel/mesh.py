"""The ('data', 'model') mesh of a data- and tensor-parallel job.

Counterpart of ``nerf_fl_tpu/parallel/mesh.py``.  The JAX package hands a
sharding layout to XLA, which places the collectives; here every rank is
a process (``torch.distributed``, one device a rank, ``parallel.launch``
starts them) and the collectives are written out:

  * ``data`` axis: each rank renders and trains on its contiguous rows of
    the global ray batch (``shard_batch``; ``data.sampler.host_rows``
    under ``microbatch``).  The train step all-reduces the gradients and
    the metric values over the data group (``training/system.py``), and a
    render all-gathers its pixel outputs.
  * ``model`` axis (optional): tensor parallelism over the MLP width.  The
    layout is the JAX package's ``_nerf_param_spec`` (Megatron style):
    even ``xyz`` layers column-parallel and odd ones row-parallel,
    ``xyz_final`` and ``dir`` column-parallel, everything else replicated;
    a dim is sharded only where it divides evenly.  The collectives are
    autograd Functions (``_CopyToModel``, ``_ReduceFromModel``,
    ``_GatherFromModel``) that the sharded layers call through their
    ``tp`` attribute (``models/mlp.py``).

Global ranks are process-contiguous with ``model`` fastest, as ``make_mesh``
reshapes the JAX device list to (data, model).  The backend follows from
the devices: NCCL where every rank has a CUDA device of its own, gloo on
the CPU or where ranks share a card.  Gloo cannot gather CUDA tensors, so
on a shared card every collective is staged through host memory.
"""
from __future__ import annotations

import contextlib
import functools
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]


def visible_devices() -> List[torch.device]:
    """The CUDA devices this process sees (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    devices = [torch.device(d) for d in devices]
    own = len({str(d) for d in devices}) == len(devices)
    return "nccl" if own and all(d.type == "cuda" for d in devices) \
        else "gloo"


class Comm:
    """Collectives over one process group of a job (``group`` None: the
    whole job), or with ``solo`` over this process alone, outside any job,
    where every collective is the identity.  ``staged``: the backend
    cannot take this device's tensors (gloo with CUDA), so each collective
    copies through host memory.  Sums run in f32 (a bf16 activation is
    summed in f32 and rounded back).  ``name`` ('data', 'model' or
    'world') names the group in a ``Pieces`` plan.

    ``all_reduce`` and ``all_gather`` write their result into a tensor
    that exists before the collective runs (the input, or a new output
    made first), so a step cut at its collectives can run them between the
    captured pieces of a CUDA graph: while ``pieces`` is set
    (``recording``), each goes to it instead of running."""

    def __init__(self, group, size: int, index: int, staged: bool,
                 solo: bool = False, name: str = "world"):
        self.group, self.size, self.index, self.staged = \
            group, size, index, staged
        self.solo, self.name = solo, name
        self.pieces: Optional["Pieces"] = None

    def _collective(self, name: str, run) -> None:
        """Run a collective now (``run(None)``), or hand it to the
        recording ``Pieces``.  A capture that no ``Pieces`` records would
        keep the collective out of its replays: that raises."""
        if self.pieces is not None:
            self.pieces.cut(f"{self.name}.{name}", run)
            return
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{self.name}.{name} inside a CUDA graph capture that no "
                f"parallel.mesh.Pieces records (recording(pieces, mesh) "
                f"with the mesh whose groups the model's layers use)")
        run(None)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns ``t``."""
        if self.solo:
            return t
        self._collective(f"all_reduce{tuple(t.shape)}",
                         lambda keep: self._all_reduce(t, keep))
        return t

    def _all_reduce(self, t, keep):
        work = t.float() if t.dtype != torch.float32 else t
        if self.staged and work.is_cuda:
            host = _to_host(work, keep)
            dist.all_reduce(host, group=self.group)
            work.copy_(host)
        else:
            dist.all_reduce(work, group=self.group)
        if work is not t:
            t.copy_(work)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The group's tensors concatenated along ``dim`` in rank order, on
        ``t``'s device."""
        if self.solo:
            return t
        src = t.detach().contiguous()
        shape = list(src.shape)
        shape[dim] *= self.size
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
        self._collective(f"all_gather{tuple(src.shape)}@{dim}",
                         lambda keep: self._all_gather(src, out, dim, keep))
        return out

    def _all_gather(self, src, out, dim, keep):
        if self.staged and src.is_cuda:
            src = _to_host(src, keep)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out.copy_(torch.cat(parts, dim))

    def broadcast(self, t: torch.Tensor, src: int) -> None:
        """``t`` from global rank ``src``, in place."""
        if self.solo:
            return
        if self.staged and t.is_cuda:
            host = t.detach().cpu()
            dist.broadcast(host, src, group=self.group)
            t.data.copy_(host)
        else:
            dist.broadcast(t.data, src, group=self.group)


def _to_host(t: torch.Tensor, keep: Optional[list]) -> torch.Tensor:
    """A host copy of ``t`` for a staged collective: a new one, or with
    ``keep`` (a replayed cut's list) one pinned buffer, made at the cut's
    first replay and written again at every later one."""
    if keep is None:
        return t.cpu()
    if not keep:
        keep.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
    keep[0].copy_(t)
    return keep[0]


# ----------------------------------------------------------------------
# a step cut at its collectives
# ----------------------------------------------------------------------

class Pieces:
    """One train sub-step cut at its collectives.

    ``plan`` names the collectives that the sub-step ran under
    ``recording``, in order.  On the CPU (``capture`` False) each
    collective runs where it is called, as without the record.  On the
    card the sub-step is captured as CUDA graphs, one a piece between two
    collectives: ``begin`` starts the first piece's capture, a collective
    ends the piece and starts the next one in the first one's memory pool,
    and ``end`` ends the last, all on the stream the first began on.  A
    collective does not run at its cut (the captured work before it has
    not run either); it is kept, with a pinned host buffer of its own
    where it is staged, and ``replay`` runs each piece and then its
    collective.  The collectives write into tensors that a piece made
    (``Comm``), the pieces read them where they lie, and a kept collective
    holds them, so no later capture reuses their memory.

    A tensor-parallel layer's backward cuts from autograd's device thread,
    where a capture begun on the caller's thread ends, so the captures run
    in CUDA's relaxed mode there (``relaxed``).  Every piece registers the
    step's generator: a draw after a cut (``sample_pdf``'s) advances the
    Philox offset at a replay as it did in the eager sub-step."""

    def __init__(self, capture: bool, generator=None, relaxed=False):
        self.capture, self.generator = capture, generator
        self.mode = "relaxed" if relaxed else "global"
        self.plan: List[str] = []
        self.graphs: List[Any] = []
        self.runs: List[Any] = []
        self.pool = self.stream = None

    def begin(self) -> None:
        if self.stream is None:
            self.stream = torch.cuda.current_stream()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode=self.mode)
        self.graphs.append(graph)

    def end(self) -> None:
        with torch.cuda.stream(self.stream):
            self.graphs[-1].capture_end()
        if self.pool is None:      # known once the first capture has ended
            self.pool = self.graphs[0].pool()

    def cut(self, name: str, run) -> None:
        self.plan.append(name)
        if not self.capture:
            run(None)
            return
        self.end()
        self.runs.append(functools.partial(run, []))
        self.begin()

    def replay(self) -> None:
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.runs):
                self.runs[i]()

    def digest(self) -> int:
        """A checksum of ``plan`` that every process computes alike."""
        return zlib.crc32("\n".join(self.plan).encode())


@contextlib.contextmanager
def recording(pieces: Pieces, mesh: Optional["Mesh"]):
    """Inside the block, the collectives of ``mesh``'s groups cut
    ``pieces``, from whichever thread they are called (a tensor-parallel
    layer's backward runs on autograd's device thread).  Without a mesh
    there is no collective to cut."""
    comms = () if mesh is None else (mesh.data, mesh.model, mesh.world)
    if any(c.pieces is not None for c in comms):
        raise RuntimeError("a sub-step is already being recorded")
    for c in comms:
        c.pieces = pieces
    try:
        yield pieces
    finally:
        for c in comms:
            c.pieces = None


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh: the axis sizes, the
    global rank, the device, the backend, and the collectives of the rank's
    data group (the ranks of its model index), model group (the ranks of
    its data index) and the whole job."""
    num_data: int
    num_model: int
    rank: int
    device: torch.device
    backend: str
    data: Comm
    model: Comm
    world: Comm

    @property
    def data_index(self) -> int:
        return self.rank // self.num_model

    @property
    def model_index(self) -> int:
        return self.rank % self.num_model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.num_data, "model": self.num_model}

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _too_few(num_data: int, num_model: int, n: int, kind: str) -> str:
    use = num_data * num_model
    return (f"requested mesh data={num_data} x model={num_model} = {use} "
            f"devices but only {n} {kind} device(s) available. Fixes: run "
            f"fewer ranks (--num_gpus {max(1, n // num_model)}, or "
            "--num_gpus 1 on a single card), or run the ranks on the CPU "
            "over gloo (NERF_FL_TORCH_DEVICE=cpu, or make_mesh(devices="
            f"['cpu'] * {use})); ranks may also share a card over gloo "
            f"(make_mesh(devices=['cuda:0'] * {use}))")


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              devices=None) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (None: the visible
    cards), one rank a device, rank r on ``devices[r]``.

    Raises when the devices are too few.  In a ``torch.distributed`` job
    (``parallel.launch``) its world size must be the mesh's, and the data
    and model groups are created (every rank calls this, in the same
    order); outside one, only a mesh of one rank can be made."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else visible_devices())]
    n = len(devices)
    if num_data is None:
        if not n or n % num_model:
            raise ValueError(f"{n} devices not divisible by "
                             f"model={num_model}")
        num_data = n // num_model
    use = num_data * num_model
    if use > n:
        kind = devices[0].type if devices else "cuda"
        raise ValueError(_too_few(num_data, num_model, n, kind))
    devices = devices[:use]
    backend = backend_for(devices)
    if not dist.is_initialized():
        if use > 1:
            raise ValueError(
                f"a mesh of {use} ranks needs one process a rank in a "
                "torch.distributed job: start them with "
                "nerf_fl_torch.parallel.launch (the train and eval CLIs "
                "do for --num_gpus / --model_parallel / --num_hosts)")
        solo = Comm(None, 1, 0, False, solo=True)
        return Mesh(1, 1, 0, devices[0], backend, solo, solo, solo)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != use:
        raise ValueError(f"the job has {world} ranks, the mesh data="
                         f"{num_data} x model={num_model} needs {use}")
    # the job's backend was chosen when it started (``parallel.launch``, by
    # ``backend_for`` over each host's devices)
    device, backend = devices[rank], dist.get_backend()
    staged = backend == "gloo" and device.type == "cuda"
    data_group = model_group = None
    for m in range(num_model):
        g = dist.new_group([d * num_model + m for d in range(num_data)])
        if rank % num_model == m:
            data_group = g
    for d in range(num_data):
        g = dist.new_group([d * num_model + m for m in range(num_model)])
        if rank // num_model == d:
            model_group = g
    return Mesh(num_data, num_model, rank, device, backend,
                data=Comm(data_group, num_data, rank // num_model, staged,
                          name="data"),
                model=Comm(model_group, num_model, rank % num_model, staged,
                           name="model"),
                world=Comm(None, world, rank, staged))


def shard_batch(mesh: Mesh, batch: Any, axis: int = 0) -> Any:
    """This rank's contiguous rows of a global batch dict: the slice
    ``data_index`` of ``num_data`` along ``axis`` (1 for the (K, B, ...)
    stacks of ``steps_per_execution``)."""
    def cut(x):
        n = x.shape[axis]
        if n % mesh.num_data:
            raise ValueError(f"batch axis {n} not divisible by data="
                             f"{mesh.num_data}")
        per = n // mesh.num_data
        return x.narrow(axis, mesh.data_index * per, per) \
            if torch.is_tensor(x) else np.take(
                x, np.arange(mesh.data_index * per,
                             (mesh.data_index + 1) * per), axis=axis)
    return {k: cut(v) for k, v in batch.items()}


# ----------------------------------------------------------------------
# tensor parallelism
# ----------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the
    model group (in front of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; identity backward (after a
    row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's feature shards concatenated along the last dim;
    the backward keeps this rank's columns of the gradient (which is the
    same on every model rank: what follows is replicated)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm, ctx.width = comm, x.shape[-1]
        return comm.all_gather(x, dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.comm.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


class TensorParallel:
    """A sharded layer's collectives: ``kind`` 'col' (output features
    sharded) or 'row' (input features sharded), over ``comm``, the model
    group."""

    def __init__(self, kind: str, comm: Comm):
        self.kind, self.comm = kind, comm

    def enter(self, x):
        return _CopyToModel.apply(x, self.comm) if self.kind == "col" else x

    def leave(self, y):
        return _ReduceFromModel.apply(y, self.comm) \
            if self.kind == "row" else y

    def gather(self, y):
        return _GatherFromModel.apply(y, self.comm)


def _nerf_param_spec(path: Sequence[str], ndim: int) -> Spec:
    """Tensor-parallel layout of one NeRF MLP leaf, in the port's layout
    (``nn.Linear`` weights are (out, in), the JAX tree's (in, out)): the
    JAX package's ``_nerf_param_spec``.  Trunk layers alternate column-
    parallel (shard the out dim) and row-parallel (shard the in dim);
    heads and row-parallel biases stay replicated."""
    name, where = path[-1], path[:-1]
    col = ("model", None) if ndim == 2 else ("model",)
    row = (None, "model") if ndim == 2 else (None,)
    if where and where[0] == "xyz":
        idx = int(where[1]) if len(where) > 1 else 0
        return col if idx % 2 == 0 else row
    if where and where[0] in ("xyz_final", "dir"):
        return col
    return (None,) * ndim


def param_shardings(mesh: Mesh, params: Dict[str, Any],
                    model_parallel: bool = False) -> Dict[str, Spec]:
    """Each leaf's spec (``optimizers.named_leaves`` names): one entry a
    dim, ``'model'`` where the dim is sharded over the model axis.  Without
    ``model_parallel`` everything is replicated (pure DP)."""
    from ..training.optimizers import named_leaves
    out = {}
    for name, leaf in named_leaves(params):
        spec: Spec = (None,) * leaf.dim()
        keys = name.split(".")
        if model_parallel and keys[0] in ("nerf_coarse", "nerf_fine"):
            want = _nerf_param_spec(keys[1:], leaf.dim())
            if all(a is None or leaf.shape[i] % mesh.num_model == 0
                   for i, a in enumerate(want)):
                spec = want
        out[name] = spec
    return out


def _shard_dim(spec: Spec) -> Optional[int]:
    return next((i for i, a in enumerate(spec) if a == "model"), None)


def place_params(mesh: Mesh, params: Dict[str, Any],
                 model_parallel: bool = False,
                 optimizer: Optional[torch.optim.Optimizer] = None
                 ) -> Dict[str, Any]:
    """Broadcast every leaf from global rank 0 and, under
    ``model_parallel``, keep this rank's shard of each sharded leaf (and
    of the optimizer's state of the same shape), in place: the
    ``Parameter`` objects stay the optimizer's.  The sharded ``nn.Linear``
    layers get a ``tp`` attribute (``TensorParallel``).  Returns
    ``params``."""
    from ..training.optimizers import named_leaves
    for _, leaf in named_leaves(params):
        mesh.world.broadcast(leaf, 0)
    if not model_parallel or mesh.num_model == 1:
        return params
    specs = param_shardings(mesh, params, True)
    leaves = dict(named_leaves(params))
    state = {} if optimizer is None else optimizer.state
    m, M = mesh.model_index, mesh.num_model
    for name, spec in specs.items():
        dim = _shard_dim(spec)
        if dim is None:
            continue
        p = leaves[name]
        full = tuple(p.shape)
        per = full[dim] // M
        with torch.no_grad():
            p.data = p.data.narrow(dim, m * per, per).clone()
            for k, v in state.get(p, {}).items():
                if torch.is_tensor(v) and tuple(v.shape) == full:
                    state[p][k] = v.narrow(dim, m * per, per).clone()
    for key in ("nerf_coarse", "nerf_fine"):
        if key not in params:
            continue
        for lname, mod in params[key].named_modules():
            if isinstance(mod, torch.nn.Linear):
                wspec = specs[f"{key}.{lname}.weight"]
                if wspec == ("model", None):
                    mod.tp = TensorParallel("col", mesh.model)
                elif wspec == (None, "model"):
                    mod.tp = TensorParallel("row", mesh.model)
    return params


@contextlib.contextmanager
def whole_params(mesh: Optional[Mesh], params: Dict[str, Any],
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 model_parallel: bool = False):
    """Inside the block, every sharded leaf (and its optimizer state of
    the same shape) holds the whole tensor, gathered from the model ranks
    (every rank must enter), so that a checkpoint written there is the
    single-device one; the shards come back after.  Without a model axis
    the block changes nothing."""
    if mesh is None or mesh.num_model == 1 or not model_parallel:
        yield params
        return
    from ..training.optimizers import named_leaves
    specs = param_shardings(mesh, params, True)
    leaves = dict(named_leaves(params))
    state = {} if optimizer is None else optimizer.state
    kept = []
    for name, spec in specs.items():
        dim = _shard_dim(spec)
        if dim is None:
            continue
        p = leaves[name]
        shard = p.data
        st = {k: v for k, v in state.get(p, {}).items()
              if torch.is_tensor(v) and v.shape == shard.shape}
        kept.append((p, shard, st))
        # the sharded dim is gathered: all_gather concatenates along it
        p.data = mesh.model.all_gather(shard, dim)
        for k, v in st.items():
            state[p][k] = mesh.model.all_gather(v, dim)
    try:
        yield params
    finally:
        for p, shard, st in kept:
            p.data = shard
            for k, v in st.items():
                state[p][k] = v
