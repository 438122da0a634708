"""The data mesh of the port: the counterpart of
``liftreg_tpu/parallel/mesh.py`` with one process per rank.

The JAX package shards a batch's axis 0 over a ``data`` axis of devices in
one process and lets XLA all-reduce the gradients. Here each rank is a
process of its own, joined by ``torch.distributed``: NCCL with one card a
rank, gloo on the CPU and for ranks that share one card (NCCL refuses two
ranks on one card). The same code runs under all three, so it uses the
two collectives gloo supports on CUDA tensors, ``all_reduce`` and
``broadcast``; a barrier is an ``all_reduce`` of one element.

A rank holds rows ``[rank * b, (rank + 1) * b)`` of the padded global
batch of ``size * b`` rows (:func:`shard_batch`), computes its share of
each batch mean over the global batch, and the shares are summed across
the ranks: the gradients by one ``all_reduce`` of their flat f32 buffer,
the losses by one of their scalars. What couples the rows of a batch
(batch-norm statistics, the min-max normalisation of RegNet2D3D's
re-projections, the refinement's stop) is reduced across the ranks as
the JAX mesh computes it over the whole padded batch.

:func:`launch` starts the ranks: ``launch(fn, n)`` runs ``fn(mesh,
*args)`` in ``n`` spawned processes and returns what each returned.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import pickle
import signal
import sys
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ..data.dataset import pad_batch
from ..device import resolve_device

__all__ = ["Mesh", "attach", "launch", "make_mesh", "pad_batch",
           "shard_batch"]

# Keys that are the same for every row of a batch (the dataset shares one
# poses.npy and one spacing a split): given whole to every rank, as the
# JAX mesh replicates them
_REPLICATED_KEYS = ("target_poses", "source_poses", "spacing")

#: prctl's option that signals a process when its parent ends
_PR_SET_PDEATHSIG = 1

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the data mesh: its ``rank`` of ``size``, its
    ``device`` (as :func:`..device.resolve_device` takes it: None is the
    card, the CPU must be asked for), and the process ``group`` (None: one
    process and no collective, every reduction the identity).
    ``collective_bytes`` and ``collective_calls`` count what this rank has
    put into collectives."""
    rank: int = 0
    size: int = 1
    device: Optional[torch.device] = None
    group: Optional[object] = None
    collective_bytes: int = 0
    collective_calls: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def rows(self, global_b):
        """This rank's rows of a global batch of ``global_b`` rows."""
        if global_b % self.size:
            raise ValueError(f"a batch of {global_b} rows does not divide "
                             f"the {self.size}-rank mesh")
        b = global_b // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce(self, t, op="sum"):
        """Reduce ``t`` across the ranks, in place; returns ``t``."""
        if self.group is not None:
            self.collective_bytes += t.numel() * t.element_size()
            self.collective_calls += 1
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def broadcast(self, t, src=0):
        """Overwrite ``t`` with rank ``src``'s, in place; returns ``t``."""
        if self.group is not None:
            self.collective_bytes += t.numel() * t.element_size()
            self.collective_calls += 1
            dist.broadcast(t, src=src, group=self.group)
        return t

    def barrier(self):
        self.all_reduce(torch.zeros(1, device=self.device))

    def broadcast_object(self, obj, src=0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if self.group is None:
            return obj
        data = pickle.dumps(obj) if self.rank == src else b""
        n = self.broadcast(torch.tensor([len(data)], dtype=torch.int64,
                                        device=self.device), src)
        buf = torch.zeros(int(n.item()), dtype=torch.uint8,
                          device=self.device)
        if self.rank == src:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        self.broadcast(buf, src)
        return pickle.loads(buf.cpu().numpy().tobytes())

    def sum(self, t):
        """The sum of ``t`` over the ranks, differentiable: the gradient of
        each rank's input is the sum over the ranks of the gradients that
        reach the output."""
        if self.group is None:
            return t
        return _AllReduceSum.apply(t, self)

    def any(self, flag):
        """A 0-dim bool tensor: ``flag`` (a 0-dim bool tensor) on any
        rank."""
        if self.group is None:
            return flag
        f = self.all_reduce(flag.to(torch.float32).reshape(1), "max")
        return f[0] > 0

    def extremes(self, x):
        """``(x.amin(), x.amax())`` over the ranks' ``x`` together,
        differentiable as ``amin``/``amax`` are (and ``jnp.min``/``max``):
        the gradient of each extreme is shared equally by the elements,
        on any rank, that equal it."""
        if self.group is None:
            return x.amin(), x.amax()
        lo_hi = _GlobalExtremes.apply(x, self)
        return lo_hi[0], lo_hi[1]

    def gather_rows(self, t):
        """The global batch of which ``t`` holds this rank's rows, on every
        rank (an ``all_reduce`` of each rank's rows in its slot)."""
        if self.group is None:
            return t
        out = t.new_zeros((t.shape[0] * self.size,) + tuple(t.shape[1:]))
        out[self.rows(out.shape[0])] = t
        return self.all_reduce(out)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone()), None


class _GlobalExtremes(torch.autograd.Function):
    """(2,) ``[min, max]`` of the ranks' ``x``: one ``all_reduce`` (MAX) of
    ``[-min, max]``, one (SUM) of the elements equal to each, and in the
    backward one (SUM) of the two gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        lo_hi = mesh.all_reduce(torch.stack([-x.amin(), x.amax()]), "max")
        lo_hi[0] = -lo_hi[0]
        hits = torch.stack([x == lo_hi[0], x == lo_hi[1]])
        counts = mesh.all_reduce(hits.flatten(1).sum(1).to(x.dtype))
        ctx.save_for_backward(hits, counts)
        ctx.mesh = mesh
        return lo_hi

    @staticmethod
    def backward(ctx, g):
        hits, counts = ctx.saved_tensors
        g = ctx.mesh.all_reduce(g.clone()) / counts
        shape = (2,) + (1,) * (hits.dim() - 1)
        return (hits * g.view(shape)).sum(0), None


def check_cards(n):
    """Raise unless ``n`` CUDA cards are visible."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise RuntimeError(
            f"requested a {n}-device mesh but only {visible} CUDA card(s) "
            "are visible; refusing to silently build a smaller mesh")


def _rank_device(device):
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of this process. Inside a rank (:func:`launch`, or any
    initialised ``torch.distributed`` world), the world's mesh, whose size
    must be ``n_devices`` when it is given; otherwise a mesh of one rank.
    ``device`` as :func:`..device.resolve_device` takes it (None: this
    rank's card). Asking for more ranks than CUDA cards are visible
    raises, as the JAX package does for devices; so does asking for more
    than one rank outside of a started world."""
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
        if n_devices is not None and int(n_devices) != size:
            raise RuntimeError(f"requested a {n_devices}-device mesh in a "
                               f"world of {size} ranks")
        return Mesh(rank=dist.get_rank(), size=size,
                    device=_rank_device(device), group=dist.group.WORLD)
    n = 1 if n_devices is None else int(n_devices)
    if n > 1:
        if resolve_device(device).type == "cuda":
            check_cards(n)
        raise RuntimeError(
            f"a {n}-device mesh runs one process a rank: start them with "
            "liftreg_tpu_torch.parallel.launch or main --n_devices")
    return Mesh(device=device)


def attach(module, mesh: Mesh):
    """Give ``mesh`` to every submodule of ``module`` whose class reduces
    over the batch and says so with a ``mesh`` class attribute (batch norm,
    RegNet2D3D's normalisation); returns ``module``."""
    for m in module.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh
    return module


def shard_batch(batch: dict, mesh: Mesh):
    """This rank's rows of a (padded) global batch dict, on its device.
    Arrays of the batch-constant keys, and arrays whose leading dim does
    not divide the mesh, are given whole (the JAX mesh replicates
    them); only the rows taken are copied to the device."""
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape"):
            out[k] = v
            continue
        v = torch.as_tensor(v)
        if v.dim() > 0 and v.shape[0] % mesh.size == 0 \
                and k not in _REPLICATED_KEYS:
            v = v[mesh.rows(v.shape[0])]
        out[k] = v.to(mesh.device)
    return out


def _die_with_parent():
    """End this process when the one that launched it ends (Linux), so that
    no rank outlives a launcher that was killed."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG,
                                                signal.SIGKILL)


def _rank_main(rank, fn, n, device, backend, tmp, args):
    _die_with_parent()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", (dev.index or 0)
                           + (rank if backend == "nccl" else 0))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"),
        world_size=n, rank=rank)
    try:
        result = fn(Mesh(rank=rank, size=n, device=dev,
                         group=dist.group.WORLD), *args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def launch(fn, n_devices, device=None, backend=None, args=()):
    """Run ``fn(mesh, *args)`` in ``n_devices`` spawned processes, one a
    rank, and return the list of what each rank's call returned (they are
    pickled). ``fn`` must be importable (a module-level function).

    ``device`` None or ``"cuda"``/``"cuda:G"``: one card a rank,
    ``cuda:G + rank``, over NCCL, and fewer visible cards than ranks
    raise; with ``backend="gloo"`` every rank runs on that one card
    instead (for checks: the ranks share the card's memory and time).
    ``"cpu"``: gloo on the CPU. The kernels are built here, once, before
    the ranks start. The ranks meet over a ``file://`` store in a
    temporary directory, so concurrent launches never share a port. A
    rank that raises ends the others and raises here."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        backend = backend or "nccl"
        # NCCL: a card a rank; gloo: the ranks share the one card
        check_cards((dev.index or 0)
                    + (int(n_devices) if backend == "nccl" else 1))
        from ..ops import _build
        _build.build()
    else:
        backend = backend or "gloo"
    with tempfile.TemporaryDirectory(prefix="liftreg_mesh_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, int(n_devices), str(dev), backend, tmp,
                              tuple(args)),
            nprocs=int(n_devices), join=True, start_method="spawn")
        results = []
        for rank in range(int(n_devices)):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results

