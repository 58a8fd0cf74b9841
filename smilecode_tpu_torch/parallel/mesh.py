"""Rank grid, process groups and collectives of multi-GPU training.

Counterpart of `smilecode_tpu/parallel/mesh.py:24-60`. JAX lays a
``(data, spatial)`` mesh over ``dp * spatial`` devices and lets shard_map
insert the collectives; here each device is a process (`run_ranks` spawns
them) and the collectives are explicit:

* **Rank grid.** Rank r sits at (r // spatial, r % spatial), as JAX's
  ``devices.reshape(dp, spatial)`` places devices. Each row of the grid is a
  "spatial" process group (the D shards of one batch shard), each column a
  "data" group (the batch shards of one D slab).
* **Backend.** NCCL when each rank has a card of its own; gloo on the CPU,
  or when ranks share a card (NCCL refuses two ranks on one device). With
  gloo no sum runs inside the collective: `all_reduce_` all-gathers the
  summands and `reduce_scatter_d` all-to-alls the slabs, and each rank adds
  what it received on its own device, in rank order (so every rank gets
  the same bits). On CUDA tensors gloo broadcasts itself
  (`GLOO_CUDA_DIRECT`); all_gather, all_to_all and send/recv are staged
  through pinned host buffers, so only bytes travel through the host and
  every sum runs on the card. `Mesh.describe` says which, and `run_ranks`
  prints it.
* **Differentiable collectives** (`psum`, `ppermute`, `all_gather_d`), each
  a `torch.autograd.Function` whose backward is JAX's transpose: psum <->
  psum (every rank's loss is its own contribution, and the gradients are
  summed over the shards after the backward, as in
  `smilecode_tpu/parallel/modet_planes_sp.py:571-577`), ppermute <-> the
  reverse ppermute, all_gather over D <-> reduce_scatter over D.
* `shard_batch` (contiguous rows, and the D slab when spatial > 1: JAX's
  `batch_spec`) and `replicate` (a broadcast from rank 0).

Imports torch and numpy only.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the collective that gloo runs on CUDA tensors itself; the others are staged
# through pinned host buffers
GLOO_CUDA_DIRECT = ("broadcast",)


@dataclasses.dataclass
class Mesh:
    """This rank's place in the dp x spatial grid, its device and groups."""

    dp: int
    spatial: int
    rank: int
    device: torch.device
    backend: str
    groups: dict  # axis -> this rank's process group along it
    ranks: dict  # axis -> the global ranks of that group, in axis order

    @property
    def world(self) -> int:
        return self.dp * self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def size(self, axis: str) -> int:
        return self.dp if axis == "data" else self.spatial

    def staged(self, op: str, t: torch.Tensor) -> bool:
        """Whether collective ``op`` on ``t`` goes through pinned host buffers."""
        return self.backend == "gloo" and t.device.type == "cuda" and op not in GLOO_CUDA_DIRECT

    def describe(self) -> str:
        where = (f"{self.world} ranks on {self.device.type}" if self.device.type == "cpu" else
                 f"{self.world} ranks on {torch.cuda.device_count()} card(s)")
        line = f"mesh dp={self.dp} x spatial={self.spatial}: {where}, backend {self.backend}"
        if self.backend == "gloo":
            line += ("; sums: the summands all-gathered (all_reduce) or all-to-all'd "
                     f"(reduce_scatter) and added on the "
                     f"{'card' if self.device.type == 'cuda' else 'CPU'} in rank order")
        if self.backend == "gloo" and self.device.type == "cuda":
            line += (f"; CUDA tensors: {' and '.join(GLOO_CUDA_DIRECT)} by gloo directly, "
                     "all_gather, all_to_all and send/recv staged through pinned host "
                     "buffers")
        return line

    # ---- raw collectives (no autograd) ------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    def _empty(self, shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
        if staged:
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(size(axis), *x.shape): every rank's ``x`` along ``axis``, in axis
        order, on ``x``'s device."""
        staged = self.staged("all_gather", x)
        src = self._host(x) if staged else x.contiguous()
        buf = self._empty((self.size(axis), *x.shape), x, staged)
        dist.all_gather(list(buf.unbind(0)), src, group=self.groups[axis])
        return buf.to(x.device)

    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over ``axis``: NCCL's all_reduce, or with gloo
        the gathered summands added on ``t``'s device."""
        if self.size(axis) == 1:
            return t
        if self.backend == "nccl":
            dist.all_reduce(t, group=self.groups[axis])
            return t
        return t.copy_(self._gather(t, axis).sum(0))

    def reduce_(self, tensors, axis: str, mean: bool = False) -> None:
        """Sum (or average) each tensor of ``tensors`` in place over ``axis``,
        in one all_reduce of their concatenation."""
        n = self.size(axis)
        tensors = list(tensors)
        if n == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_(flat, axis)
        if mean:
            flat /= n
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()

    def shift(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Along "spatial": rank j sends ``x`` to j + shift and receives from
        j - shift; zeros where there is no such rank (the volume's ends)."""
        n, j = self.spatial, self.spatial_index
        dst, src = j + shift, j - shift
        if n == 1:
            return torch.zeros_like(x)
        staged = self.staged("send/recv", x)
        send = self._host(x) if staged else x.contiguous()
        recv = self._empty(x.shape, x, staged)
        ops = []
        group = self.groups["spatial"]
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, send, self.ranks["spatial"][dst], group))
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, recv, self.ranks["spatial"][src], group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        if not 0 <= src < n:
            return torch.zeros_like(x)
        return recv.to(x.device) if staged else recv

    def all_gather_d(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Dl, ...) -> (B, spatial * Dl, ...): the D slabs of the row in
        spatial order."""
        n = self.spatial
        if n == 1:
            return x
        buf = self._gather(x, "spatial")
        return buf.transpose(0, 1).reshape(x.shape[0], n * x.shape[1], *x.shape[2:])

    def reduce_scatter_d(self, g: torch.Tensor) -> torch.Tensor:
        """(B, spatial * Dl, ...) -> (B, Dl, ...): the sum over the row of
        each rank's slab ``spatial_index``; `all_gather_d`'s transpose. NCCL
        reduce-scatters; with gloo each rank receives its slab from every
        rank (all_to_all) and adds them on ``g``'s device."""
        n = self.spatial
        if n == 1:
            return g
        b, dl = g.shape[0], g.shape[1] // n
        parts = g.reshape(b, n, dl, *g.shape[2:]).transpose(0, 1).contiguous()
        group = self.groups["spatial"]
        if self.backend == "nccl":
            out = torch.empty(parts.shape[1:], dtype=g.dtype, device=g.device)
            dist.reduce_scatter(out, list(parts.unbind(0)), group=group)
            return out
        staged = self.staged("all_to_all", g)
        send = self._host(parts) if staged else parts
        recv = self._empty(parts.shape, parts, staged)
        dist.all_to_all_single(recv, send, group=group)
        return recv.to(g.device).sum(0)


# ---- differentiable collectives --------------------------------------------


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone(), ctx.axis), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shift):
        ctx.mesh, ctx.shift = mesh, shift
        return mesh.shift(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift(g.contiguous(), -ctx.shift), None, None


class _AllGatherD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather_d(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter_d(g.contiguous()), None


def psum(x: torch.Tensor, mesh: Mesh, axis: str = "spatial") -> torch.Tensor:
    """``jax.lax.psum`` over ``axis``; its backward is psum too."""
    return _PSum.apply(x, mesh, axis) if mesh.size(axis) > 1 else x


def ppermute(x: torch.Tensor, mesh: Mesh, shift: int) -> torch.Tensor:
    """``jax.lax.ppermute`` along "spatial" by ``shift`` (no wrap: zeros
    arrive at the ends); its backward is the ppermute by ``-shift``."""
    return _PPermute.apply(x, mesh, shift)


def all_gather_d(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.all_gather(x, "spatial", axis=1, tiled=True)``; its backward
    is the reduce_scatter over D (``psum_scatter``)."""
    return _AllGatherD.apply(x, mesh) if mesh.spatial > 1 else x


# ---- placement ---------------------------------------------------------------


def shard_batch(mesh: Mesh | None, arrays):
    """This rank's part of each (B, D, H, W, C) array: rows [i·B/dp,
    (i+1)·B/dp) of data index i and, when spatial > 1, the D slab of its
    spatial index (JAX `batch_spec`). A batch that dp does not divide raises
    `ValueError`, as JAX's `shard_batch` (`jax.device_put`) does; so does a
    D that spatial does not divide."""
    if mesh is None:
        return tuple(arrays)
    out = []
    for a in arrays:
        b, d = a.shape[0], a.shape[1]
        if b % mesh.dp:
            raise ValueError(f"shard_batch: batch {b} is not divisible by dp={mesh.dp} "
                             "(JAX's shard_batch raises for it too)")
        if d % mesh.spatial:
            raise ValueError(f"shard_batch: D={d} is not divisible by spatial={mesh.spatial}")
        rows, dl = b // mesh.dp, d // mesh.spatial
        i, j = mesh.data_index, mesh.spatial_index
        out.append(a[i * rows:(i + 1) * rows, j * dl:(j + 1) * dl].contiguous())
    return tuple(out)


def replicate(mesh: Mesh | None, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter of ``module`` from rank 0 (JAX's
    `replicate`: the same parameters on every rank)."""
    if mesh is not None and mesh.world > 1:
        with torch.no_grad():
            for p in module.parameters():
                dist.broadcast(p.data, src=0)
    return module


# ---- process grid ------------------------------------------------------------


def rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or card rank mod the cards."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_mesh(dp: int, spatial: int, rank: int, init_method: str, device: str) -> Mesh:
    """Join the ``dp * spatial`` process group as ``rank`` and build the
    "data" and "spatial" groups (every rank creates every group, in one
    order)."""
    world = dp * spatial
    dev = rank_device(device, rank)
    shared = dev.type == "cuda" and torch.cuda.device_count() < world
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    groups, ranks = {}, {}
    for i in range(dp):  # rows: the spatial groups
        members = [i * spatial + j for j in range(spatial)]
        group = dist.new_group(members)
        if rank in members:
            groups["spatial"], ranks["spatial"] = group, members
    for j in range(spatial):  # columns: the data groups
        members = [i * spatial + j for i in range(dp)]
        group = dist.new_group(members)
        if rank in members:
            groups["data"], ranks["data"] = group, members
    return Mesh(dp, spatial, rank, dev, backend, groups, ranks)


def _rank_entry(rank, fn, dp, spatial, device, tmp, args, threads):
    if threads:
        torch.set_num_threads(threads)
    mesh = init_mesh(dp, spatial, rank, f"file://{os.path.join(tmp, 'store')}", device)
    try:
        if rank == 0:
            print(mesh.describe(), flush=True)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, dp: int, spatial: int = 1, device: str = "cpu", args=(),
              threads: int | None = None):
    """Spawn ``dp * spatial`` processes (`torch.multiprocessing.spawn`); rank
    r joins the grid (`init_mesh`, a ``file://`` store in a temporary
    directory) and returns ``fn(mesh, *args)``, which must be picklable.
    Returns the ranks' results in rank order. A rank that raises makes this
    raise (`torch.multiprocessing.ProcessRaisedException`, with its
    traceback). ``threads``: torch's CPU threads per rank."""
    tmp = tempfile.mkdtemp(prefix="smilecode_ranks_")
    try:
        mp.spawn(_rank_entry, args=(fn, dp, spatial, device, tmp, tuple(args), threads),
                 nprocs=dp * spatial, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(dp * spatial)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
