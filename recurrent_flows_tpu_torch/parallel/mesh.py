"""A (data x model) process grid with frame height sharded over 'model',
the counterpart of ``recurrent_flows_tpu.parallel.mesh``.

The JAX package puts a 2-D device mesh ('data', 'model') under its train
step: the batch is sharded over 'data', frame height (axis 2 of [B, T, H,
W, C]) over 'model' (``spatial_constraint``), and GSPMD inserts the conv
halo exchanges, the gathers around what it cannot partition and the
reductions. The port runs one process per grid point: rank r sits at data
index r // n_model and model index r % n_model, holds its slice of the
global batch and, of every frame, the rows [m·H/n, (m+1)·H/n). The
layers ask :func:`grid` whether a sharded step is running and then

- pad a 3x3 conv's rows with its neighbours' (:meth:`Mesh.halo`, zero
  rows at the frame's real edges), and a stride-2 conv's with one row on
  top; a k4 s2 transposed conv takes one row each side;
- pool, squeeze, unsqueeze and upsample their own rows, which is exact
  while the local height is even;
- gather rows over 'model' (:meth:`Mesh.gather`) where the local height
  is odd in front of an op that halves it, in front of a 'VALID' conv or a
  flatten into a dense net, and around the ``glowstep``/``glowchain``
  kernels (which compute their two 3x3 convs inside one launch), then
  compute replicated;
- keep their own rows again (:meth:`Mesh.reshard`) where an op's output
  is at a height that divides over 'model'.

So whether a map is sharded is a function of its height alone: a map of
global height r is sharded exactly when n_model divides r, and a sharded
map has r/n_model rows of a width of r·W/H, where W/H is the frame's
(:meth:`Mesh.sharded`, from the frame shape ``spatial_constraint`` saw).

The gradient convention (every collective's backward keeps to it):

- each rank's objective is its share of its data slice's loss: a sum over
  a sharded map is the sum over its own rows, one over a replicated map
  or a vector counts 1/n_model (:meth:`Mesh.share`); summed over 'model'
  and averaged over 'data' the shares are the one-process loss;
- the gradient a rank holds for a sharded tensor is that of its own
  rows; for a replicated tensor it is this rank's part, and the parts sum
  over 'model' to the gradient. So a gather's backward sums the parts
  over 'model' and keeps its own rows (:class:`_GatherRows`), a halo's
  sends each halo row's gradient to its owner (:class:`_Halo`), a
  reduction's sums the parts (:class:`_ModelSum`, :func:`batch_mean`);
- the parameters' gradients are summed over 'model' and averaged over
  'data' (:meth:`Mesh.reduce_grads_`), and so are the reported metrics.

The noise of a sharded step: every rank draws the global shape from one
shared stream (or from the replayed draws of a test) and keeps its batch
slice and its rows (:meth:`Mesh.noise`), so a sharded step takes the
one-process step's draws.

Transport: the default group's backend, NCCL where each rank has its own
card, gloo on the CPU and for ranks that share one card. Under gloo a
CUDA tensor is staged through host memory for every collective; the
computation stays on the card. A failed collective raises.

``DataParallel`` (``parallel/data_parallel.py``, ``--multigpu``) is the
``n_model = 1`` grid. Nothing here touches a process group or CUDA on
import.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

_GRID = None  # the Mesh whose train step is running, or None

EXCHANGES = ("halo", "halo_grad", "gather", "gather_grad", "reduce", "reduce_grad")


def grid():
    """The running step's Mesh when it shards rows (n_model > 1), else None."""
    return _GRID if _GRID is not None and _GRID.n_model > 1 else None


def _to_card(host: torch.Tensor) -> torch.Tensor:
    """``host`` in pinned memory, so that its copy to the card is
    asynchronous (PyTorch's caching host allocator keeps the buffer until
    the copy has run)."""
    return host.pin_memory()


def own_rows(x):
    """On a grid, ``Mesh.reshard(x)``: a replicated map's own rows where
    its height divides over 'model'; x as it is elsewhere."""
    g = grid()
    return x if g is None else g.reshard(x)


def _rows(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) of a map: axis -3 ([..., H, W, C])."""
    return x.narrow(x.dim() - 3, start, stop - start)


class Mesh:
    """One rank's place in a (data x model) grid over the default process
    group, the groups of its axes and the collectives of a step. Made by
    :func:`make_mesh` (``DataParallel`` is the n_model=1 case).

    ``counts`` holds the exchanges since the last ``reset_counts`` (halo
    and gather forward, their backward as ``*_grad``; 'reduce' the
    reductions of batch statistics over rows), ``exchange_s`` the host
    seconds spent in them, staging included."""

    def __init__(self, device, rank: int, world: int, n_model: int = 1,
                 owns_group: bool = False, groups=None):
        if n_model < 1 or world % n_model:
            raise ValueError(f"a grid of {world} ranks has no model axis of {n_model}")
        self.device = torch.device(device)
        self.rank, self.world, self.n_model = rank, world, n_model
        self.n_data = world // n_model
        self.data_index, self.model_index = divmod(rank, n_model)
        self.owns_group = owns_group  # made by ``initialize``; ``close`` ends it
        data_group, model_group = groups if groups is not None else (None, None)
        # (group, size) per axis; None is the default group
        self._axes = {"world": (None, world), "data": (data_group, self.n_data),
                      "model": (model_group, n_model)}
        self.frame = None  # (H, W) of the frames of the running step
        self.reset_counts()

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def reset_counts(self) -> None:
        self.counts = dict.fromkeys(EXCHANGES, 0)
        self.exchange_s = 0.0

    # -- transport ----------------------------------------------------------

    def _all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` (contiguous) in place over ``axis``'s ranks."""
        group, size = self._axes[axis]
        if size == 1:
            return t
        if t.is_cuda and dist.get_backend() == "gloo":
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(_to_card(host), non_blocking=True)
        else:
            dist.all_reduce(t, group=group)
        return t

    def _broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda and dist.get_backend() == "gloo":
            host = t.cpu()
            dist.broadcast(host, 0)
            t.copy_(host)
        else:
            dist.broadcast(t, 0)
        return t

    def _gather_model(self, t: torch.Tensor, pick=lambda parts: torch.cat(parts, -3)):
        """``pick`` of every model rank's ``t`` (of one shape, in model
        order; by default their rows stacked), on ``t``'s device. Under gloo
        the parts arrive in host memory, and only what ``pick`` returns
        goes back to the card, in one copy that the host does not wait
        for."""
        src = t.contiguous()
        staged = src.is_cuda and dist.get_backend() == "gloo"
        if staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.n_model)]
        dist.all_gather(parts, src, group=self._axes["model"][0])
        out = pick(parts)
        return _to_card(out).to(t.device, non_blocking=True) if staged else out

    def _timed(self, kind: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.exchange_s += time.perf_counter() - t0
        self.counts[kind] += 1
        return out

    # -- the batch ----------------------------------------------------------

    def local(self, batch):
        """This rank's slice (along axis 0) of a global batch: the slice of
        its data index."""
        n = batch.shape[0]
        if n % self.n_data:
            raise ValueError(f"a global batch of {n} does not split over {self.n_data} "
                             "data ranks")
        per = n // self.n_data
        return batch[self.data_index * per:(self.data_index + 1) * per]

    def scatter(self, batch):
        """Rank 0's global ``batch`` (a tensor or array; None when its data
        ran out) sent to every rank: this rank's slice, float32 on its
        device, or None on every rank. The other ranks pass None."""
        shape = [None if batch is None else tuple(batch.shape)]
        dist.broadcast_object_list(shape, 0)
        if shape[0] is None:
            return None
        if self.primary:
            t = torch.as_tensor(batch, dtype=torch.float32, device=self.device).contiguous()
        else:
            t = torch.empty(shape[0], dtype=torch.float32, device=self.device)
        self._broadcast_(t)
        return self.local(t)

    def _flat(self, tensors, reduce: bool):
        """One collective per dtype over the flattened ``tensors``: an
        all-reduce over the grid summed over 'model' and averaged over
        'data', or a broadcast from rank 0; written back in place."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = _flatten_dense_tensors(ts)
            if reduce:
                self._all_reduce_(flat, "world")
                flat /= self.n_data
            else:
                self._broadcast_(flat)
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)

    @torch.no_grad()
    def broadcast_(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        self._flat([t.data for t in list(module.parameters()) + list(module.buffers())],
                   reduce=False)

    @torch.no_grad()
    def reduce_grads_(self, tensors) -> None:
        """Each tensor (a rank's part of a gradient) replaced in place by
        the gradient: summed over 'model', averaged over 'data' (for
        ``n_model = 1`` the mean over the ranks)."""
        self._flat(list(tensors), reduce=True)

    def reduce_metrics(self, metrics: dict) -> dict:
        """Per-rank shares of scalars summed over 'model' and averaged over
        'data' (one all-reduce)."""
        keys = list(metrics)
        stacked = torch.stack([metrics[k] for k in keys])
        self._flat([stacked], reduce=True)
        return dict(zip(keys, stacked.unbind()))

    # -- the running step ---------------------------------------------------

    @contextlib.contextmanager
    def active(self):
        """Within this block the layers shard rows over this grid and
        ``batch_mean`` takes the grid's statistics."""
        global _GRID
        before, _GRID = _GRID, self
        try:
            yield
        finally:
            _GRID = before

    def noise(self, noise):
        """``noise`` as a sharded step takes it: the global draw sliced to
        this rank (identity for ``n_model = 1``, whose ranks draw their own
        slices from streams of their own)."""
        return noise if self.n_model == 1 else _GridNoise(noise, self)

    # -- maps ---------------------------------------------------------------

    def _aspect(self, x) -> tuple:
        """(H·W_frame, W·H_frame) of a map: equal where x keeps the frame's
        aspect whole."""
        fh, fw = self.frame
        return x.shape[-3] * fw, x.shape[-2] * fh

    def sharded(self, x) -> bool:
        """x is a map [..., H, W, C] holding this rank's rows."""
        if x.dim() < 4 or self.frame is None:
            return False
        rows, width = self._aspect(x)
        return rows * self.n_model == width

    def replicated_map(self, x) -> bool:
        """x is a map holding all rows of its frame."""
        if x.dim() < 4 or self.frame is None:
            return False
        rows, width = self._aspect(x)
        return rows == width

    def global_shape(self, x) -> tuple:
        """The shape of the whole map of which x holds rows."""
        if not self.sharded(x):
            return tuple(x.shape)
        shape = list(x.shape)
        shape[-3] *= self.n_model
        return tuple(shape)

    def reshard(self, x):
        """A replicated map at a height that divides over 'model': its own
        rows (its gradient is zero elsewhere); anything else as it is."""
        if self.replicated_map(x) and x.shape[-3] % self.n_model == 0:
            h = x.shape[-3] // self.n_model
            return _rows(x, self.model_index * h, (self.model_index + 1) * h)
        return x

    def gather(self, x):
        """A sharded map's whole frame on every model rank (replicated
        from here on); anything else as it is."""
        return _GatherRows.apply(x, self) if self.sharded(x) else x

    def halo(self, x, top: int, bottom: int):
        """x [..., h, W, C] (own rows) with ``top`` rows of the rank above
        and ``bottom`` of the rank below, zeros past the frame's edges."""
        if x.shape[-3] < max(top, bottom):
            raise ValueError(f"halo: {x.shape[-3]} rows cannot give {max(top, bottom)}")
        return _Halo.apply(x, top, bottom, self)

    def model_sum(self, x):
        """The sum over 'model' of each rank's x, on every model rank."""
        return _ModelSum.apply(x, self)

    def share(self, value, x):
        """``value``, a sum over x's elements, as this rank's share of the
        sum over the whole map: itself where x is sharded, 1/n_model of it
        where x is replicated (a replicated map or a vector)."""
        return value if self.sharded(x) else value / self.n_model

    def rows_of(self, t, axis: int):
        """Own rows of a parameter indexed by frame row along ``axis``."""
        h = t.shape[axis] // self.n_model
        return t.narrow(axis, self.model_index * h, h)

    def close(self) -> None:
        """End the default group where ``initialize`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


class _Halo(torch.autograd.Function):
    """x with its neighbours' edge rows (one all-gather of every rank's
    edges over 'model'); backward sends each halo row's gradient to its
    owner, which adds it to the rows it came from."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh):
        ctx.top, ctx.bottom, ctx.mesh = top, bottom, mesh
        h = x.shape[-3]
        m, n = mesh.model_index, mesh.n_model

        def halos(parts):  # the rank above's last rows, the rank below's first
            zero = torch.zeros_like(parts[0])
            above = parts[m - 1] if m > 0 else zero
            below = parts[m + 1] if m < n - 1 else zero
            return torch.cat([_rows(above, bottom, bottom + top), _rows(below, 0, bottom)], -3)

        edges = torch.cat([_rows(x, 0, bottom), _rows(x, h - top, h)], -3)
        got = mesh._timed("halo", mesh._gather_model, edges, halos)
        return torch.cat([_rows(got, 0, top), x, _rows(got, top, top + bottom)], -3)

    @staticmethod
    def backward(ctx, g):
        top, bottom, mesh = ctx.top, ctx.bottom, ctx.mesh
        rows = g.shape[-3]
        h = rows - top - bottom
        m, n = mesh.model_index, mesh.n_model

        def owed(parts):  # halo gradients of my rows: first rows', last rows'
            zero = torch.zeros_like(parts[0])
            above = parts[m - 1] if m > 0 else zero  # it padded its bottom with my first rows
            below = parts[m + 1] if m < n - 1 else zero  # its top with my last rows
            return torch.cat([_rows(above, top, top + bottom), _rows(below, 0, top)], -3)

        sent = torch.cat([_rows(g, 0, top), _rows(g, rows - bottom, rows)], -3)
        got = mesh._timed("halo_grad", mesh._gather_model, sent, owed)
        grad = _rows(g, top, top + h).clone()
        _rows(grad, 0, bottom).add_(_rows(got, 0, bottom))
        _rows(grad, h - top, h).add_(_rows(got, bottom, bottom + top))
        return grad, None, None, None


class _GatherRows(torch.autograd.Function):
    """All-gather of rows over 'model'; backward sums the parts over
    'model' and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh._timed("gather", mesh._gather_model, x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        mesh._timed("gather_grad", mesh._all_reduce_, g, "model")
        h = g.shape[-3] // mesh.n_model
        return _rows(g, mesh.model_index * h, (mesh.model_index + 1) * h), None


class _ModelSum(torch.autograd.Function):
    """The sum over 'model'; backward sums the gradient's parts."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone(memory_format=torch.contiguous_format)
        return mesh._timed("reduce", mesh._all_reduce_, y, "model")

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh._timed("reduce_grad", ctx.mesh._all_reduce_, g, "model"), None


class _AllReduceMean(torch.autograd.Function):
    """The mean over an axis's ranks of a tensor; its gradient is the mean
    over those ranks of the incoming gradients (the adjoint of the same
    map under the convention above)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        y = x.clone(memory_format=torch.contiguous_format)
        mesh._all_reduce_(y, axis)
        return y / mesh._axes[axis][1]

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        ctx.mesh._all_reduce_(g, ctx.axis)
        return g / ctx.mesh._axes[ctx.axis][1], None, None


def batch_mean(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dims)`` over the whole of what the running step holds:
    axis 0 is the batch, spread over 'data'; on a sharded map the height
    axis is spread over 'model'. The mean of the ranks' means (the ranks
    hold slices of one size)."""
    m = x.mean(dims, keepdim=keepdim)
    if _GRID is None:
        return m
    dims = [dims] if isinstance(dims, int) else [d % x.dim() for d in dims]
    over_batch = 0 in dims and _GRID.n_data > 1
    over_rows = (_GRID.n_model > 1 and _GRID.sharded(x) and x.dim() - 3 in dims)
    if over_batch and over_rows:
        _GRID.counts["reduce"] += 1
        return _AllReduceMean.apply(m, _GRID, "world")
    if over_batch:
        return _AllReduceMean.apply(m, _GRID, "data")
    if over_rows:
        _GRID.counts["reduce"] += 1
        return _AllReduceMean.apply(m, _GRID, "model")
    return m


class _GridNoise:
    """A ``NoiseSource`` as a sharded step takes it: each draw of the
    global shape, from the wrapped source, cut to this rank's batch slice
    and rows. Draws are [B, ...] or time-major [T, B, z] and [T, B, H, W,
    C] (the overshooting's), so the batch axis is 1 where the draw has 3
    or 5 axes; a map's rows are sharded where ``like``'s are."""

    def __init__(self, inner, mesh: Mesh):
        self.inner, self.mesh = inner, mesh

    def _global(self, like):
        shape = list(self.mesh.global_shape(like))
        axis = 1 if like.dim() in (3, 5) else 0
        shape[axis] *= self.mesh.n_data
        return torch.empty(shape, dtype=like.dtype, device=like.device), axis

    def _own(self, draw, like, axis):
        mesh = self.mesh
        b = like.shape[axis]
        draw = draw.narrow(axis, mesh.data_index * b, b)
        if mesh.sharded(like):
            h = like.shape[-3]
            draw = _rows(draw, mesh.model_index * h, (mesh.model_index + 1) * h)
        return draw

    def normal(self, like):
        big, axis = self._global(like)
        return self._own(self.inner.normal(big), like, axis)

    def uniform(self, like, low, high):
        big, axis = self._global(like)
        return self._own(self.inner.uniform(big, low, high), like, axis)


def make_mesh(n_data: int | None = None, n_model: int = 1, device="cuda") -> Mesh:
    """The (n_data x n_model) grid over the default process group (which
    must exist: ``torch.distributed.init_process_group`` or
    ``parallel.initialize``), on this rank's ``device`` (``cuda`` means the
    current card). Every rank calls it, in the same order: it makes the
    axes' groups with ``dist.new_group``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call "
                           "torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} grid needs {n_data * n_model} ranks, "
                         f"the group has {world}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    data_group = model_group = None
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
        if n_data > 1:
            for m in range(n_model):
                g = dist.new_group([d * n_model + m for d in range(n_data)])
                if m == rank % n_model:
                    data_group = g
    return Mesh(device, rank, world, n_model, groups=(data_group, model_group))


def spatial_constraint(mesh, x):
    """Frames [B, T, H, W, C] (this rank's batch slice) cut to this rank's
    rows [m·H/n, (m+1)·H/n) of every frame, the frame's shape noted in the
    mesh. The identity where the grid has no model axis or x fewer than 4
    axes, as in JAX. Raises ValueError where n_model does not divide H."""
    if mesh is None or mesh.n_model <= 1 or x.dim() < 4:
        return x
    h, w = x.shape[-3], x.shape[-2]
    if h % mesh.n_model:
        raise ValueError(f"spatial_constraint: frames of shape {tuple(x.shape)} have "
                         f"{h} rows, which do not split over n_model={mesh.n_model}")
    mesh.frame = (h, w)
    per = h // mesh.n_model
    return _rows(x, mesh.model_index * per, (mesh.model_index + 1) * per)
