"""What a row slab needs to compute exactly its rows of the whole batch's
forward and gradients: the port's counterpart of what XLA's SPMD
partitioner inserts for the JAX package's ``spatial_sharding``
(``jspsr_tpu/parallel/mesh.py:89-92``).

One process per block of a ``Mesh2D`` (``parallel.mesh.make_2d_mesh``):
each rank runs the ordinary modules on its block of the batch, and under
``SpatialSharding.active()`` the few layers that need rows of their
neighbours take them from here:

- a conv (``nn.layers.Conv2d``, ``ConvTranspose2d``; ``conv2d``,
  ``conv_transpose2d`` below; JSPSR's fused stems and grouped blocks with
  their own ``groups``) pads its slab with its neighbours' rows (``halo``),
  as many above and below as its kernel, stride and padding reach (zeros
  at the image's top and bottom, what its padding gives), then convolves
  with no padding along H; a bf16 body's halos carry bf16;
- the global average and max pools (``nn.layers``; the channel
  attention) reduce over the space group (``all_gather``), a bf16 mean's
  sums in fp32, rounded once;
- train-mode BatchNorm takes its statistics over the whole mesh
  (``nn.layers.BatchNorm2d``), in fp32 for a bf16 body;
- the SPN head's deformable conv (``models/spn.py``; JSPSR, EDSR's head,
  LRRU's four rounds) samples the whole raw DEM of its images (its
  offsets are unbounded) for its own output rows (``gather_rows``, then
  the op's row origin ``y0``), in either sampling mode, and so does each
  of NLSPN's propagation steps (``models/nlspn.py``; CompletionFormer)
  with the whole feature, and its confidence taps with the whole
  confidence. ``gather_rows`` is differentiable: where the sampled image
  needs its gradient (NLSPN's feature; an SPN head whose DEM is not
  detached) the op's backward on the slab (K3 with the row origin) gives
  the whole image's gradient of the slab's rows, and the gather's
  backward sums those over the space group, in space order, into each
  rank's own rows;
- PVT's spatial-reduction attention (``models/pvt.py``) keeps its queries
  on the slab and attends over the whole image's keys and values: the
  reduced and normalised tokens (the tokens themselves at ``sr_ratio``
  1) gathered over the space group (``gather_tokens``: whole-width row
  blocks in space order are the whole grid's row-major order), its
  position embedding resized on the whole grid and cut to the slab's rows,
  and its drop-path masks those of the whole batch, the rows of this
  rank's data index (``parallel.mesh.global_rows``);
- every loss of the registry is this rank's share of the whole batch's
  loss (``losses``, ``ops/filters.py``): the means divide by the whole
  batch's count, the Grad loss's Sobel takes one halo row each side, TV one
  below and SSIM's 11 x 11 valid window ten below; BerHu's threshold is
  the mesh's max (``mesh_max``) and softmax CE's and balanced BCE's counts
  the mesh's (``mesh_sum``), so that the ranks' losses sum to the whole
  batch's loss and their summed gradients (``sharded_grads``) are its
  gradients.

A model's image rows must divide into equal slabs at every level of its
encoder: H by its ``ROW_MULTIPLE`` (JSPSR 8, three stride-2 stages; LRRU
16, four; CompletionFormer 32, five, and its first PVT stage's
spatial-reduction conv of 8 at H / 4; EDSR 1) times the space axis
(``check_rows``).

Why processes, and not one process with a list of devices: with a process
per block the ordinary modules run unchanged on a slab, and only those
layers gain a hook; in one process every op of the model would have to
dispatch over the blocks (a tensor subclass), as XLA's partitioner does
for the JAX package.

The exchanges use ``all_gather`` only (``torch.distributed``), forward and
backward, besides BatchNorm's differentiable all-reduces and the losses'
detached ones: gloo takes it on CPU and CUDA tensors, and so does NCCL.
gloo has no ``reduce_scatter``, and ``torch.distributed.nn``'s
``all_gather`` backward goes through ``all_to_all``, which gloo lacks too.

Recomputation (JSPSR's ``remat_stages``, ``nn.remat.checkpoint``) replays
a region's halo ``all_gather``s, pool gathers and BatchNorm all-reduces in
the backward. Every rank builds the same autograd graph (equal slabs; a
rank's own position enters only as data, e.g. ``replicate_halo1``'s edge
weights, or as the length of a slice, never as a branch around a
collective), and autograd runs a graph's nodes in one order, so every rank
issues the replayed collectives in one order; the replayed BatchNorm
updates no statistics (``remat.recomputing``).

Every model and option of the port runs under a sharding.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from jspsr_torch.parallel.mesh import (
    active_sharding,
    all_gather_list,
    all_reduce_grads,
)

class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` (equal shapes) stacked in rank order, with the
    gradient back to its owner: each rank's gradient of the stack is
    gathered, and each rank sums its own entry of them in rank order."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.group, ctx.rank = group, rank
        return torch.stack(all_gather_list(x, group))

    @staticmethod
    def backward(ctx, g):
        parts = all_gather_list(g, ctx.group)
        out = parts[0][ctx.rank]
        for p in parts[1:]:
            out = out + p[ctx.rank]
        return out, None, None


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """The space group's ``x`` stacked along a new first dim, in space
    order, differentiable."""
    m = active_sharding().mesh
    return _AllGather.apply(x, m.space_group, m.space_index)


class _Halo(torch.autograd.Function):
    """An NCHW slab with ``top`` rows of the slab above and ``bottom`` of
    the slab below (zeros beyond the image); each rank sends its first
    ``bottom`` and last ``top`` rows with one ``all_gather``. The backward
    returns each halo row's gradient to the rank that owns the row, the
    same way, and adds it into that rank's boundary rows."""

    @staticmethod
    def forward(ctx, x, top, bottom, group, rank, n):
        ctx.top, ctx.bottom, ctx.group, ctx.rank, ctx.n = (
            top, bottom, group, rank, n)
        h = x.shape[2]
        parts = all_gather_list(
            torch.cat([x[:, :, :bottom], x[:, :, h - top:]], 2), group)
        b, c, _, w = x.shape
        above = (parts[rank - 1][:, :, bottom:] if rank > 0
                 else x.new_zeros(b, c, top, w))
        below = (parts[rank + 1][:, :, :bottom] if rank < n - 1
                 else x.new_zeros(b, c, bottom, w))
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, rank, n = ctx.top, ctx.bottom, ctx.rank, ctx.n
        h = g.shape[2] - top - bottom
        parts = all_gather_list(
            torch.cat([g[:, :, :top], g[:, :, top + h:]], 2), ctx.group)
        dx = g[:, :, top:top + h].clone()
        if rank < n - 1:  # the slab below's top halo: my last rows
            dx[:, :, h - top:] += parts[rank + 1][:, :, :top]
        if rank > 0:  # the slab above's bottom halo: my first rows
            dx[:, :, :bottom] += parts[rank - 1][:, :, top:]
        return dx, None, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """This rank's NCHW slab ``x`` with ``top`` rows of the slab above and
    ``bottom`` rows of the slab below it on the space axis, zeros beyond
    the image's first and last rows; differentiable. A halo that reaches
    past the neighbouring slabs (a 7 x 7 conv on slabs of 1 or 2 rows,
    CompletionFormer's deepest levels) is cut from the whole images
    (``gather_rows``), padded with zeros: the slabs' heights, not their
    places, choose the path, so every rank issues the same
    collectives."""
    if top == 0 and bottom == 0:
        return x
    m = active_sharding().mesh
    hs = x.shape[2]
    if max(top, bottom) > hs:
        whole = F.pad(gather_rows(x), (0, 0, top, bottom))
        first = m.space_index * hs
        return whole[:, :, first:first + top + hs + bottom]
    return _Halo.apply(x, top, bottom, m.space_group, m.space_index,
                       m.n_space)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole images of this rank's batch rows from the space group's
    NCHW slabs, on every rank of the group; differentiable: every rank's
    gradient of the whole images is summed over the space group, in space
    order, and each rank keeps its own rows (``_AllGather``'s backward)."""
    return torch.cat(all_gather(x).unbind(0), dim=2)


def gather_tokens(t: torch.Tensor) -> torch.Tensor:
    """The whole grid's (B, N, C) tokens from the space group's slabs'
    tokens (each slab's row-major (h, w) grid of whole-width rows), in
    space order: the whole grid's row-major order; differentiable, as
    ``gather_rows``."""
    return torch.cat(all_gather(t).unbind(0), dim=1)


def row_origin(x: torch.Tensor) -> int:
    """The image row of this rank's first row of the NCHW slab ``x`` (slabs
    are equal at every level)."""
    return active_sharding().mesh.space_index * x.shape[2]


def conv2d(conv, x: torch.Tensor, weight, bias,
           groups: int | None = None) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d``; ``weight`` in ``groups`` groups,
    ``conv.groups`` by default) on this rank's slab: the slab with the
    halo its kernel reaches, ``padding`` rows above and ``k_eff - stride -
    padding`` below, convolved without padding along H: output row j of space index r's slab is output row
    ``r * Hs / stride + j`` of the image's. The image's output rows must
    be ``H / stride`` (the model's convs)."""
    k = conv.dilation[0] * (conv.kernel_size[0] - 1) + 1
    s, p = conv.stride[0], conv.padding[0]
    hs = x.shape[2]
    n = active_sharding().mesh.n_space
    if hs % s or (hs * n + 2 * p - k) // s + 1 != hs * n // s:
        raise NotImplementedError(
            f"spatial sharding of a conv whose output rows are not H / "
            f"stride (kernel {conv.kernel_size}, stride {conv.stride}, "
            f"padding {conv.padding}) on slabs of {hs} rows")
    xp = halo(x, p, max(0, k - s - p))
    return F.conv2d(xp, weight, bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups if groups is None else groups)


def conv_transpose2d(conv, x: torch.Tensor, weight, bias) -> torch.Tensor:
    """``conv`` (an ``nn.ConvTranspose2d`` whose output has ``stride x H``
    rows: ``kernel + output_padding - 2 padding = stride``) on this rank's
    slab: the input rows that reach its output rows, ``(k - 1 - p) //
    stride`` above and ``(p - 1) // stride + 1`` below (the last slab's
    extra row is the zero beyond the image, where ``output_padding``
    puts its extra output row), transposed without padding along H, then
    cropped to the slab's ``stride x Hs`` output rows."""
    k, s = conv.kernel_size[0], conv.stride[0]
    p, op = conv.padding[0], conv.output_padding[0]
    if k + op - 2 * p != s:
        raise NotImplementedError(
            f"spatial sharding of a transposed conv whose output rows are "
            f"not stride x H (kernel {k}, stride {s}, padding {p}, "
            f"output_padding {op})")
    top, bottom = max(0, (k - 1 - p) // s), max(0, (p - 1) // s + 1)
    hs = x.shape[2]
    y = F.conv_transpose2d(halo(x, top, bottom), weight, bias, conv.stride,
                           (0, conv.padding[1]), (0, conv.output_padding[1]),
                           conv.groups, conv.dilation)
    return y[:, :, top * s + p:top * s + p + s * hs]


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """The mean over the whole images' H and W of NCHW slabs: each rank's
    sums, gathered over the space group and summed in space order, over
    the images' pixel count. A bf16 slab's sums are fp32 and the mean is
    rounded to bf16 once, as the one-process mean of a bf16 tensor is."""
    n = active_sharding().mesh.n_space
    xs = x.float() if x.dtype == torch.bfloat16 else x
    sums = all_gather(xs.sum(dim=(2, 3), keepdim=True)).sum(0)
    return (sums / (x.shape[2] * n * x.shape[3])).to(x.dtype)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """The max over the whole images' H and W of NCHW slabs: each rank's
    maxima gathered (differentiably: the gradient reaches the rank that
    holds the maximum), then their max."""
    return all_gather(x.amax(dim=(2, 3), keepdim=True)).amax(0)


def mean(t: torch.Tensor) -> torch.Tensor:
    """This rank's share of the whole batch's mean of ``t``: its sum over
    the mesh's whole count (every block holds ``t.numel()`` entries)."""
    return t.sum() / (t.numel() * active_sharding().mesh.world)


def mesh_max(t: torch.Tensor) -> torch.Tensor:
    """The largest entry of ``t`` over the whole mesh, detached (BerHu's
    threshold)."""
    m = t.detach().amax()
    dist.all_reduce(m, op=dist.ReduceOp.MAX,
                    group=active_sharding().mesh.group)
    return m


def mesh_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the whole mesh, detached (the losses'
    counts)."""
    s = t.detach().sum()
    dist.all_reduce(s, group=active_sharding().mesh.group)
    return s


def last_slab() -> bool:
    """Whether this rank's slab holds the images' last rows."""
    m = active_sharding().mesh
    return m.space_index == m.n_space - 1


def whole_shape(x: torch.Tensor) -> tuple:
    """(B, C, H, W) of the whole batch whose block is the NCHW ``x``."""
    m = active_sharding().mesh
    b, c, h, w = x.shape
    return b * m.n_data, c, h * m.n_space, w


def world() -> int:
    """The mesh's rank count: the blocks of the whole batch."""
    return active_sharding().mesh.world


def replicate_halo1(x: torch.Tensor) -> torch.Tensor:
    """``ops.filters.replicate_pad1`` of the whole images, on this rank's
    slab: one halo row above and below from the neighbours, the image's
    own edge row at its top and bottom, then the edge columns."""
    m = active_sharding().mesh
    xp = halo(x, 1, 1)
    # the same autograd graph on every rank (a rank's backward runs its
    # collectives in its graph's order): the edge rows picked by weights
    # of exactly 0 and 1
    first = float(m.space_index == 0)
    last = float(m.space_index == m.n_space - 1)
    xp = torch.cat([xp[:, :, :1] * (1 - first) + x[:, :, :1] * first,
                    xp[:, :, 1:-1],
                    xp[:, :, -1:] * (1 - last) + x[:, :, -1:] * last], dim=2)
    return torch.cat([xp[..., :1], xp, xp[..., -1:]], dim=-1)


def check_rows(model, inputs: list, sharding) -> None:
    """Refuse whole NCHW ``inputs`` whose H does not divide by ``model``'s
    ``ROW_MULTIPLE`` times the space axis: every slab must start on a row
    that each stride-2 level of the model keeps."""
    mult = model.ROW_MULTIPLE
    n = sharding.mesh.n_space
    for x in inputs:
        if x.shape[2] % (mult * n):
            raise ValueError(
                f"{type(model).__name__}: H = {x.shape[2]} does not divide "
                f"by {mult} x {n} (its row multiple x the space axis): "
                f"every slab must start on a row that each of its stride-2 "
                f"levels keeps")


def sharded_forward(model, inputs: list, sharding) -> torch.Tensor:
    """``model`` on this rank's blocks of the whole NCHW ``inputs`` under
    ``sharding``, the output gathered whole on every rank."""
    check_rows(model, inputs, sharding)
    with sharding.active():
        y = model([sharding.shard(x) for x in inputs])
    return sharding.gather(y)


def sharded_grads(model, criterion, inputs: list, gt, sharding,
                  generator: torch.Generator | None = None) -> tuple:
    """The whole batch's loss and parameter gradients from this rank's
    blocks of the whole NCHW ``inputs`` and ``gt``: the forward and the
    loss under ``sharding`` (each rank's loss is its share of the whole
    batch's), ``backward``, then the gradients summed over the mesh
    (``all_reduce_grads(average=False)``), in place in ``.grad``.
    ``generator``, where given, goes to the model's forward (PVT's
    drop-path masks: every rank seeds it alike and draws the whole
    batch's). Returns ({loss name: the whole batch's value}, {parameter
    name: gradient})."""
    check_rows(model, inputs, sharding)
    model.zero_grad(set_to_none=True)
    kw = {} if generator is None else {"generator": generator}
    with sharding.active():
        pred = model([sharding.shard(x) for x in inputs], **kw)
        losses = criterion(pred, sharding.shard(gt))
        losses["Total"].backward()
    named = [(k, q) for k, q in model.named_parameters()
             if q.grad is not None]
    group = sharding.mesh.group
    all_reduce_grads([q for _, q in named], group, average=False)
    names = sorted(losses)
    totals = torch.stack([losses[k].detach().float() for k in names])
    dist.all_reduce(totals, group=group)
    return ({k: float(v) for k, v in zip(names, totals)},
            {k: q.grad for k, q in named})
