"""Tensor parallelism over the mesh's "model" axis (the JAX package leaves
it to XLA's partitioner: ``parallel/sharding.py`` annotates, XLA splits the
ops and gathers the operands of a Pallas call).

A parameter that :func:`~crowdmod_tpu_torch.parallel.sharding.param_spec`
puts on "model" is held as this rank's slice of its output-feature dim, a
plain tensor: the module that owns it records a :class:`ModelShard` under
``module.model_shards[name]``.  Plain tensors, not ``DTensor``: DDP refuses
``DTensor`` parameters, and the hand-written kernels take plain tensors.
The layers then compute column-parallel (:func:`column`): the same
operation as unsharded (the same kernel, or the same library call) on the
rank's output features, gathered along the feature dim.  Where an op cannot
split (the fused resblock, whose GroupNorm needs every channel; a position
embedding), the weight is gathered at use (:func:`whole`).

The gradient rules, each an autograd function over the model group:

* :func:`gather_features` — forward all-gather on a dim, backward the local
  slice of the output gradient;
* :func:`reduce_grad` — forward identity, backward all-reduce (sum): the
  input of a column-parallel layer gets every rank's part of its gradient;
* :func:`gather_weight` — forward all-gather of a sharded weight, backward
  the local slice, not a sum: every rank already holds the whole gradient;
* :func:`split` — a replicated tensor's rank slice at use (a bias beside a
  sharded weight), backward the all-gather of the ranks' slices.

A shard's entries need not be a contiguous block: ``ModelShard.index``
names the full tensor's entries along ``dim`` that each rank holds, in the
order JAX's placement gives them (q, k and v of a packed projection each
cut alike; the DiT final layer's features in flax's order; the GRU's reset
and update gates as the halves of JAX's one fused gate conv).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist


@dataclass(frozen=True, eq=False)
class ModelShard:
    """Where a parameter is cut over the model group: along torch ``dim``,
    rank ``k`` holding the entries ``index[k]`` of the full tensor (a
    ``LongTensor`` on the CPU, in that rank's order); ``rank`` is this
    process's; ``group`` a process group, None (slicing only, no
    collective), or any object whose ``all_gather(x, rank)`` returns every
    rank's ``x`` by rank (ranks run as threads of one process, which holds
    the cut modules against the whole one on one card: NCCL refuses two
    ranks on one card)."""

    dim: int
    rank: int
    index: tuple
    group: Any = None

    def __post_init__(self):
        cat = torch.cat(self.index)
        # The permutation from the ranks' entries laid end to end back to
        # the full order, or None where they already are in it; each rank's
        # (start, length) where its entries are one ascending run, else None.
        order = None if torch.equal(cat, torch.arange(len(cat))) else torch.argsort(cat)
        spans = tuple((int(i[0]), len(i)) if len(i) and torch.equal(
            i, torch.arange(int(i[0]), int(i[0]) + len(i))) else None for i in self.index)
        object.__setattr__(self, "order", order)
        object.__setattr__(self, "spans", spans)
        object.__setattr__(self, "_on", {})  # index tensors by device

    def on(self, key, device) -> torch.Tensor:
        """``index[key]`` (or ``order`` for key "order") on ``device``,
        copied there once."""
        if (key, device) not in self._on:
            t = self.order if key == "order" else self.index[key]
            self._on[key, device] = t.to(device)
        return self._on[key, device]

    @property
    def size(self) -> int:
        return len(self.index)

    @property
    def full(self) -> int:
        return sum(len(i) for i in self.index)

    def __deepcopy__(self, memo):  # a process group does not copy
        return self


def blocks(n: int, size: int) -> tuple:
    """The even contiguous cut of ``n`` entries over ``size`` ranks."""
    if n % size:
        raise ValueError(f"{n} entries do not split over {size} ranks")
    return tuple(torch.arange(n).chunk(size))


def local_slice(t: torch.Tensor, shard: ModelShard, dim: int | None = None,
                rank: int | None = None) -> torch.Tensor:
    """Rank ``rank`` (default: the shard's) of the full tensor ``t`` along
    ``dim`` (default: the shard's); a copy."""
    dim = shard.dim if dim is None else dim
    rank = shard.rank if rank is None else rank
    span = shard.spans[rank]
    if span is not None:
        return t.narrow(dim, *span).clone()
    return t.index_select(dim, shard.on(rank, t.device))


def assemble(parts: list, shard: ModelShard, dim: int | None = None) -> torch.Tensor:
    """The full tensor from every rank's slice (``parts[k]`` is rank k's)."""
    dim = shard.dim if dim is None else dim
    out = torch.cat(parts, dim)
    return out if shard.order is None else out.index_select(dim, shard.on("order", out.device))


def shard_of(module, name: str = "weight") -> ModelShard | None:
    return getattr(module, "model_shards", {}).get(name)


def model_shards(model) -> dict:
    """Every sharded parameter of ``model`` by its state_dict name."""
    out = {}
    for mod_name, mod in model.named_modules():
        for name, shard in getattr(mod, "model_shards", {}).items():
            out[f"{mod_name}.{name}" if mod_name else name] = shard
    return out


# ---------------------------------------------------------------------------
# Collectives over the model group
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, shard: ModelShard) -> list:
    """Every rank's ``x`` (equal shapes), by rank."""
    x = x.contiguous()
    if shard.group is None:
        raise RuntimeError("a model-sharded layer ran without its model group")
    if hasattr(shard.group, "all_gather"):  # ranks as threads, not a process group
        return shard.group.all_gather(x, shard.rank)
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x, group=shard.group)
    return parts


def _all_reduce(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The sum of every rank's ``x``, the same on every rank."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=shard.group)
    return out


def _gather_uneven(x: torch.Tensor, shard: ModelShard, dim: int) -> list:
    """Every rank's slice along ``dim``, whose lengths are the shard's
    (a rank may hold none: the GRU's gates at two ranks)."""
    lengths = [len(i) for i in shard.index]
    top = max(lengths)
    pad = list(x.shape)
    pad[dim] = top - x.shape[dim]
    padded = torch.cat([x, x.new_zeros(pad)], dim) if pad[dim] else x
    return [p.narrow(dim, 0, n) for p, n in zip(_all_gather(padded, shard), lengths)]


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return assemble(_all_gather(x, shard), shard, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.shard, ctx.dim), None, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.shard), None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return assemble(_gather_uneven(w, shard, dim), shard, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.shard, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return local_slice(t, shard, dim)

    @staticmethod
    def backward(ctx, g):
        return assemble(_gather_uneven(g, ctx.shard, ctx.dim), ctx.shard, ctx.dim), None, None


def gather_features(y: torch.Tensor, shard: ModelShard, dim: int = -1) -> torch.Tensor:
    """The ranks' output features ``y`` (rank k's are ``shard.index[k]``)
    laid out whole along ``dim``; backward, the local slice."""
    return _GatherFeatures.apply(y, shard, dim % y.ndim)


def reduce_grad(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` itself; backward, its gradient summed over the model group."""
    return _ReduceGrad.apply(x, shard)


def gather_weight(w: torch.Tensor, shard: ModelShard, dim: int | None = None) -> torch.Tensor:
    """The whole of a sharded ``w``; backward, the local slice (no sum)."""
    return _GatherWeight.apply(w, shard, shard.dim if dim is None else dim)


def split(t: torch.Tensor, shard: ModelShard, dim: int = 0) -> torch.Tensor:
    """This rank's entries of a replicated ``t`` along ``dim``; backward,
    every rank's slice of the gradient gathered whole."""
    return _Split.apply(t, shard, dim)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def whole(module, name: str) -> torch.Tensor:
    """``module.<name>`` whole: gathered at use where it is sharded."""
    p = getattr(module, name)
    shard = shard_of(module, name)
    return p if shard is None else gather_weight(p, shard)


def column(module, x: torch.Tensor, op: Callable, *, dim: int = -1,
           shard: ModelShard | None = None, weight=None, bias=None) -> torch.Tensor:
    """``op(x, weight, bias)`` over ``module``'s ``weight`` and ``bias``,
    whose output features lie on ``dim``: unsharded, the op itself; with
    the weight on "model", the op on this rank's features (its weight
    slice, its entries of the bias) gathered along ``dim``, the input's
    gradient summed over the model group.  ``shard``, ``weight`` and
    ``bias`` override the module's (a fused view of several convs)."""
    shard = shard if shard is not None else shard_of(module, "weight")
    weight = module.weight if weight is None else weight
    bias = getattr(module, "bias", None) if bias is None else bias
    if shard is None:
        return op(x, weight, bias)
    bias = None if bias is None else split(bias, shard, 0)
    return gather_features(op(reduce_grad(x, shard), weight, bias), shard, dim)


def uncut_agree(model) -> bool:
    """True when every parameter of ``model`` that the model axis leaves
    whole is bitwise the same on each rank of this rank's model group (its
    local shard under FSDP); a collective over the group.  True where
    nothing is cut."""
    import hashlib

    shards = model_shards(model)
    if not shards:
        return True
    shard = next(iter(shards.values()))
    digest = hashlib.sha256()
    for name, p in model.named_parameters():
        if name not in shards:
            local = p.to_local() if hasattr(p, "to_local") else p
            digest.update(local.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    seen = [None] * shard.size
    dist.all_gather_object(seen, digest.hexdigest(), group=shard.group)
    return len(set(seen)) == 1
