"""Parameter sharding on the ("data", "model") mesh (port of the JAX
package's ``parallel/sharding.py``).

:func:`param_spec` and :func:`fsdp_spec` are the JAX package's rules, from
a parameter's shape in flax's layout (last dim = output features) to a
placement: a tuple naming the mesh axis of each dim, ``()`` to replicate.
The port keeps the reference torch layout (Linear ``(out, in)``, Conv3d
``(O, I, kh, kw, kl)``), so :func:`flax_layouts` maps each parameter to its
flax shape and back, as ``compat/jax_params.py`` carries weights, and
:func:`placements` (the "data" axis) and :func:`model_cuts` (the "model"
axis) answer in torch dims.

:func:`shard_params` puts a model on the mesh.  With a "model" axis over
more than one process it first cuts each parameter that :func:`param_spec`
puts there to this rank's output features (:func:`cut_model`; the layers
then compute column-parallel, :mod:`~crowdmod_tpu_torch.parallel.tensor`).
Then ``"tp"`` wraps the model in ``DistributedDataParallel`` over the data
axis; ``"fsdp"`` shards it over the data axis with FSDP2's ``fully_shard``,
a unit a block, each parameter on the dim :func:`fsdp_spec` names.  Where
JAX replicates (a tensor under ``min_size``, or no dim divisible by the
data axis) FSDP2 still shards, on dim 0: a layout difference, not a
numerical one; so is its cut of the packed attention bias (q, k and v end
to end) into contiguous blocks where JAX cuts each of q, k and v.  Apart
from those, rank (d, m) holds the entries JAX's ``NamedSharding`` puts on
mesh position (d, m).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from crowdmod_tpu_torch.parallel import tensor
from crowdmod_tpu_torch.parallel.mesh import data_size, model_size

MIN_SIZE = 1 << 12


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def param_spec(shape, model_size: int, min_size: int) -> tuple:
    """The tensor-parallel rule for a flax-layout ``shape``: the last
    (output-feature) dim over "model" when the tensor is large and the dim
    divides; else replicated, ``()``."""
    shape = tuple(shape)
    if model_size > 1 and len(shape) >= 2 and shape[-1] % model_size == 0 \
            and _size(shape) >= min_size:
        return (None,) * (len(shape) - 1) + ("model",)
    return ()


def fsdp_spec(shape, data_size: int, min_size: int, model_size: int = 1) -> tuple:
    """The FSDP (ZeRO-3) rule for a flax-layout ``shape``: the last dim may
    go to "model" as in :func:`param_spec`, then the largest remaining dim
    divisible by the data axis goes to "data"; small or indivisible tensors
    are replicated, ``()``."""
    shape = tuple(shape)
    entries: list = [None] * len(shape)
    if model_size > 1 and len(shape) >= 2 and shape[-1] % model_size == 0 \
            and _size(shape) >= min_size:
        entries[-1] = "model"
    if data_size > 1 and _size(shape) >= min_size:
        candidates = [i for i in range(len(shape))
                      if entries[i] is None and shape[i] % data_size == 0]
        if candidates:
            entries[max(candidates, key=lambda i: shape[i])] = "data"
    if all(e is None for e in entries):
        return ()
    return tuple(entries)


@dataclass(frozen=True)
class FlaxLayout:
    """A parameter in flax's layout: ``dims[j]`` is the torch dim of flax
    dim ``j``; ``shape`` is the flax leaf's shape (for the packed attention
    projection, one of its q/k/v leaves)."""

    dims: tuple[int, ...]
    shape: tuple[int, ...]


# torch dim of each flax dim, by the reference layout (compat/jax_params.py).
_LINEAR = (1, 0)               # (out, in) → (in, out)
_CONV3D_TIME_LAST = (4, 2, 3, 1, 0)   # UNet (O, I, kh, kw, kl) → (kl, kh, kw, I, O)
_CONV3D_TIME_FIRST = (2, 3, 4, 1, 0)  # DiT patch (D, C, pt, p, p) → (pt, p, p, C, D)
_CONV2D = (2, 3, 1, 0)         # (O, I, kh, kw) → (kh, kw, I, O)
_CONV_T2D = (2, 3, 0, 1)       # (I, O, kh, kw) → (kh, kw, I, O)


def flax_layouts(model: nn.Module) -> dict[str, FlaxLayout]:
    """Every parameter of ``model`` (by its state_dict name) in flax's
    layout.  The GRU's reset and update gates are one flax conv of twice
    the outputs; each is mapped as the Conv2d it is here."""
    from crowdmod_tpu_torch.models.backbones.dit import PatchEmbed4D
    from crowdmod_tpu_torch.ops.attention import MultiHeadAttention
    from crowdmod_tpu_torch.ops.conv3d import Conv3DSame

    out: dict[str, FlaxLayout] = {}
    patch_convs = {id(m.proj) for m in model.modules() if isinstance(m, PatchEmbed4D)}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            shape = tuple(p.shape)
            dims = tuple(range(p.ndim))
            if isinstance(mod, MultiHeadAttention):  # q, k, v packed on dim 0
                third = (shape[0] // 3,) + shape[1:]
                dims = _LINEAR if p.ndim == 2 else dims
                out[name] = FlaxLayout(dims, tuple(third[d] for d in dims))
                continue
            if p_name == "weight":
                if isinstance(mod, nn.Linear):
                    dims = _LINEAR
                elif isinstance(mod, (Conv3DSame, nn.Conv3d)):
                    dims = _CONV3D_TIME_FIRST if id(mod) in patch_convs else _CONV3D_TIME_LAST
                elif isinstance(mod, nn.ConvTranspose2d):
                    dims = _CONV_T2D
                elif isinstance(mod, nn.Conv2d):
                    dims = _CONV2D
            out[name] = FlaxLayout(dims, tuple(shape[d] for d in dims))
    return out


def _rule_shapes(model: nn.Module) -> dict[str, tuple]:
    """The flax leaf shape JAX's rules see for each parameter: its own, but
    for the GRU's reset and update gates, which are the halves of one flax
    conv of twice the outputs."""
    from crowdmod_tpu_torch.models.convrnn.cells import ConvGRUCell

    shapes = {name: layout.shape for name, layout in flax_layouts(model).items()}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, ConvGRUCell):
            for gate in ("reset_gate", "update_gate"):
                name = f"{mod_name}.{gate}.weight" if mod_name else f"{gate}.weight"
                shape = shapes[name]
                shapes[name] = shape[:-1] + (2 * shape[-1],)
    return shapes


def placements(model: nn.Module, data: int, min_size: int = MIN_SIZE,
               model_axis: int = 1) -> dict[str, int | None]:
    """Each parameter's torch dim that :func:`fsdp_spec` puts on "data"
    (after a "model" axis of size ``model_axis`` took its dim), or None
    where it replicates."""
    layouts, shapes = flax_layouts(model), _rule_shapes(model)
    out = {}
    for name, layout in layouts.items():
        spec = fsdp_spec(shapes[name], data, min_size, model_axis)
        out[name] = layout.dims[spec.index("data")] if "data" in spec else None
    return out


def model_cuts(model: nn.Module, size: int, min_size: int = MIN_SIZE) -> dict[str, tuple]:
    """The parameters :func:`param_spec` puts on a "model" axis of
    ``size``: name → (torch dim, each rank's entries along it).  A rank's
    entries are those of its block of the flax leaf's output features: for
    the packed attention projection a block of each of q, k and v; for the
    DiT final layer flax's feature order (pt, p, p, C) mapped to the
    reference's (pt, C, p, p); for the GRU's gates the part of the fused
    [reset | update] block that falls in each."""
    from crowdmod_tpu_torch.compat.jax_params import _tube_perm
    from crowdmod_tpu_torch.models.backbones.dit import DiT4DTube
    from crowdmod_tpu_torch.models.convrnn.cells import ConvGRUCell
    from crowdmod_tpu_torch.ops.attention import MultiHeadAttention

    if size <= 1:
        return {}
    layouts, shapes = flax_layouts(model), _rule_shapes(model)
    owner = {f"{m}.{p}" if m else p: (mod, m) for m, mod in model.named_modules()
             for p, _ in mod.named_parameters(recurse=False)}
    final_perm = None
    if hasattr(model, "final_layer") and not isinstance(model, DiT4DTube):
        c, p, pt = model.out_channels, model.patch_size, model.t_patch_size
        final_perm = torch.from_numpy(_tube_perm(pt, p, c).astype("int64"))
    cells = {m: mod for m, mod in model.named_modules() if isinstance(mod, ConvGRUCell)}
    out = {}
    for name, layout in layouts.items():
        if param_spec(shapes[name], size, min_size) == ():
            continue
        mod, mod_name = owner[name]
        dim, n = layout.dims[-1], shapes[name][-1]
        index = tensor.blocks(n, size)
        if isinstance(mod, MultiHeadAttention):
            index = tuple(torch.cat([b + k * n for k in range(3)]) for b in index)
        elif final_perm is not None and mod is getattr(model, "final_layer").linear:
            index = tuple(final_perm[b] for b in index)
        elif mod_name.rsplit(".", 1)[0] in cells and mod_name.endswith(("reset_gate", "update_gate")):
            half = n // 2
            lo = 0 if mod_name.endswith("reset_gate") else half
            index = tuple(b[(b >= lo) & (b < lo + half)] - lo for b in index)
        out[name] = (dim, index)
    return out


def cut_model(model: nn.Module, size: int, rank: int, group=None,
              min_size: int = MIN_SIZE) -> nn.Module:
    """Cut ``model``'s parameters in place to rank ``rank``'s entries of
    :func:`model_cuts` over a model group of ``size`` (``group``: its
    process group, a group of threads (see
    :class:`~crowdmod_tpu_torch.parallel.tensor.ModelShard`), or None to
    slice only), recording each cut on its module; → ``model``.
    Beside its parameters' cuts, an attention records the cut of its
    output features (``"features"``, a block a rank) and a GRU cell that of
    its fused gate conv's outputs (``"gates"``).  New parameter objects:
    make the optimizer afterwards.  A block of the fused resblock gathers
    its weights at use, so it packs them every forward."""
    from crowdmod_tpu_torch.models.backbones.unet3d import ResnetBlock3D
    from crowdmod_tpu_torch.models.convrnn.cells import ConvGRUCell
    from crowdmod_tpu_torch.ops.attention import MultiHeadAttention

    cuts = model_cuts(model, size, min_size)
    modules = dict(model.named_modules())
    for name, (dim, index) in cuts.items():
        mod_name, _, p_name = name.rpartition(".")
        mod = modules[mod_name]
        shard = tensor.ModelShard(dim, rank, index, group)
        p = getattr(mod, p_name)
        with torch.no_grad():
            local = tensor.local_slice(p.detach(), shard).contiguous()
        setattr(mod, p_name, nn.Parameter(local, requires_grad=p.requires_grad))
        mod.model_shards = {**getattr(mod, "model_shards", {}), p_name: shard}
    for mod_name, mod in modules.items():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, ConvGRUCell) and f"{prefix}reset_gate.weight" in cuts:
            n = 2 * mod.reset_gate.out_channels
            mod.model_shards = {"gates": tensor.ModelShard(0, rank, tensor.blocks(n, size),
                                                           group)}
        if isinstance(mod, MultiHeadAttention) and f"{prefix}in_proj_weight" in cuts:
            d = mod.in_proj_weight.shape[1]
            mod.model_shards = {**mod.model_shards,
                                "features": tensor.ModelShard(0, rank, tensor.blocks(d, size),
                                                              group)}
        if isinstance(mod, ResnetBlock3D) and any(n.startswith(prefix) for n in cuts):
            mod.cache_packs = False  # the fused resblock's gathered weights
    return model


# The module lists whose blocks the backbones call as modules (FSDP gathers a
# unit's parameters in its forward hook): the UNet's and the DiT's.  The
# rest (embeddings, the ConvRNN's cells, whose convs the forecaster applies
# through their weights) stays in the root unit.
BLOCK_LISTS = ("encoder_blocks", "bottleneck_blocks", "decoder_blocks", "blocks")


def fsdp_units(model: nn.Module) -> list[nn.Module]:
    """The FSDP units below the root: the blocks of :data:`BLOCK_LISTS`."""
    return [blk for name in BLOCK_LISTS for blk in getattr(model, name, ())]


def shard_params(model: nn.Module, mesh, mode: str = "tp", min_size: int = MIN_SIZE):
    """Put ``model`` (on this process's device) on ``mesh`` → the module
    that training calls.

    A "model" axis over more than one process first cuts the model to this
    rank's slices (:func:`cut_model`, over ``mesh["model"]``'s group: rank
    ``d·M + m`` is mesh position (d, m), as JAX's ``reshape(data, model)``).
    ``mode="tp"`` — a ``DistributedDataParallel`` over ``model`` on the
    data axis; ``model`` stays the bare module that sampling, checkpoints
    and the EMA read.
    ``mode="fsdp"`` — shard ``model`` in place with ``fully_shard`` over
    the data axis (its parameters become ``DTensor`` shards of the model
    slices): a unit a block, then the root; returns ``model``.  Its
    kernel-layout weight packs are rebuilt every forward: FSDP refills the
    unsharded parameters in place and keeps their version counters, so a
    cache keyed on them could serve a pack from before the last optimizer
    step.
    """
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"unknown param-sharding mode {mode!r}; expected 'tp' or 'fsdp'")
    m = model_size(mesh)
    # The data axis's dims, from the whole shapes JAX's rules see.
    dims = placements(model, data_size(mesh), min_size, m) if mode == "fsdp" else {}
    if m > 1:
        cut_model(model, m, mesh["model"].get_local_rank(), mesh["model"].get_group(),
                  min_size)
    if mode == "tp":
        from torch.nn.parallel import DistributedDataParallel

        device = next(model.parameters()).device
        # Every parameter gets a gradient each step (no unused path at any
        # config), so no find_unused_parameters; the backbones hold no
        # buffers for DDP to broadcast.
        return DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=mesh["data"].get_group(),
        )
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    by_param = {p: dims[name] for name, p in model.named_parameters()}
    # A parameter the model axis left empty on this rank (a GRU gate whose
    # outputs all lie on other ranks) holds nothing to shard, and FSDP2's
    # collectives refuse it: it stays a plain parameter.
    empty = {p for p in model.parameters() if p.numel() == 0}

    def place(p):
        d = by_param.get(p)
        return None if d is None else Shard(d)  # None: FSDP2's Shard(0)

    for unit in [*fsdp_units(model), model]:
        fully_shard(unit, mesh=mesh["data"], shard_placement_fn=place,
                    ignored_params=empty & set(unit.parameters()) or None)
    for mod in model.modules():
        if hasattr(mod, "cache_packs"):
            mod.cache_packs = False
    return model
