"""Parameter sharding on the ("data", "model") mesh (port of the JAX
package's ``parallel/sharding.py``).

:func:`param_spec` and :func:`fsdp_spec` are the JAX package's rules, from
a parameter's shape in flax's layout (last dim = output features) to a
placement: a tuple naming the mesh axis of each dim, ``()`` to replicate.
The port keeps the reference torch layout (Linear ``(out, in)``, Conv3d
``(O, I, kh, kw, kl)``), so :func:`flax_layouts` maps each parameter to its
flax shape and back, as ``compat/jax_params.py`` carries weights, and
:func:`placements` answers in torch dims.

:func:`shard_params` puts a model on the mesh: ``"tp"`` (at model size 1,
replication) wraps it in ``DistributedDataParallel``; ``"fsdp"`` shards it
with FSDP2's ``fully_shard``, a unit a block, each parameter on the dim
:func:`fsdp_spec` names.  Where JAX replicates (a tensor under
``min_size``, or no dim divisible by the data axis) FSDP2 still shards, on
dim 0: a layout difference, not a numerical one.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from crowdmod_tpu_torch.parallel.mesh import TP_NOT_PORTED, data_size

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


def placements(model: nn.Module, data: int, min_size: int = MIN_SIZE) -> dict[str, int | None]:
    """Each parameter's torch dim that :func:`fsdp_spec` puts on "data"
    (the "model" axis has size 1), or None where it replicates."""
    out = {}
    for name, layout in flax_layouts(model).items():
        spec = fsdp_spec(layout.shape, data, min_size)
        out[name] = layout.dims[spec.index("data")] if "data" in spec else None
    return out


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

    ``mode="tp"`` — replicate (the "model" axis has size 1): a
    ``DistributedDataParallel`` over ``model``, which stays the bare module
    that sampling, checkpoints and the EMA read.
    ``mode="fsdp"`` — shard ``model`` in place with ``fully_shard`` over
    the data axis (its parameters become ``DTensor`` shards): a unit a
    block, then the root; returns ``model``.  Its kernel-layout weight packs
    are rebuilt every forward: FSDP refills the unsharded parameters in
    place and keeps their version counters, so a cache keyed on them could
    serve a pack from before the last optimizer step.
    """
    if mesh["model"].size() > 1:
        raise NotImplementedError(TP_NOT_PORTED.format(mesh["model"].size()))
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
    if mode != "fsdp":
        raise ValueError(f"unknown param-sharding mode {mode!r}; expected 'tp' or 'fsdp'")
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dims = placements(model, data_size(mesh), min_size)
    by_param = {p: dims[name] for name, p in model.named_parameters()}

    def place(p):
        d = by_param.get(p)
        return None if d is None else Shard(d)  # None: FSDP2's Shard(0)

    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh["data"], shard_placement_fn=place)
    fully_shard(model, mesh=mesh["data"], shard_placement_fn=place)
    for m in model.modules():
        if hasattr(m, "cache_packs"):
            m.cache_packs = False
    return model
