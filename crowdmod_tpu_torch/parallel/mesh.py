"""The ("data", "model") device mesh (port of the JAX package's
``parallel/mesh.py``).

A ``torch.distributed`` mesh is over processes, one card each: the "data"
axis is the data-parallel one (DDP or FSDP), the "model" axis the
tensor-parallel one (:mod:`~crowdmod_tpu_torch.parallel.tensor`).  "model"
is the inner axis: ranks ``d·M … d·M + M − 1`` form data index d's model
group, as the JAX package's ``reshape(data, model)`` lays out its devices.
In-process serving over a host's cards takes :func:`local_devices`
instead: one replica a card, in one process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from crowdmod_tpu_torch.parallel import multiprocess


def make_mesh(data: int | None = None, model: int = 1, *, device_type: str | None = None):
    """A ``DeviceMesh`` of shape ``(data, model)`` named ("data", "model")
    over the process group (:func:`multiprocess.initialize` first).
    ``data=None`` puts every other process on the data axis; ``device_type``
    defaults to the group's ("cuda" under NCCL)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not multiprocess.active():
        raise RuntimeError("make_mesh needs a process group: call "
                           "crowdmod_tpu_torch.parallel.multiprocess.initialize() first")
    world = multiprocess.process_count()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} processes")
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes; "
                         f"the group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def mesh_shape(cfg, model_override: int | None = None) -> tuple[int | None, int]:
    """(data, model) of the config's ``TPU.MESH`` node: ``DATA = -1`` (the
    default) gives data None, every other process on the data axis;
    ``MODEL`` (or ``model_override``, a ``--model-parallel`` flag, which
    wins) is the tensor-parallel size."""
    model = int(model_override if model_override is not None
                else cfg.get_path("TPU.MESH.MODEL", 1))
    data = int(cfg.get_path("TPU.MESH.DATA", -1))
    return (None if data <= 0 else data), max(model, 1)


def mesh_from_config(cfg, model_override: int | None = None, *,
                     device_type: str | None = None):
    """The mesh of the config's ``TPU.MESH`` node (:func:`mesh_shape`)."""
    data, model = mesh_shape(cfg, model_override)
    return make_mesh(data=data, model=model, device_type=device_type)


def data_size(mesh) -> int:
    return mesh["data"].size()


def model_size(mesh) -> int:
    return mesh["model"].size()


def shard_batch(batch, mesh):
    """This process's rows of a global ``batch`` on the mesh's data axis:
    the data index's share; the ranks of one model group take the same
    rows.  The JAX package's API, kept for its callers (the trainer cuts
    its rows with ``multiprocess.global_batch`` on its mesh)."""
    return multiprocess.global_batch(batch, mesh)


def replicate(tree, mesh):
    """Make every tensor of ``tree`` (nested dicts, lists, tuples) equal to
    its data-axis group's first process's, in place (a broadcast over
    ``mesh["data"]``: model index m's tensors come from position (0, m), so
    model shards do not mix); → ``tree``.  The JAX package's API, kept for
    its callers (DDP and FSDP broadcast the model's state themselves)."""
    group = mesh["data"].get_group()
    src = dist.get_global_rank(group, 0)

    def put(x):
        if isinstance(x, torch.Tensor) and mesh["data"].size() > 1:
            dist.broadcast(x, src, group=group)
        return x

    return multiprocess._tree_map(put, tree)


def local_devices(device) -> tuple[torch.device, ...]:
    """The replicas of in-process data parallelism: every card of this host
    for a CUDA ``device``, the CPU itself for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (device,)
