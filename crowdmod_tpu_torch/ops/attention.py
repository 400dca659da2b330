"""Multi-head attention primitives (port of ``crowdmod_tpu.ops.attention``).

Semantics follow ``torch.nn.MultiheadAttention(batch_first=True)``, the
reference's layer: packed QKV projection with bias, scaled dot-product,
optional attention-weight dropout, output projection with bias.  The module's
state_dict keys are that layer's (``in_proj_weight``, ``in_proj_bias``,
``out_proj.*``), so weights move to and from the reference layout unchanged.

With dropout off (always, at inference) attention runs through the fused
kernel wrapper :func:`~crowdmod_tpu_torch.ops.kernels.fused_attention`, as
the JAX package routes its Pallas kernel only when dropout is off.  With
dropout on (training), the attention weights' keep mask is drawn by the
caller (:meth:`MultiHeadAttention.keep_mask`, from an explicit generator)
and passed in.

Under tensor parallelism (:mod:`crowdmod_tpu_torch.parallel.tensor`)
:func:`dense` is column-parallel, and :class:`MultiHeadAttention` runs the
attention on the rank's heads when the model group divides them (its
q/k/v rows are whole heads), else on every head of the gathered q, k, v.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crowdmod_tpu_torch.ops.dropout import keep_mask
from crowdmod_tpu_torch.ops.kernels import fused_attention
from crowdmod_tpu_torch.parallel import tensor


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` with the f32 weights cast at use,
    as a flax ``Dense(dtype=...)`` does; column-parallel where the weight
    is cut over "model"."""
    def op(x, w, b):
        return F.linear(x.to(dtype), w.to(dtype), None if b is None else b.to(dtype))

    return tensor.column(layer, x, op)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    training: bool = False,
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention over ``(..., S, H, Dh)`` tensors.

    Logits and softmax in float32 whatever the input dtype; returns the
    input dtype.  With dropout on, ``keep`` is the weights' ``(..., H, Sq,
    Sk)`` keep mask."""
    dtype = q.dtype
    dh = q.shape[-1]
    scale = 1.0 / dh**0.5
    if not (dropout_rate > 0.0 and training):
        sq, h = q.shape[-3], q.shape[-2]
        sk = k.shape[-3]
        lead = q.shape[:-3]
        # (…, S, H, Dh) → (N, H, S, Dh) views; no copy on the kernel path.
        to_bhsd = lambda x, s: x.reshape((-1, s) + x.shape[-2:]).transpose(1, 2)
        out = fused_attention(
            to_bhsd(q, sq), to_bhsd(k, sk), to_bhsd(v, sk), scale=scale
        )
        return out.transpose(1, 2).reshape(lead + (sq, h, dh))
    # Dropout path (training only): plain torch.
    if keep is None:
        raise ValueError("attention dropout in training mode needs its keep mask")
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    weights = torch.softmax(logits * scale, dim=-1)
    weights = weights * keep / (1.0 - dropout_rate)
    out = torch.einsum(
        "...hqk,...khd->...qhd", weights.to(dtype).float(), v.float()
    )
    return out.to(dtype)


class MultiHeadAttention(nn.Module):
    """Torch-semantics MHA: packed QKV + output projection, both biased.

    Call with ``(q_input, kv_input)``; self-attention passes one array.  The
    DiT4D_V4 temporal stage passes future-slot queries against all-slot
    keys/values.  Computes in ``dtype`` (weights stay float32).
    """

    def __init__(
        self, dim: int, num_heads: int, *, dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(
                f"hidden dim {dim} not divisible by {num_heads} heads"
            )
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Xavier-uniform on each of the q/k/v/out projections (as the JAX
        package's four Dense layers), zero biases."""
        for w in self.in_proj_weight.data.chunk(3):
            nn.init.xavier_uniform_(w, generator=generator)
        nn.init.xavier_uniform_(self.out_proj.weight, generator=generator)
        nn.init.zeros_(self.in_proj_bias)
        nn.init.zeros_(self.out_proj.bias)

    def keep_mask(self, q_lead: tuple, sq: int, sk: int, generator) -> torch.Tensor | None:
        """The attention weights' keep mask for queries ``q_lead + (sq, D)``
        against ``sk`` keys, or None when dropout is off."""
        if not (self.training and self.dropout_rate > 0.0):
            return None
        shape = tuple(q_lead) + (self.num_heads, sq, sk)
        return keep_mask(shape, self.dropout_rate, generator, self.in_proj_bias.device)

    def forward(
        self, q_in: torch.Tensor, kv_in: torch.Tensor | None = None,
        keep: torch.Tensor | None = None,
    ) -> torch.Tensor:
        shard = tensor.shard_of(self, "in_proj_weight")
        if shard is not None:
            return self._forward_cut(shard, q_in, kv_in, keep)
        d = q_in.shape[-1]
        w = self.in_proj_weight.to(self.dtype)
        b = self.in_proj_bias.to(self.dtype)
        if kv_in is None:
            q, k, v = F.linear(q_in.to(self.dtype), w, b).chunk(3, dim=-1)
        else:
            q = F.linear(q_in.to(self.dtype), w[:d], b[:d])
            k, v = F.linear(kv_in.to(self.dtype), w[d:], b[d:]).chunk(2, dim=-1)
        split = lambda x: x.unflatten(-1, (self.num_heads, d // self.num_heads))
        out = dot_product_attention(
            split(q), split(k), split(v),
            dropout_rate=self.dropout_rate, training=self.training, keep=keep,
        )
        return dense(out.flatten(-2), self.out_proj, self.dtype)

    def _forward_cut(self, shard, q_in, kv_in, keep) -> torch.Tensor:
        """The forward with q, k and v cut over the model group: this rank
        holds rows ``shard.index[rank]`` of the packed projection, a block
        of each of q, k and v.  When the group divides the heads, those
        rows are whole heads and the attention runs on them alone, then the
        heads are gathered; else q, k and v are gathered first and every
        rank runs every head."""
        d, n, dt = q_in.shape[-1], shard.size, self.dtype
        dl = d // n
        w = self.in_proj_weight.to(dt)  # (3·d/n, d): this rank's q, k, v rows
        b = tensor.split(self.in_proj_bias, shard).to(dt)
        q_in = tensor.reduce_grad(q_in, shard).to(dt)
        if kv_in is None:
            q, k, v = F.linear(q_in, w, b).chunk(3, dim=-1)
        else:
            kv_in = tensor.reduce_grad(kv_in, shard).to(dt)
            q = F.linear(q_in, w[:dl], b[:dl])
            k, v = F.linear(kv_in, w[dl:], b[dl:]).chunk(2, dim=-1)
        heads, dh = self.num_heads, d // self.num_heads
        run = lambda q, k, v, h, keep: dot_product_attention(
            *(t.contiguous().unflatten(-1, (h, dh)) for t in (q, k, v)),
            dropout_rate=self.dropout_rate, training=self.training, keep=keep,
        ).flatten(-2)
        blocks = tensor.shard_of(self, "features")  # a contiguous block a rank
        if heads % n == 0:
            local = heads // n
            if keep is not None:
                keep = keep[..., shard.rank * local:(shard.rank + 1) * local, :, :]
            out = tensor.gather_features(run(q, k, v, local, keep), blocks)
        else:
            q, k, v = (tensor.gather_features(t, blocks) for t in (q, k, v))
            out = run(q, k, v, heads, keep)
        return dense(out, self.out_proj, dt)
