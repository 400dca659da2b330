"""Sliding-window dataset over macroproperty sequences (port of the JAX
package's ``data/windows.py``: ``window_indices`` and ``WindowDataset``'s
batch loop).

A ``(N, T_raw, H, W, C)`` native-layout tensor is viewed as all windows of
length ``past_len + future_len`` starting every ``stride`` frames.  The raw
tensor stays where the caller put it (on the card for training), and a
batch is one index into it, ``raw[seq_idx, t_idx + arange(window)]``: no
host↔device copy of the data in the epoch loop.  Shuffling uses numpy's
``default_rng(seed).shuffle``, as the JAX package does, so both packages
see the same batches in the same order.  The JAX package's whole-epoch
``epoch_arrays`` (its ``lax.scan`` epoch) is a TPU feature and is not
ported; its CPU path is this batch loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


def window_indices(
    num_seqs: int, total_len: int, window_len: int, stride: int
) -> np.ndarray:
    """``(num_windows, 2)`` array of (sequence index, start frame) pairs."""
    starts = np.arange(0, total_len - window_len + 1, stride)
    seqs = np.arange(num_seqs)
    grid = np.stack(np.meshgrid(seqs, starts, indexing="ij"), axis=-1)
    return grid.reshape(-1, 2)


@dataclass
class WindowDataset:
    """Batched past/future windows over raw sequences, gathered where the
    raw tensor lives."""

    raw: torch.Tensor  # (N, T_raw, H, W, C)
    past_len: int
    future_len: int
    stride: int

    def __post_init__(self):
        self.raw = torch.as_tensor(self.raw)
        n, t_raw = self.raw.shape[0], self.raw.shape[1]
        window = self.past_len + self.future_len
        self.indices = window_indices(n, t_raw, window, self.stride)
        self._offsets = torch.arange(window, device=self.raw.device)

    def __len__(self) -> int:
        return len(self.indices)

    def gather(self, idx) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather windows for flat window ids ``idx`` → (past, future)."""
        sel = torch.as_tensor(self.indices[np.asarray(idx)], device=self.raw.device)
        frames = sel[:, 1:] + self._offsets  # (B, window)
        win = self.raw[sel[:, :1], frames]  # (B, window, H, W, C)
        return win[:, :self.past_len], win[:, self.past_len:]

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """One epoch of (past, future) batches (the reference DataLoader's
        shuffle and drop_last defaults)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        n_full = len(order) // batch_size
        end = n_full * batch_size
        for i in range(0, end, batch_size):
            yield self.gather(order[i:i + batch_size])
        if not drop_last and end < len(order):
            yield self.gather(order[end:])
