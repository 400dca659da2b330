#!/usr/bin/env python
"""Forward-diffusion sanity visualization with the PyTorch port
(``crowdmod_tpu_torch``): q(x_t | x_0) of one macroprop sequence at a
ladder of timesteps, drawn so the noising schedule can be eyeballed —
density should fade into isotropic noise as t → T.

The noised states are drawn on the device (``core.schedule.q_sample``, the
step-t noise from a generator seeded ``--seed`` + t); the drawing stays on
the host.  The JAX tool's flags and figure, plus ``--device``.

Usage::

    python tools/visualize_forward_torch.py --config-yml-file configs/4test/ATC.yml \
        --timesteps 0 100 250 500 750 999 --out forward_process.png
    python tools/visualize_forward_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def forward_states(sched, x0, timesteps, noise) -> dict:
    """x_t of ``x0`` ``(1, F, H, W, C)`` at each of ``timesteps``, with the
    noise ``noise(t)`` → ``{t: x_t}`` on x0's device."""
    import torch

    from crowdmod_tpu_torch.core.schedule import q_sample

    return {t: q_sample(sched, x0, torch.tensor([t], device=x0.device), noise(t))[0]
            for t in timesteps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-yml-file", default="configs/4test/ATC.yml")
    p.add_argument("--configList-yml-file", default=None)
    p.add_argument("--timesteps", nargs="*", type=int,
                   default=[0, 100, 250, 500, 750, 999])
    p.add_argument("--out", default="forward_process.png")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", action="store_true",
                   help="Use the synthetic walker field instead of pickles.")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    import torch

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.core.schedule import linear_schedule
    from crowdmod_tpu_torch.train.trainer import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    h, w = cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS
    f = cfg.DATASET.FUTURE_LEN

    if args.synthetic or args.configList_yml_file is None:
        from crowdmod_tpu_torch.data.synthetic import synthetic_walkers

        seq = torch.from_numpy(synthetic_walkers(1, h, w, f)[0])  # (F, H, W, 3)
    else:
        from crowdmod_tpu_torch.data.ingest import get_test_dataset

        ds = get_test_dataset(cfg, 3, seed=args.seed, device="cpu")
        _, future = ds.gather(np.arange(1))
        seq = torch.as_tensor(future[0])

    sched = linear_schedule(cfg.MODEL.DDPM.TIMESTEPS, scale=cfg.MODEL.DDPM.SCALE)
    x0 = seq.to(device=device, dtype=torch.float32)[None]  # (1, F, H, W, C)
    ts = [t for t in args.timesteps if t < sched.timesteps]

    def noise(t):
        gen = torch.Generator(device=device).manual_seed(args.seed + t)
        return torch.randn(x0.shape, generator=gen, device=device)

    states = forward_states(sched, x0, ts, noise)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(
        1, len(ts), figsize=(2.2 * len(ts), 2.6), facecolor="white",
        squeeze=False,
    )
    for ax, t in zip(axes[0], ts):
        ax.matshow(states[t].cpu().numpy()[0, 0, ..., 0], cmap=plt.cm.Blues)
        ax.set_title(f"t={t}", fontsize=9)
        ax.axis("off")
    fig.suptitle("Forward process q(x_t | x_0), density channel")
    fig.tight_layout()
    fig.savefig(args.out, dpi=150, bbox_inches="tight")
    print(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
