#!/usr/bin/env python
"""Library quickstart of the PyTorch port: the whole framework in ~90
lines, no CLI.

Trains a small DDPM on the synthetic walker dataset, samples futures three
ways (ancestral / DDIM / DPM-Solver), scores them on the device, and renders
a prediction GIF — the same flow a production user composes from the
library.

    python examples/quickstart_torch.py                 # on the GPU
    python examples/quickstart_torch.py --device cpu    # anywhere
"""

import argparse
import logging
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from crowdmod_tpu_torch.config import load_config  # noqa: E402
from crowdmod_tpu_torch.core.schedule import ddim_tau_schedule  # noqa: E402
from crowdmod_tpu_torch.data.synthetic import synthetic_walkers  # noqa: E402
from crowdmod_tpu_torch.data.windows import WindowDataset  # noqa: E402
from crowdmod_tpu_torch.metrics import functional as F  # noqa: E402
from crowdmod_tpu_torch.models.diffusion import ddim_sample, dpm_solver_sample  # noqa: E402
from crowdmod_tpu_torch.train.trainer import Trainer  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--timesteps", type=int, default=100)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "qs"))
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    # 1. Config: the YAML schema is the reference project's — override what
    #    you need as a plain dict.
    cfg = load_config("4test/ATC.yml").updated({
        "DATA_FS": {"SAVE_DIR": os.path.join(args.out, "ckpts"),
                    "OUTPUT_DIR": os.path.join(args.out, "out")},
        "DATASET": {"BATCH_SIZE": 16},
        "MACROPROPS": {"ROWS": 8, "COLS": 12},   # small grid → fast anywhere
        "MODEL": {"DDPM": {"TIMESTEPS": args.timesteps,
                           "UNET": {"BASE_CH": 16, "BASE_CH_MULT": [1, 2],
                                    "APPLY_ATTENTION": [False, False],
                                    "TRAIN": {"EPOCHS": 8}}}},
    })

    # 2. Data: any (N, T, H, W, C) array becomes a device-resident windowed
    #    dataset.  Real pipelines use crowdmod_tpu_torch.data.ingest / etl.
    trainer = Trainer(cfg, "DDPM-UNet", device=args.device,
                      run_dir=os.path.join(args.out, "run"))
    walkers = synthetic_walkers(64, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 16)
    ds = WindowDataset(torch.from_numpy(walkers).to(trainer.device),
                       past_len=5, future_len=3, stride=4)

    # 3. Train: one Trainer for DDPM / FM / ConvRNN.
    history = trainer.fit(ds, epochs=args.epochs)
    print(f"final loss: {history['train_loss'][-1]:.4f}")

    # 4. Sample three ways.  trainer.sample uses the configured sampler;
    #    the sampler functions are also usable directly.
    past, future = ds.gather(np.arange(8))
    shape = (8, 3, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    denoise = trainer._denoise_fn()

    def gen():
        return torch.Generator(device=trainer.device).manual_seed(0)

    with torch.no_grad():
        ancestral = trainer.sample(past, gen())
        ddim = ddim_sample(denoise, trainer.sched, past, shape,
                           ddim_tau_schedule(args.timesteps, 10), generator=gen())
        fast = dpm_solver_sample(denoise, trainer.sched, past, shape, steps=15,
                                 generator=gen())

    # 5. Score on the device.
    ranges = F.channel_ranges(future)
    for name, pred in [("ancestral", ancestral), ("ddim/10", ddim),
                       ("dpm-solver/15", fast)]:
        psnr = float(F.psnr_over_time(pred, future, ranges)[..., 0].mean())
        print(f"{name:>14}: density PSNR {psnr:6.2f} dB "
              f"({pred.shape[0]} samples)")

    # 6. Render one prediction GIF (on the host; needs matplotlib).
    from crowdmod_tpu_torch.viz import plotting_unavailable

    no_plots = plotting_unavailable()
    if no_plots:
        logging.info("pred.gif not written: %s", no_plots)
        return 0
    from crowdmod_tpu_torch.viz.plot_crowd import render_pred_vs_gt_gif

    gif = render_pred_vs_gt_gif(
        fast[0].cpu().numpy(), future[0].cpu().numpy(),
        os.path.join(args.out, "out", "pred.gif"),
    )
    print(f"wrote {gif}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
