#!/usr/bin/env python
"""Scaling quickstart of the PyTorch port: DP + TP + FSDP + remat on the
("data", "model") mesh, no CLI.

Runs the same Trainer flow as examples/quickstart_torch.py, but sharded,
one process a mesh position (a card each over NCCL; on ``--device cpu``
processes over gloo):

  * batch over the "data" mesh axis (data parallelism),
  * large DiT weights over the "model" axis (tensor parallelism: each rank
    holds its output features, the layers gather),
  * parameters / Adam moments / EMA over "data" (FSDP2),
  * per-block ``torch.utils.checkpoint`` (TPU.REMAT) for activation memory.

The trainer takes the mesh and the sharding mode; the collectives are the
port's (``parallel/tensor.py``) and FSDP2's.

    python examples/scaling_quickstart_torch.py                  # 8 cards
    python examples/scaling_quickstart_torch.py --data 2 --model 2 --device cpu
"""

import argparse
import multiprocessing
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rank_main(args, init_method: str, rank: int) -> None:
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.parallel import multiprocess
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.parallel.tensor import model_shards
    from crowdmod_tpu_torch.train.trainer import Trainer

    if args.device == "cpu":
        torch.set_num_threads(1)  # one core a process
    device = multiprocess.initialize(
        init_method=init_method, num_processes=args.data * args.model,
        process_id=rank, device_type=args.device)
    try:
        # 1. Mesh: data-parallel × tensor-parallel.
        mesh = make_mesh(data=args.data, model=args.model)
        main = multiprocess.is_main()
        if main:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
                  f"{multiprocess.backend()}")

        # 2. Config: the DiT flagship at a small size, remat on.
        out = args.out
        cfg = load_config("4test/ATC.yml").updated({
            "DATA_FS": {"SAVE_DIR": os.path.join(out, "ckpts"),
                        "OUTPUT_DIR": os.path.join(out, "out")},
            "DATASET": {"BATCH_SIZE": 16},
            "MACROPROPS": {"ROWS": 8, "COLS": 12},
            "TPU": {"REMAT": True},
            "MODEL": {"DDPM": {"TIMESTEPS": 50,
                               "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 2,
                                       "NUM_HEADS": 4, "PATCH_SIZE": 4,
                                       "T_PATCH_SIZE": 4,
                                       "TRAIN": {"EPOCHS": args.epochs}}}},
        })

        # 3. Data: windows over synthetic walkers; every process reads the
        #    same batches and the trainer takes its data index's rows.
        walkers = synthetic_walkers(64, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 16)
        ds = WindowDataset(torch.from_numpy(walkers).to(device), past_len=5,
                           future_len=3, stride=4)

        # 4. Train sharded: param_sharding="fsdp" shards params + Adam
        #    moments + EMA over "data", and the mesh's "model" axis cuts the
        #    large weights.  Same API as one device — only the two kwargs.
        trainer = Trainer(cfg, "DDPM-DiT", device=device, mesh=mesh,
                          param_sharding="fsdp",
                          run_dir=os.path.join(out, "run", f"p{rank}"))
        history = trainer.fit(ds, epochs=args.epochs)
        if main:
            print("train losses:", [round(x, 4) for x in history["train_loss"]])

        # Show where the parameters live.
        params = list(trainer.model.named_parameters())
        cut = set(model_shards(trainer.model))
        fsdp = [n for n, p in params if isinstance(p, DTensor)]
        if main:
            print(f"{len(fsdp)}/{len(params)} param tensors sharded over "
                  f"\"data\" (FSDP2), {len(cut)} cut over \"model\"")

        # 5. Sample batch-parallel: each data index samples its rows with
        #    its rows of the whole batch's draws; every process gets all.
        past, _ = ds.gather(np.arange(16))
        gen = torch.Generator(device=device).manual_seed(0)
        samples = trainer.sample(past, gen)
        assert torch.isfinite(samples).all()
        if main:
            print("samples:", tuple(samples.shape), "on", samples.device)
            print("scaling quickstart OK")
        multiprocess.barrier("quickstart-exit")
    finally:
        multiprocess.shutdown()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: NCCL, a card a process; raises "
                        "without a GPU) or cpu (gloo)")
    p.add_argument("--data", type=int, default=4)
    p.add_argument("--model", type=int, default=2)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sq"))
    args = p.parse_args(argv)

    import torch

    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    world = args.data * args.model
    if args.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"a {args.data}x{args.model} mesh over NCCL needs "
                         f"{world} cards; this host has "
                         f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="crowdmod_sq_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(args, init, r))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join()
    codes = [proc.exitcode for proc in procs]
    if any(codes):
        print(f"scaling quickstart FAILED: exit codes {codes}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
