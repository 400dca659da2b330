"""Model parameter accounting (port of the JAX package's
``utils/model_info.py``): trainable parameters per top-level module and in
total, for any architecture/config pair.  ``python -m
crowdmod_tpu_torch.cli params [--all-archs]``.

The breakdown names the port's top-level modules (the reference's
``time_embeddings``, ``encoder_blocks``, ``blocks``, …), not the JAX
package's flax scopes; the totals are the same.
"""

from __future__ import annotations

from torch import nn


def count_trainable_params(model: nn.Module) -> int:
    """Total number of trainable parameter elements of ``model``."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def param_breakdown(model: nn.Module) -> dict[str, int]:
    """→ {top-level module or parameter: trainable parameter count}."""
    out = {name: count_trainable_params(child)
           for name, child in sorted(model.named_children())}
    out.update({name: p.numel() for name, p in model.named_parameters(recurse=False)
                if p.requires_grad})
    return {name: n for name, n in sorted(out.items()) if n}


def build_parser():
    from crowdmod_tpu_torch.cli import common_parser

    p = common_parser("Count trainable parameters per architecture.")
    p.add_argument("--all-archs", action="store_true",
                   help="Report every architecture, not just --arch.")
    return p


def run(argv=None) -> int:
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.models.factory import ARCHS
    from crowdmod_tpu_torch.train.trainer import Trainer

    args = build_parser().parse_args(argv)
    cfg = load_config(args.config_yml_file, args.configList_yml_file)

    for arch in ARCHS if args.all_archs else (args.arch,):
        model = Trainer(cfg, arch, device=args.device).model
        print(f"{arch}: {count_trainable_params(model):,} trainable params")
        for name, n in param_breakdown(model).items():
            print(f"  {name}: {n:,}")
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
