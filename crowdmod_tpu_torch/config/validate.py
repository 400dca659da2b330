"""Config validation with actionable errors.

The reference parses YAML into an EasyDict and fails deep inside the stack
when a key is missing or a geometry is incompatible (SURVEY.md §5.6).  Here
the CLI layer validates up front, in two stages:

  1. **Schema stage** — presence, types, positivity and enumerated choices
     are derived from the typed declaration in ``schema.py`` (single source
     of truth; nothing key-by-key here).
  2. **Geometry stage** — cross-field rules each architecture imposes:
     UNet halving levels, DiT patch divisibility, sequence-length sanity.

Returns a list of problems so callers can report them all at once.
"""

from __future__ import annotations

from crowdmod_tpu_torch.config.frozen import FrozenConfig
from crowdmod_tpu_torch.config.schema import schema_problems

ARCHS = ("DDPM-UNet", "DDPM-DiT", "FM-UNet", "FM-DiT", "ConvRNN")


def validate_config(cfg: FrozenConfig, arch: str | None = None) -> list[str]:
    """→ list of human-readable problems (empty = valid)."""
    problems = schema_problems(cfg)
    if problems:
        return problems

    h, w = cfg.get_path("MACROPROPS.ROWS"), cfg.get_path("MACROPROPS.COLS")
    p_len = cfg.get_path("DATASET.PAST_LEN")
    f_len = cfg.get_path("DATASET.FUTURE_LEN")
    raw = cfg.get_path("DATASET.RAW_SEQ_LEN")
    if raw and p_len and f_len and raw < p_len + f_len:
        problems.append(
            f"DATASET.RAW_SEQ_LEN ({raw}) shorter than "
            f"PAST_LEN+FUTURE_LEN ({p_len}+{f_len})"
        )

    # Classifier-free guidance knobs (DDPM + FM nodes).
    for node_path in ("MODEL.DDPM", "MODEL.FM"):
        node = cfg.get_path(node_path)
        if node is None:
            continue
        prob = node.get("CFG_DROP_PROB", 0.0)
        if not 0.0 <= prob < 1.0:
            problems.append(
                f"{node_path}.CFG_DROP_PROB ({prob}) must be in [0, 1)"
            )
        # Guided sampling (CFG_SCALE != 1) needs a trained unconditional
        # branch, which only exists when training dropped the condition
        # sometimes (CFG_DROP_PROB > 0) — see models/guidance.py docstring.
        scale = node.get("CFG_SCALE", 1.0)
        if scale != 1.0 and prob == 0.0:
            problems.append(
                f"{node_path}.CFG_SCALE ({scale}) != 1.0 but CFG_DROP_PROB "
                "is 0.0: the model has no trained unconditional branch to "
                "guide against; set CFG_DROP_PROB > 0 for training or "
                "CFG_SCALE to 1.0 for sampling"
            )

    # Architecture-specific geometry rules.
    def check_dit(node, label):
        if node is None:
            return
        ps = node.get("PATCH_SIZE")
        tps = node.get("T_PATCH_SIZE")
        if ps and h and w and (h % ps or w % ps):
            problems.append(
                f"{label}: grid {h}x{w} not divisible by PATCH_SIZE {ps}"
            )
        total = (p_len or 0) + (f_len or 0)
        if tps and total and total % tps:
            problems.append(
                f"{label}: PAST+FUTURE ({total}) not divisible by "
                f"T_PATCH_SIZE {tps}"
            )
        hs, heads = node.get("HIDDEN_SIZE"), node.get("NUM_HEADS")
        if hs and heads and hs % heads:
            problems.append(
                f"{label}: HIDDEN_SIZE {hs} not divisible by NUM_HEADS {heads}"
            )

    def check_unet(node, label):
        if node is None:
            return
        mult = node.get("BASE_CH_MULT")
        if not mult:
            return
        levels = len(mult)
        total_t = (p_len or 0) + (f_len or 0)
        for dim, name in ((h, "ROWS"), (w, "COLS"), (total_t, "PAST+FUTURE")):
            if dim and dim % (2 ** (levels - 1)):
                problems.append(
                    f"{label}: {name} ({dim}) must be divisible by "
                    f"2^(levels-1) = {2 ** (levels - 1)} for {levels} "
                    f"resolution levels"
                )

    def check_convrnn(node, label):
        if node is None:
            return
        # Encoder runs two stride-2 levels and the forecaster allocates its
        # recurrent state at (H//4, W//4) / (H//2, W//2) — an indivisible
        # grid fails with an opaque concat shape error deep in flax.
        for dim, name in ((h, "ROWS"), (w, "COLS")):
            if dim and dim % 4:
                problems.append(
                    f"{label}: MACROPROPS.{name} ({dim}) must be divisible "
                    f"by 4 (two stride-2 encoder levels)"
                )

    archs = {
        "DDPM-UNet": lambda: check_unet(cfg.get_path("MODEL.DDPM.UNET"), "MODEL.DDPM.UNET"),
        "DDPM-DiT": lambda: check_dit(cfg.get_path("MODEL.DDPM.DIT"), "MODEL.DDPM.DIT"),
        "FM-UNet": lambda: check_unet(cfg.get_path("MODEL.FM.UNET"), "MODEL.FM.UNET"),
        "FM-DiT": lambda: check_dit(cfg.get_path("MODEL.FM.DIT"), "MODEL.FM.DIT"),
        "ConvRNN": lambda: check_convrnn(
            cfg.get_path("MODEL.CONVRNN"), "MODEL.CONVRNN"
        ),
    }
    if arch is not None:
        if arch not in archs:
            problems.append(f"unknown arch {arch!r}; expected {list(archs)}")
        else:
            archs[arch]()
    else:
        for fn in archs.values():
            fn()
    return problems


def require_valid(cfg: FrozenConfig, arch: str | None = None) -> None:
    """Raise ValueError listing every problem (CLI entry-point guard)."""
    problems = validate_config(cfg, arch)
    if problems:
        raise ValueError(
            "invalid configuration:\n  - " + "\n  - ".join(problems)
        )


def with_defaults(cfg: FrozenConfig) -> FrozenConfig:
    """Materialize the schema's optional-field defaults into ``cfg``.

    The validator's contract is "optional keys have defaults", but runtime
    code reads the raw tree by attribute access — a config omitting e.g.
    ``MODEL.DDPM.SCALE`` would validate cleanly and then crash with
    AttributeError deep in the Trainer.  Overlaying the raw tree onto the
    typed view (defaults filled, unknown keys preserved by the overlay)
    makes the contract hold everywhere.  Configs with schema problems are
    returned unchanged — ``require_valid`` owns the error reporting.
    """
    import dataclasses

    from crowdmod_tpu_torch.config.schema import structure, TypedConfig

    problems: list[str] = []
    typed = structure(TypedConfig, cfg, "", problems)
    if problems or typed is None:
        return cfg
    defaults = dataclasses.asdict(typed)
    return FrozenConfig(defaults).updated(cfg.to_dict())
