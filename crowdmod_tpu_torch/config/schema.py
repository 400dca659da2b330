"""Typed configuration schema.

The YAML layout (the reference's de-facto API surface, SURVEY.md §2.1) is
declared here once as frozen dataclasses; presence/type/choice validation is
*derived* from the declaration instead of hand-rolled per key.  Two uses:

  * ``typed_config(cfg)`` → a :class:`TypedConfig` whose fields are real
    typed attributes (IDE-discoverable, misspellings impossible) for code
    that prefers static structure over ``cfg.get_path`` strings;
  * ``schema_problems(cfg)`` → the flat problem list the CLI validator
    merges with its cross-field geometry rules (``validate.py``).

Unknown keys are ignored by design: the reference configs carry fields this
framework does not consume (e.g. torch ``DATASET.params``) and user configs
may carry their own annotations.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence
from dataclasses import dataclass, field
from typing import Optional, get_args, get_origin


def _meta(*, positive=False, choices=None, na_ok=False):
    return {"positive": positive, "choices": choices, "na_ok": na_ok}


def req(*, positive=False, choices=None):
    """A required field, optionally constrained."""
    return field(metadata=_meta(positive=positive, choices=choices))


def opt(default, *, positive=False, choices=None, na_ok=False):
    """An optional field with a default, optionally constrained.

    ``na_ok`` admits the reference's literal ``'NA'`` sentinel (used for
    file counts under BySplitRatio, e.g. HERMES-BN.yml).
    """
    if isinstance(default, (list, dict)):
        return field(default_factory=lambda: default,
                     metadata=_meta(positive=positive, choices=choices))
    return field(default=default,
                 metadata=_meta(positive=positive, choices=choices,
                                na_ok=na_ok))


# ---------------------------------------------------------------------------
# Schema declaration (mirrors configs/ATC.yml, the canonical layout)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SchedulerSchema:
    FACTOR: float = 0.5
    PATIENCE: int = 10
    MIN_LR: float = 1e-6


@dataclass(frozen=True)
class SolverSchema:
    LR: float = req(positive=True)
    WEIGHT_DECAY: float = 0.0
    BETAS: tuple[float, float] = (0.9, 0.999)
    SCHEDULER: SchedulerSchema = SchedulerSchema()


@dataclass(frozen=True)
class TrainSchema:
    EPOCHS: int = req(positive=True)
    SOLVER: SolverSchema = req()
    # EMA of the weights for sampling/eval (0 disables; typical 0.999).
    EMA_DECAY: float = 0.0


@dataclass(frozen=True)
class UNetSchema:
    BASE_CH: int = req(positive=True)
    BASE_CH_MULT: tuple[int, ...] = req()
    APPLY_ATTENTION: tuple[bool, ...] = req()
    TRAIN: TrainSchema = req()
    DROPOUT_RATE: float = 0.0
    TIME_EMB_MULT: int = opt(4, positive=True)
    NUM_RES_BLOCKS: int = opt(1, positive=True)
    CONDITION: str = "Past"
    CONDITION_HANDLING: str = "embed"


@dataclass(frozen=True)
class DiTSchema:
    PATCH_SIZE: int = req(positive=True)
    HIDDEN_SIZE: int = req(positive=True)
    DEPTH: int = req(positive=True)
    NUM_HEADS: int = req(positive=True)
    TRAIN: TrainSchema = req()
    MLP_RATIO: float = opt(4.0, positive=True)
    DROPOUT_RATE: float = 0.0
    TIME_EMB_MULT: int = opt(4, positive=True)
    T_PATCH_SIZE: int = opt(1, positive=True)
    CONDITION: str = "Past"


@dataclass(frozen=True)
class DDPMSchema:
    TIMESTEPS: int = req(positive=True)
    SCALE: float = opt(1.0, positive=True)
    SAMPLER: str = opt(
        "DDPM", choices=("DDPM", "DDIM", "DDIM-eta", "DPM-Solver", "Distilled")
    )
    GUIDANCE: str = opt(
        "None", choices=("None", "Sparsity", "mass_preservation")
    )
    DDIM_DIVIDER: int = opt(2, positive=True)
    SIGMA: float = 0.0
    # Model output parameterization: the reference trains an eps-head
    # (ddpm.py:120); "v" (Salimans & Ho 2022) keeps the target bounded over
    # the whole noise range — the quality choice for few-step sampling.
    PRED_TYPE: str = opt("eps", choices=("eps", "v", "x0"))
    # "DDIM-eta" sampler knobs: eta=1 -> respaced-ancestral (stochastic,
    # quality), eta=0 -> deterministic probability-flow DDIM; ETA_STEPS
    # model evaluations on a respaced 0..T-1 grid (endpoints included).
    ETA: float = 1.0
    ETA_STEPS: int = opt(50, positive=True)
    # "Distilled" sampler knobs: the student's step count and an optional
    # eta>0 for stochastic steps on the distill grid (the grid's respaced
    # posterior noise — the few-step stochastic serving class).
    DISTILL_STEPS: int = opt(8, positive=True)
    DISTILL_ETA: float = 0.0
    LAMBDA_GUIDANCE: float = 0.0
    # Classifier-free guidance: training-time condition dropout probability
    # and sampling-time guidance scale (1.0 = plain conditional, off).
    CFG_DROP_PROB: float = 0.0
    CFG_SCALE: float = 1.0
    CHECKPOINTS_TO_KEEP: int = 0
    UNET: Optional[UNetSchema] = None
    DIT: Optional[DiTSchema] = None


@dataclass(frozen=True)
class IntegratorStepsSchema:
    EULER: int = opt(1000, positive=True)
    HEUN: int = opt(500, positive=True)


@dataclass(frozen=True)
class FMSchema:
    W_TYPE: str = opt("Linear", choices=("Linear", "Conic"))
    INTEGRATOR: str = opt("Euler", choices=("Euler", "Heun"))
    INTEGRATOR_STEPS: IntegratorStepsSchema = IntegratorStepsSchema()
    TIME_MAX_POS: int = opt(1000, positive=True)
    CHECKPOINTS_TO_KEEP: int = 0
    # Classifier-free guidance (same semantics as MODEL.DDPM.CFG_*; the
    # guided field is u_uncond + scale * (u_cond - u_uncond)).
    CFG_DROP_PROB: float = 0.0
    CFG_SCALE: float = 1.0
    UNET: Optional[UNetSchema] = None
    DIT: Optional[DiTSchema] = None


@dataclass(frozen=True)
class ConvRNNSchema:
    ENC_HIDDEN_CH: tuple[int, ...] = req()
    FORC_HIDDEN_CH: tuple[int, ...] = req()
    TRAIN: TrainSchema = req()
    CELL_CLASS: str = opt(
        "ConvGRUCell", choices=("ConvGRUCell", "ConvLSTMCell")
    )
    TEACHER_FORCING: bool = True
    ENC_KERNELS: tuple[int, ...] = (3, 3, 3, 3, 3, 3)
    FORC_KERNELS: tuple[int, ...] = (3, 4, 3, 4, 3, 3, 3)
    CHECKPOINTS_TO_KEEP: int = 0


@dataclass(frozen=True)
class ModelSchema:
    DDPM: Optional[DDPMSchema] = None
    FM: Optional[FMSchema] = None
    CONVRNN: Optional[ConvRNNSchema] = None
    NSAMPLES: int = opt(1280, positive=True)
    NSAMPLES4PLOTS: int = opt(4, positive=True)


@dataclass(frozen=True)
class MacropropsSchema:
    ROWS: int = req(positive=True)
    COLS: int = req(positive=True)
    STRIDE: int = opt(8, positive=True)
    DX: float = opt(1.0, positive=True)
    DY: float = opt(1.0, positive=True)
    EPS: float = 1e-6
    THETA: float = 0.0
    TIME_RES: float = opt(0.5, positive=True)
    LU: tuple[float, float] = (0.0, 0.0)
    # Sliding-window re-stride for the offline sequence builder
    # (reference computeMacroProps.py:60-61; set in ETHUCY_ddpm.yml:19-20).
    OVERLAP: bool = False
    WINDOWSIZE: int = opt(1, positive=True)


@dataclass(frozen=True)
class DatasetSchema:
    NAME: str = req()
    PAST_LEN: int = req(positive=True)
    FUTURE_LEN: int = req(positive=True)
    RAW_SEQ_LEN: int = req(positive=True)
    BATCH_SIZE: int = req(positive=True)
    DATASET_TYPE: str = opt(
        "ByFilenames", choices=("ByFilenames", "BySplitRatio")
    )
    VELOCITY_NORM: bool = False
    TRAIN_FILE_COUNT: int = opt(0, na_ok=True)
    VAL_FILE_COUNT: int = opt(0, na_ok=True)
    TEST_FILE_COUNT: int = opt(0, na_ok=True)


@dataclass(frozen=True)
class MotionFeatureSchema:
    f: int = opt(1, positive=True)
    k: int = opt(4, positive=True)
    s: int = opt(1, positive=True)
    GAMMA: float = 0.5


@dataclass(frozen=True)
class MetricsSchema:
    MPROPS_COUNT: int = opt(3, positive=True)
    PRED_MPROPS_FACTOR: tuple[float, ...] = (1.0, 1.0, 1.0)
    MOTION_FEATURE: MotionFeatureSchema = MotionFeatureSchema()
    CHUNK_REPD_PAST_SEQ: int = opt(20, positive=True)


@dataclass(frozen=True)
class MeshSchema:
    DATA: int = -1
    MODEL: int = 1


@dataclass(frozen=True)
class TPUSchema:
    COMPUTE_DTYPE: str = opt(
        "bfloat16", choices=("bfloat16", "float32")
    )
    MESH: MeshSchema = MeshSchema()
    DONATE_BUFFERS: bool = True
    # Per-block gradient rematerialization (jax.checkpoint) for
    # activation-memory-bound training; off at reference scale.
    REMAT: bool = False


@dataclass(frozen=True)
class DataFSSchema:
    PICKLE_DIR: str = ""
    OUTPUT_DIR: str = "output"
    SAVE_DIR: str = "trained_models"
    RAW_DATA_DIR: str = ""
    AGG_DATA_DIR: str = ""


@dataclass(frozen=True)
class TypedConfig:
    DATA_FS: DataFSSchema = req()
    MACROPROPS: MacropropsSchema = req()
    DATASET: DatasetSchema = req()
    MODEL: ModelSchema = req()
    METRICS: MetricsSchema = req()
    TPU: TPUSchema = TPUSchema()


# ---------------------------------------------------------------------------
# Generic structurer: FrozenConfig/dict subtree → dataclass, collecting
# problems instead of raising on the first.
# ---------------------------------------------------------------------------

def _is_dataclass_type(t) -> bool:
    return isinstance(t, type) and dataclasses.is_dataclass(t)


def _unwrap_optional(t):
    if get_origin(t) is not None and type(None) in get_args(t):
        inner = [a for a in get_args(t) if a is not type(None)]
        if len(inner) == 1:
            return inner[0], True
    return t, False


def _check_scalar(value, t, path, problems):
    if t is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            problems.append(f"{path}: expected float, got {value!r}")
            return None
        return float(value)
    if t is int:
        if isinstance(value, bool) or not isinstance(value, int):
            problems.append(f"{path}: expected int, got {value!r}")
            return None
        return value
    if t is bool:
        if not isinstance(value, bool):
            problems.append(f"{path}: expected bool, got {value!r}")
            return None
        return value
    if t is str:
        if not isinstance(value, str):
            problems.append(f"{path}: expected str, got {value!r}")
            return None
        return value
    return value  # Any / unconstrained


def _structure_value(value, t, path, problems):
    t, is_opt = _unwrap_optional(t)
    if value is None:
        if not is_opt:
            problems.append(f"{path}: must not be null")
        return None
    if _is_dataclass_type(t):
        if not isinstance(value, Mapping):
            problems.append(f"{path}: expected a mapping, got {value!r}")
            return None
        return structure(t, value, path, problems)
    origin = get_origin(t)
    if origin is tuple:
        if isinstance(value, (str, bytes)) or not isinstance(value, Sequence):
            problems.append(f"{path}: expected a sequence, got {value!r}")
            return None
        args = get_args(t)
        if len(args) == 2 and args[1] is Ellipsis:
            elem_types = [args[0]] * len(value)
        else:
            if len(value) != len(args):
                problems.append(
                    f"{path}: expected {len(args)} elements, got {len(value)}"
                )
                return None
            elem_types = list(args)
        return tuple(
            _structure_value(v, et, f"{path}[{i}]", problems)
            for i, (v, et) in enumerate(zip(value, elem_types))
        )
    return _check_scalar(value, t, path, problems)


def structure(cls, data: Mapping, path: str = "", problems: list | None = None):
    """Convert a mapping into dataclass ``cls``, appending problems.

    Missing required fields, wrong types, non-positive values and
    out-of-choice strings are all reported with their dotted path; unknown
    keys are ignored.  Returns the (possibly partial) instance, or ``None``
    when required fields were missing.
    """
    own = problems is None
    if own:
        problems = []
    values = {}
    ok = True
    hints = {f.name: f.type for f in dataclasses.fields(cls)}
    for f in dataclasses.fields(cls):
        key_path = f"{path}.{f.name}" if path else f.name
        t = hints[f.name]
        if isinstance(t, str):  # from __future__ annotations
            t = eval(t, globals())  # noqa: S307 - schema-internal names only
        if f.name in data:
            if f.metadata.get("na_ok") and data[f.name] == "NA":
                values[f.name] = "NA"
                continue
            v = _structure_value(data[f.name], t, key_path, problems)
            meta = f.metadata
            if v is not None and meta:
                if meta.get("positive") and isinstance(v, (int, float)) \
                        and not isinstance(v, bool) and v <= 0:
                    problems.append(f"{key_path}: must be positive, got {v!r}")
                choices = meta.get("choices")
                if choices and v not in choices:
                    problems.append(
                        f"{key_path}: {v!r} not one of {list(choices)}"
                    )
            values[f.name] = v
        elif f.default is not dataclasses.MISSING:
            values[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            values[f.name] = f.default_factory()  # type: ignore[misc]
        else:
            problems.append(f"{key_path}: required field is missing")
            ok = False
    if not ok:
        # Missing required fields must honor the same own-call contract as
        # type problems below: raise the aggregated message, never return a
        # silent None to a direct caller.
        if own and problems:
            raise ValueError(
                "invalid configuration:\n  - " + "\n  - ".join(problems)
            )
        return None
    try:
        inst = cls(**values)
    except Exception as e:  # pragma: no cover - defensive
        problems.append(f"{path or cls.__name__}: {e}")
        return None
    if own and problems:
        raise ValueError(
            "invalid configuration:\n  - " + "\n  - ".join(problems)
        )
    return inst


def schema_problems(cfg: Mapping) -> list[str]:
    """All schema-level problems in ``cfg`` (empty list = clean)."""
    problems: list[str] = []
    structure(TypedConfig, cfg, "", problems)
    return problems


def typed_config(cfg: Mapping) -> TypedConfig:
    """Validate ``cfg`` against the schema and return the typed view.

    Raises ``ValueError`` listing every problem at once.
    """
    problems: list[str] = []
    out = structure(TypedConfig, cfg, "", problems)
    if problems or out is None:
        raise ValueError(
            "invalid configuration:\n  - " + "\n  - ".join(problems)
        )
    return out
