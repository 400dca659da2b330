#!/usr/bin/env python
"""Generate the bundled dataset configs under configs/, with the PyTorch
port (``crowdmod_tpu_torch``) supplying the sweep configuration.

The configs are shared by both packages; this is the JAX tool's generator
with its own copy of the per-dataset geometry and shared hyperparameters,
writing byte for byte what ``tools/gen_configs.py`` writes, the W&B sweep
configuration from the port's ``cli.sweep.wandb_sweep_configuration``.
The JAX tool's output files, plus ``--device`` (the configs are written on
the host, but the tool asks for the card as every tool of the port does).

Run: ``python tools/gen_configs_torch.py`` (rewrites configs/ in place);
``--device cpu`` without a GPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import yaml

OUT = Path(__file__).resolve().parents[1] / "configs"

# ---------------------------------------------------------------------------
# Per-dataset physical geometry / splits.
# ---------------------------------------------------------------------------
DATASETS = {
    "ATC": dict(
        rows=12, cols=36, dx=1.0, dy=1.0, lu=[38.2789, -15.8076],
        theta=2.5647, time_res=0.5, stride=8, raw_seq_len=16,
        files=(33, 3, 3), split="ByFilenames", raw_ext=".csv",
    ),
    "HERMES-BO": dict(
        rows=12, cols=24, dx=0.5, dy=0.5, lu=[-6, 4],
        theta=0, time_res=0.25, stride=8, raw_seq_len=16,
        files=("NA", "NA", "NA"), split="BySplitRatio", raw_ext=".txt",
    ),
    "HERMES-BN": dict(
        rows=28, cols=16, dx=0.5, dy=0.5, lu=[-3, 8],
        theta=0, time_res=0.25, stride=8, raw_seq_len=16,
        files=("NA", "NA", "NA"), split="BySplitRatio", raw_ext=".txt",
    ),
    "HERMES-CR-90": dict(
        rows=12, cols=20, dx=0.5, dy=0.5, lu=[-4, 5],
        theta=0, time_res=0.25, stride=8, raw_seq_len=16,
        files=("NA", "NA", "NA"), split="BySplitRatio", raw_ext=".txt",
    ),
    "HERMES-CR-90-OBST": dict(
        rows=12, cols=20, dx=0.5, dy=0.5, lu=[-4, 5],
        theta=0, time_res=0.25, stride=8, raw_seq_len=16,
        files=("NA", "NA", "NA"), split="BySplitRatio", raw_ext=".txt",
    ),
    "HERMES-CR-120": dict(
        rows=28, cols=24, dx=0.5, dy=0.5, lu=[-5, 8],
        theta=0, time_res=0.25, stride=10, raw_seq_len=20,
        files=(18, 2, 2), split="BySplitRatio", raw_ext=".txt",
    ),
    "HERMES-CR-120-OBST": dict(
        rows=28, cols=24, dx=0.5, dy=0.5, lu=[-5, 8],
        theta=0, time_res=0.25, stride=10, raw_seq_len=20,
        files=(18, 2, 2), split="BySplitRatio", raw_ext=".txt",
    ),
    "ETH-UCY-4D": dict(
        rows=8, cols=12, dx=1.0, dy=1.0, lu=[12, 8],
        theta=0, time_res=0.4, stride=8, raw_seq_len=16,
        files=(5, 1, 1), split="ByFilenames", raw_ext=".txt",
        filename="ETHUCY",
    ),
}

# ---------------------------------------------------------------------------
# Bundled datafile lists (reference config/*_datafiles.yml role): filenames
# and raw sample counts are metadata of the public ATC/HERMES/ETH-UCY
# corpora as distributed with the reference.  When the pickles are present
# locally, regenerate counts with ``crowdmod_tpu.data.etl.count_samples``.
# ---------------------------------------------------------------------------
_ATC_DAYS = [
    ("20121028", 5055), ("20121104", 5035), ("20121111", 4842),
    ("20121118", 4910), ("20121125", 4979), ("20121202", 4798),
    ("20121216", 5087), ("20121223", 4996), ("20130106", 4805),
    ("20130113", 4850), ("20130120", 4908), ("20130203", 4822),
    ("20130210", 4894), ("20130217", 4887), ("20130224", 4935),
    ("20130303", 4395), ("20130310", 4964), ("20130317", 4852),
    ("20130324", 5170), ("20130331", 4959), ("20130407", 4851),
    ("20130414", 4953), ("20130421", 5103), ("20130428", 5000),
    ("20130505", 4962), ("20130512", 4767), ("20130519", 5040),
    ("20130526", 5123), ("20130602", 5005), ("20130630", 5088),
    ("20130707", 4804), ("20130714", 5057), ("20130721", 4676),
    ("20130728", 4622), ("20130811", 4977), ("20130818", 4860),
    ("20130825", 5361), ("20130901", 4969), ("20130915", 4923),
    ("20130922", 4851), ("20130929", 4745),
]

_HERMES_BO = [
    ("bo-360-050-050", 461), ("bo-360-075-075", 548), ("bo-360-090-090", 507),
    ("bo-360-120-120", 641), ("bo-360-160-160", 634), ("boa-300-050-070", 527),
    ("boa-300-050-085", 490), ("boa-300-055-095", 402),
    ("boa-300-065-105", 704), ("boa-300-080-120", 569),
    ("bot-300-050-050", 530), ("bot-300-065-065", 501),
    ("bot-300-075-075", 478), ("bot-300-085-085", 558),
    ("bot-300-100-100", 531), ("bot-360-050-050", 540),
    ("bot-360-075-075", 412), ("bot-360-090-090", 516),
    ("bot-360-120-120", 647), ("bot-360-160-160", 625),
    ("bot-360-200-200", 601), ("bot-360-250-250", 586),
]

_HERMES_BN = [
    ("ao-240-400", 533), ("ao-300-400", 464), ("ao-360-400", 389),
    ("ao-440-400", 345), ("ao-500-400", 286),
]

_CR_90 = [
    ("crossing_90_a_01", 2084), ("crossing_90_a_02", 1635),
    ("crossing_90_a_03", 1118), ("crossing_90_a_04", 1298),
    ("crossing_90_a_05", 1083), ("crossing_90_a_06", 580),
    ("crossing_90_a_07", 1232), ("crossing_90_a_08", 885),
    ("crossing_90_a_09", 1434), ("crossing_90_a_10", 1161),
    ("crossing_90_b_02", 2580), ("crossing_90_b_03", 1449),
    ("crossing_90_b_04", 1337), ("crossing_90_b_05", 1185),
    ("crossing_90_b_06", 1220), ("crossing_90_b_07", 1188),
]

_CR_90_OBST = [
    ("crossing_90_c_01", 2537), ("crossing_90_c_02", 1334),
    ("crossing_90_c_03", 1109), ("crossing_90_c_04", 1245),
    ("crossing_90_c_05", 1460), ("crossing_90_c_06", 1324),
    ("crossing_90_c_07", 1174), ("crossing_90_c_08", 1106),
]

_CR_120 = [
    ("crossing_120_a_01", 1121), ("crossing_120_a_02", 1237),
    ("crossing_120_a_03", 2288), ("crossing_120_a_04", 7239),
    ("crossing_120_a_05", 14182), ("crossing_120_a_06", 14305),
    ("crossing_120_a_07", 17267), ("crossing_120_b_01", 16786),
    ("crossing_120_b_02", 13978),
]

_CR_120_OBST = [
    ("crossing_120_c_01", 1291), ("crossing_120_c_02", 3172),
    ("crossing_120_c_03", 7740), ("crossing_120_c_04", 13102),
    ("crossing_120_c_05", 15289), ("crossing_120_c_06", 20049),
    ("crossing_120_c_07", 17620),
]


def _with_aug(entries):
    """HERMES BO/BN ship each file plus its _aug twin (same count)."""
    return entries + [(f"{name}_aug", n) for name, n in entries]


DATA_LISTS = {
    "ATC": [(f"atc-{d}", n) for d, n in _ATC_DAYS],
    "HERMES-BO": _with_aug(_HERMES_BO),
    "HERMES-BN": _with_aug(_HERMES_BN),
    "HERMES-CR-90": _CR_90,
    "HERMES-CR-90-OBST": _CR_90_OBST,
    "HERMES-CR-120": _CR_120,
    "HERMES-CR-120-OBST": _CR_120_OBST,
    # ETH-UCY ships as bare csv names (reference ETHUCY_ddpm_DSlist.yml);
    # counts are computed at load time.
    "ETHUCY": [
        "biwi_hotel.csv", "crowds_zara01.csv", "crowds_zara02.csv",
        "crowds_zara03.csv", "students001.csv", "students003.csv",
        "uni_examples.csv",
    ],
}


# 4test HERMES raw .txt recordings (reference config/4test/*_datafiles.yml):
# small per-variant subsets of the bottleneck experiment files used as ETL
# smoke inputs.  Widths in the names are corridor/entrance/exit cm.
_HERMES_4TEST_RAW = {
    "BO": [
        "bo-360-050-050.txt", "bo-360-075-075.txt", "bo-360-090-090.txt",
        "bo-360-120-120.txt", "bo-360-160-160.txt",
    ],
    "BOA": [
        "boa-300-050-070.txt", "boa-300-050-085.txt", "boa-300-055-095.txt",
        "boa-300-065-105.txt", "boa-300-080-120.txt",
    ],
    "BOT": [
        "bot-300-050-050.txt", "bot-300-065-065.txt", "bot-300-075-075.txt",
        "bot-300-085-085.txt", "bot-300-100-100.txt", "bot-360-050-050.txt",
        "bot-360-075-075.txt", "bot-360-090-090.txt", "bot-360-120-120.txt",
        "bot-360-160-160.txt", "bot-360-200-200.txt", "bot-360-250-250.txt",
    ],
}


def datafiles_tree(name: str) -> dict:
    entries = DATA_LISTS[name]
    if isinstance(entries[0], str):
        return {"DATA_LIST": list(entries)}
    return {"DATA_LIST": [[f"{f}.pkl", n] for f, n in entries]}


# ---------------------------------------------------------------------------
# Shared model hyperparameters (canonical ATC values).
# ---------------------------------------------------------------------------


def solver(lr, wd, betas, patience=10):
    return {
        "LR": lr,
        "WEIGHT_DECAY": wd,
        "BETAS": list(betas),
        "SCHEDULER": {"FACTOR": 0.5, "PATIENCE": patience, "MIN_LR": 1.0e-6},
    }


def unet_node(dropout, train):
    return {
        "CONDITION": "Past",
        "CONDITION_HANDLING": "embed",
        "NUM_RES_BLOCKS": 1,
        "BASE_CH": 32,
        "BASE_CH_MULT": [1, 2, 4],
        "APPLY_ATTENTION": [False, False, True, False],
        "DROPOUT_RATE": dropout,
        "TIME_EMB_MULT": 4,
        "TRAIN": train,
    }


def dit_node(train, t_patch=None):
    node = {
        "CONDITION": "Past",
        "PATCH_SIZE": 4,
        "HIDDEN_SIZE": 256,
        "DEPTH": 6,
        "NUM_HEADS": 4,
        "MLP_RATIO": 4.0,
        "DROPOUT_RATE": 0.1,
        "TIME_EMB_MULT": 4,
        "TRAIN": train,
    }
    if t_patch is not None:
        node["T_PATCH_SIZE"] = t_patch
    return node


def model_tree():
    return {
        "NAME": "{}_{}_TE{}_PL{}_FL{}_CE{}_{}.ckpt",
        "NSAMPLES": 1280,
        "NSAMPLES4PLOTS": 20,
        "DDPM": {
            "SAMPLER": "DDPM",
            "TIMESTEPS": 1000,
            "SCALE": 0.5,
            "SIGMA": 0.001,
            "DDIM_DIVIDER": 2,
            "GUIDANCE": "None",
            "LAMBDA_GUIDANCE": 0.004,
            "CHECKPOINTS_TO_KEEP": 7,
            "UNET": unet_node(
                0.1, {"EPOCHS": 200, "SOLVER": solver(5.0e-5, 0.003, (0.5, 0.999))}
            ),
            "DIT": dit_node(
                {"EPOCHS": 1000, "SOLVER": solver(1.0e-4, 0.003, (0.9, 0.999), 20)},
                t_patch=4,
            ),
        },
        "FM": {
            "TIME_MAX_POS": 1000,
            "CHECKPOINTS_TO_KEEP": 7,
            "W_TYPE": "Linear",
            "INTEGRATOR": "Euler",
            "INTEGRATOR_STEPS": {"EULER": 1000, "HEUN": 500},
            "UNET": unet_node(
                0.05, {"EPOCHS": 200, "SOLVER": solver(1.0e-4, 0.001, (0.5, 0.999))}
            ),
            "DIT": dit_node(
                {"EPOCHS": 500, "SOLVER": solver(1.0e-4, 0.001, (0.5, 0.999))}
            ),
        },
        "CONVRNN": {
            "CELL_CLASS": "ConvGRUCell",
            "TEACHER_FORCING": True,
            "ENC_HIDDEN_CH": [16, 64, 64, 96, 96, 96],
            "FORC_HIDDEN_CH": [96, 96, 96, 96, 96, 64, 16],
            "ENC_KERNELS": [3, 3, 3, 3, 3, 3],
            "FORC_KERNELS": [3, 4, 3, 4, 3, 3, 3],
            "TRAIN": {
                "EPOCHS": 600,
                "SOLVER": solver(0.003, 1.0e-4, (0.9, 0.999)),
            },
        },
    }


def dataset_cfg(name: str, geo: dict) -> dict:
    slug = geo.get("filename", name).lower().replace("-", "_")
    train_f, val_f, test_f = geo["files"]
    return {
        "DATA_FS": {
            "RAW_DATA_DIR": f"/datasets/{name}/rawData/",
            "AGG_DATA_DIR": f"/datasets/{name}/aggData/",
            "PICKLE_DIR": f"/datasets/{name}/processed/",
            "OUTPUT_DIR": f"output_{slug}",
            "SAVE_DIR": f"trained_models/{slug}/",
            "USE_PICKLE": False,
        },
        "MACROPROPS": {
            "ROWS": geo["rows"],
            "COLS": geo["cols"],
            "DX": geo["dx"],
            "DY": geo["dy"],
            "LU": geo["lu"],
            "EPS": 1.0e-6,
            "STRIDE": geo["stride"],
            "THETA": geo["theta"],
            "TIME_RES": geo["time_res"],
        },
        "DATASET": {
            "NAME": name,
            "PAST_LEN": 5,
            "FUTURE_LEN": 3,
            "RAW_SEQ_LEN": geo["raw_seq_len"],
            "TRAIN_FILE_COUNT": train_f,
            "VAL_FILE_COUNT": val_f,
            "TEST_FILE_COUNT": test_f,
            "BATCH_SIZE": 64,
            "params": {"shuffle": True, "num_workers": 6, "drop_last": True},
            "DATASET_TYPE": geo["split"],
            "VELOCITY_NORM": False,
            "MAX_RHO_4_PLOT": 6,
            "RAW_EXT": geo["raw_ext"],
        },
        "MODEL": model_tree(),
        "METRICS": {
            "PRED_MPROPS_FACTOR": [1, 1, 1],
            "MPROPS_COUNT": 3,
            "MOTION_FEATURE": {"f": 1, "k": 4, "s": 1, "GAMMA": 0.5},
        },
        # TPU-native additions (not in the reference schema).
        "TPU": {
            "COMPUTE_DTYPE": "bfloat16",
            "MESH": {"DATA": -1, "MODEL": 1},
            "DONATE_BUFFERS": True,
        },
    }


def write(path: Path, tree: dict):
    path.parent.mkdir(parents=True, exist_ok=True)
    header = (
        "# Generated by tools/gen_configs.py — edit that script, not this file.\n"
    )
    path.write_text(header + yaml.safe_dump(tree, sort_keys=False))
    print(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from crowdmod_tpu_torch.cli.sweep import wandb_sweep_configuration
    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    for name, geo in DATASETS.items():
        fname = geo.get("filename", name)
        write(OUT / f"{fname}.yml", dataset_cfg(name, geo))
        list_name = "ETHUCY" if fname == "ETHUCY" else name
        if list_name in DATA_LISTS:
            write(OUT / f"{fname}_datafiles.yml", datafiles_tree(list_name))

    # 4test fixture list (reference config/4test/ATC_datafiles.yml role).
    write(OUT / "4test" / "ATC_datafiles.yml", {
        "DATA_LIST": [[f"macroprops30minData4UT-{i}.pkl", 51]
                      for i in range(1, 7)],
    })

    # 4test HERMES raw-trajectory ETL input lists (reference
    # config/4test/HERMES-BO{,A,T}_datafiles.yml:1-13 role): plain-filename
    # form naming the bottleneck .txt recordings fed to the ETL stage
    # (bo = bottleneck, boa = asymmetric widening, bot = two-sided; the
    # numbers encode corridor/entrance/exit widths in cm).
    for tag, entries in _HERMES_4TEST_RAW.items():
        write(OUT / "4test" / f"HERMES-{tag}_datafiles.yml",
              {"DATA_LIST": list(entries)})

    # Single-raw-file smoke list (reference config/ATC_DSlist4test_one.yml:1-2
    # role — one unprocessed ATC csv for ETL smoke runs).
    write(OUT / "ATC_DSlist4test_one.yml",
          {"DATA_LIST": ["raw30minData4UT.csv"]})

    # Miniature smoke config (reference config/4test/ATC.yml semantics):
    # tiny file split, short epochs, ATC4TEST name.
    smoke = dataset_cfg("ATC", DATASETS["ATC"])
    smoke["DATASET"].update(
        NAME="ATC4TEST", RAW_SEQ_LEN=70,
        TRAIN_FILE_COUNT=3, VAL_FILE_COUNT=2, TEST_FILE_COUNT=1, BATCH_SIZE=32,
    )
    smoke["MODEL"]["DDPM"]["UNET"]["TRAIN"]["EPOCHS"] = 2
    smoke["MODEL"]["DDPM"]["DIT"]["TRAIN"]["EPOCHS"] = 2
    smoke["MODEL"]["FM"]["UNET"]["TRAIN"]["EPOCHS"] = 2
    smoke["MODEL"]["FM"]["DIT"]["TRAIN"]["EPOCHS"] = 2
    smoke["MODEL"]["CONVRNN"]["TRAIN"]["EPOCHS"] = 2
    write(OUT / "4test" / "ATC.yml", smoke)

    # Synthetic-walker variant (reference ATC_synthetic.yml role).
    synth = dataset_cfg("ATC", DATASETS["ATC"])
    synth["DATASET"].update(NAME="ATC-SYNTHETIC")
    synth["MACROPROPS"].update(OVERLAP=True, WINDOWSIZE=1, MPROPS_COUNT=3)
    write(OUT / "ATC_synthetic.yml", synth)

    # Synthetic datafile list (reference ATC_DSlist_synthetic.yml:1-2 —
    # plain-filename form; counts computed at load time).
    write(OUT / "ATC_synthetic_datafiles.yml",
          {"DATA_LIST": ["synthetic_data.pkl"]})

    # "Medium" ATC variant (reference ATC_medium.yml intent, re-expressed in
    # the current schema — the reference file itself is a legacy-schema
    # artifact with flat MODEL/DIFFUSION trees its own current code can't
    # load).  Captures: BASE_CH 64, 8+8 window with overlap re-striding,
    # 30/3/3 file split, 300 epochs, DDIM divider 90, sparsity guidance,
    # 1D-histogram GAMMA 2.0.
    medium = dataset_cfg("ATC", DATASETS["ATC"])
    medium["DATASET"].update(
        PAST_LEN=8, FUTURE_LEN=8, RAW_SEQ_LEN=16,
        TRAIN_FILE_COUNT=30, VAL_FILE_COUNT=3, TEST_FILE_COUNT=3,
    )
    medium["MACROPROPS"].update(OVERLAP=True, WINDOWSIZE=1)
    med_unet = medium["MODEL"]["DDPM"]["UNET"]
    med_unet.update(BASE_CH=64)
    med_unet["TRAIN"]["EPOCHS"] = 300
    medium["MODEL"]["DDPM"].update(DDIM_DIVIDER=90, GUIDANCE="Sparsity")
    medium["METRICS"]["MOTION_FEATURE"]["GAMMA"] = 2.0
    write(OUT / "ATC_medium.yml", medium)

    # Quality-pinned serving config (VALIDATION.md rounds 4-5): the
    # protocol-best fast sampler — stochastic eta-DDIM on 25 respaced
    # steps — COMPOSED with sparsity guidance at the round-5 swept peak
    # (λ=0.6: 42.8 dB PSNR / 0.920 SSIM at the 1280-sample protocol vs
    # 38.9 unguided; plateau 0.4-0.8, full ladder in VALIDATION.md round
    # 5) — with the v-parameterized training target and EMA sampling
    # weights that produced it.  λ is calibrated on the synthetic protocol
    # corpus; re-run tools/lambda_sweep.py + the protocol on real data
    # before production (ROADMAP.md).
    serving = dataset_cfg("ATC", DATASETS["ATC"])
    serving["MODEL"]["DDPM"].update(
        SAMPLER="DDIM-eta", ETA=1.0, ETA_STEPS=25, PRED_TYPE="v",
        GUIDANCE="Sparsity", LAMBDA_GUIDANCE=0.6,
    )
    serving["MODEL"]["DDPM"]["DIT"]["TRAIN"]["EMA_DECAY"] = 0.999
    serving["MODEL"]["DDPM"]["UNET"]["TRAIN"]["EMA_DECAY"] = 0.999
    write(OUT / "serving" / "ATC.yml", serving)

    # Low-latency serving class (round 5): 8-eval stochastic chain —
    # 36.4 dB at the 1280-sample protocol (within 2.7 dB of the default at
    # ~1/3 the device time per request), λ re-swept for the short chain
    # (0.1-0.4 plateau ≈ +0.15 dB; VALIDATION.md round 5).
    fast = dataset_cfg("ATC", DATASETS["ATC"])
    fast["MODEL"]["DDPM"].update(
        SAMPLER="DDIM-eta", ETA=1.0, ETA_STEPS=8, PRED_TYPE="v",
        GUIDANCE="Sparsity", LAMBDA_GUIDANCE=0.4,
    )
    fast["MODEL"]["DDPM"]["DIT"]["TRAIN"]["EMA_DECAY"] = 0.999
    fast["MODEL"]["DDPM"]["UNET"]["TRAIN"]["EMA_DECAY"] = 0.999
    write(OUT / "serving" / "ATC_fast.yml", fast)

    # FM classifier-free-guidance ship config: the round-3 CFG study's
    # recommendation (CFG_SCALE 3.0, DROP 0.1) as a config artifact instead
    # of VALIDATION.md prose.
    fm_cfg = dataset_cfg("ATC", DATASETS["ATC"])
    fm_cfg["MODEL"]["FM"].update(CFG_SCALE=3.0, CFG_DROP_PROB=0.1)
    write(OUT / "ATC_fm_cfg.yml", fm_cfg)

    # Example models list for the HTML comparison viewer
    # (reference config/models_list.yml:1-10 role; order = display order).
    write(OUT / "models_list.yml", {
        "MODELS": [
            "DDPM-UNet_mE000_sDDIMdiv2_gSparsity",
            "DDPM-UNet_mE000_sDDIMdiv10_gSparsity",
            "DDPM-UNet_mE000_sDDPM_gNone",
            "DDPM-UNet_mE000_sDDPM_gSparsity",
        ],
    })

    # W&B-shaped sweep config (reference config/sweep_config.yaml role),
    # generated from the same search space the port's `sweep` uses.
    write(OUT / "sweep_config.yaml", wandb_sweep_configuration("DDPM-UNet"))


if __name__ == "__main__":
    main()
