"""Port parity: config loading, the CPU Predictor/BatchingQueue, and
``Trainer.sample`` against the JAX package's on one tiny DDPM-DiT config."""

import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.config.loader import is_datafile_list as jax_is_datafile_list
from crowdmod_tpu.config.validate import validate_config as jax_validate
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.config.loader import is_datafile_list
from crowdmod_tpu_torch.config.validate import validate_config
from crowdmod_tpu_torch.core.schedule import respaced_taus
from crowdmod_tpu_torch.serving import BatchingQueue, Predictor, load_predictor
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
SHIPPED = sorted(
    str(p.relative_to(REPO / "configs"))
    for p in [*(REPO / "configs").glob("*.yml"),
              *(REPO / "configs" / "serving").glob("*.yml")]
)
ARCH = "DDPM-DiT"
# Tiny DDPM-DiT serving config: 8x12 grid, hidden 64 (2 heads of 32),
# depth 1, v-parameterized with EMA, DDIM-eta 4 steps over T = 50 with
# Sparsity guidance, as the serving default is at full size.
TINY = {
    "MACROPROPS": {"ROWS": 8, "COLS": 12},
    "MODEL": {"DDPM": {
        "SAMPLER": "DDIM-eta", "TIMESTEPS": 50, "ETA_STEPS": 4, "ETA": 1.0,
        "GUIDANCE": "Sparsity", "LAMBDA_GUIDANCE": 0.6, "PRED_TYPE": "v",
        "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 1, "NUM_HEADS": 2,
                "DROPOUT_RATE": 0.0, "TRAIN": {"EMA_DECAY": 0.999}},
    }},
}


def perturbed(tree, seed, std=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, std, np.shape(a)).astype(np.float32),
        tree,
    )


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_loads_like_jax(name):
    assert is_datafile_list(name) == jax_is_datafile_list(name)
    got, want = load_config(name), jax_load_config(name)
    assert got.to_dict() == want.to_dict()
    assert validate_config(got) == jax_validate(want)
    assert validate_config(got, ARCH) == jax_validate(want, ARCH)


def test_validate_reports_the_same_problems():
    over = {"MACROPROPS": {"ROWS": 10}, "DATASET": {"PAST_LEN": 4},
            "MODEL": {"DDPM": {"DIT": {"NUM_HEADS": 3}}}}
    got = validate_config(load_config("ATC.yml", overrides=over), ARCH)
    want = jax_validate(jax_load_config("ATC.yml", overrides=over), ARCH)
    assert got == want and len(got) == 3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny config (both packages), perturbed JAX weights, and a port
    checkpoint holding them (params and a different EMA)."""
    root = tmp_path_factory.mktemp("serving")
    over = {**TINY, "DATA_FS": {"SAVE_DIR": str(root / "ckpts")}}
    cfg_path = root / "tiny.yml"
    cfg_path.write_text(
        yaml.safe_dump(load_config("4test/ATC.yml", overrides=over).to_dict())
    )
    jtrainer = JaxTrainer(jax_load_config(str(cfg_path)), ARCH)
    jtrainer.setup()
    params = perturbed(jtrainer.state.params, seed=1)
    ema = perturbed(jtrainer.state.params, seed=2)
    jtrainer.state = jtrainer.state.replace(params=params, ema_params=ema)
    cfg = load_config(str(cfg_path))
    path = ckpt.save_checkpoint(
        Path(cfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, ARCH, "000"),
        {"params": state_dict_from_jax(params["params"]),
         "ema_params": state_dict_from_jax(ema["params"])},
        ckpt.build_metadata(cfg, ARCH, "000"),
    )
    return cfg, str(cfg_path), path, jtrainer


def _past(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 5, 8, 12, 3)).astype(np.float32)


def test_trainer_sample_matches_jax(tiny):
    """Same past, same carried-across weights (EMA first), the JAX key's
    draws injected: the port's Trainer.sample gives the JAX Trainer's."""
    cfg, _, path, jtrainer = tiny
    key = jax.random.PRNGKey(3)
    past = _past(2)
    want = np.asarray(jtrainer.sample(jnp.asarray(past), key))

    taus = respaced_taus(50, 4)
    k_init, k_loop = jax.random.split(key)
    shape = want.shape
    draws = {None: jax.random.normal(k_init, shape, jnp.float32)}
    for t in taus:
        draws[int(t)] = jax.random.normal(jax.random.fold_in(k_loop, t), shape)
    trainer = Trainer(cfg, ARCH, device="cpu")
    meta = trainer.load(path)
    assert meta["name"] == ckpt.checkpoint_name(cfg, ARCH, "000")
    got = trainer.sample(past, noise=lambda t: torch.from_numpy(np.array(draws[t])))
    got = got.numpy()
    assert got.shape == (2, 3, 8, 12, 3) and np.isfinite(got).all()
    off = np.abs(got - want) > 1e-3  # flip-aware under Sparsity
    assert not off[..., 1:].any()
    assert off.sum() <= 1e-3 * off.size
    raw = Trainer(cfg, ARCH, device="cpu")
    raw.load(path)
    raw.sample_weights = "raw"
    assert not np.allclose(
        raw.sample(past, noise=lambda t: torch.from_numpy(np.array(draws[t]))),
        got,
    )


def test_predictor_pads_to_buckets_and_is_deterministic_per_seed(tiny):
    _, cfg_path, _, _ = tiny
    pred = load_predictor(cfg_path, ARCH, device="cpu", batch_buckets=(1, 4))
    assert pred.input_spec == (5, 3, 8, 12, 3)
    pred.warmup()
    out = pred.predict(_past(3))
    assert out.shape == (3, 3, 8, 12, 3) and np.isfinite(out).all()
    a, b = pred.predict(_past(2), seed=7), pred.predict(_past(2), seed=7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, pred.predict(_past(2), seed=8))
    # Seedless requests advance the predictor's generator.
    assert not np.array_equal(pred.predict(_past(1)), pred.predict(_past(1)))
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        pred.predict(_past(5))


def test_batching_queue_answers_concurrent_requests(tiny):
    cfg, _, path, _ = tiny
    pred = Predictor(cfg, ARCH, path, device="cpu", batch_buckets=(1, 8))
    queue = BatchingQueue(pred, max_delay_ms=20.0)
    results = {}

    def client(i):
        results[i] = queue.predict(_past(1 + i % 2, seed=i), timeout=120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    seeded = queue.predict(_past(2), seed=1, timeout=120)
    queue.close()
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(6))
    for i, out in results.items():
        assert out.shape == (1 + i % 2, 3, 8, 12, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(seeded, pred.predict(_past(2), seed=1))
    assert queue.dispatches <= 7
