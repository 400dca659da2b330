"""The port's HTTP server (``crowdmod_tpu_torch.cli.serve``) against the
JAX package's (``crowdmod_tpu.cli.serve``): the same endpoints, JSON keys,
status codes (400, 413, 429, 503 before warmup, 504) and Prometheus series
on stand-in predictors; a ConvRNN future (deterministic) from both servers
on the same weights within 1e-4 of max|JAX|; a seeded DDPM request
deterministic per seed; multi-model routing, ``parse_model_buckets``, and
the command's SIGTERM drain (exit 0), on the CPU.  Mirrors
``tests/test_serving.py``, less the mesh tests (ROADMAP.md Queue 1 item
16)."""

import contextlib
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.cli import serve as jax_serve
from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.serving import PredictorStats as JaxPredictorStats
from crowdmod_tpu.serving import load_predictor as jax_load_predictor
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch.cli import serve
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.serving import BatchingQueue, PredictorStats, load_predictor
from crowdmod_tpu_torch.train import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
FUTURE_RTOL = 1e-4  # of max|JAX|: f32 convolutions summed in another order
# Tiny ConvRNN (GRU): 8x12 grid, 5 past and 3 future frames, 4 channels.
CONVRNN = {
    "MACROPROPS": {"ROWS": 8, "COLS": 12},
    "MODEL": {"CONVRNN": {"ENC_HIDDEN_CH": [4, 6, 6, 8, 8, 8],
                          "FORC_HIDDEN_CH": [8, 8, 8, 8, 8, 6, 4]}},
}
# Tiny DDPM-DiT: hidden 64, depth 1, DDIM-eta 4 steps over T = 50 + Sparsity.
DIT = {
    "MACROPROPS": {"ROWS": 8, "COLS": 12},
    "MODEL": {"DDPM": {
        "SAMPLER": "DDIM-eta", "TIMESTEPS": 50, "ETA_STEPS": 4,
        "GUIDANCE": "Sparsity", "LAMBDA_GUIDANCE": 0.6,
        "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 1, "NUM_HEADS": 2, "DROPOUT_RATE": 0.0},
    }},
}


class FakePredictor:
    """Predictor stand-in for either package: records dispatch sizes,
    echoes shapes; ``ready_gate`` stalls the dispatch."""

    batch_buckets = (2, 8)
    arch = "DDPM-UNet"
    input_spec = _shape = (5, 3, 4, 4, 3)  # (P, F, H, W, C): port, JAX

    def __init__(self, stats=PredictorStats):
        self.dispatch_sizes = []
        self.stats = stats()
        self.ready_gate = None

    def _bucket(self, n):
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds largest bucket")

    def warmup(self):
        return self

    def predict(self, past, seed=None):
        if self.ready_gate is not None:
            self.ready_gate.wait(5.0)
        self.dispatch_sizes.append(past.shape[0])
        self.stats.record(past.shape[0], 0.001)
        n, p = past.shape[:2]
        return np.zeros((n, p - 2) + past.shape[2:], np.float32)


@contextlib.contextmanager
def served(app, module=serve):
    """``app`` behind ``module.make_server`` on a free port → base URL."""
    server = module.make_server(app)
    host, port = server.server_address
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://{host}:{port}"
    finally:
        server.shutdown()
        app.close()
        server.server_close()


def status(base, path, payload=None):
    """``(code, parsed body)`` of a GET (``payload`` None) or a POST."""
    data = None if payload is None else (
        payload if isinstance(payload, bytes) else json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data)) as r:
            code, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    try:
        return code, json.loads(body)
    except json.JSONDecodeError:
        return code, body


def oversized(base) -> int:
    """Status of a POST announcing a body over MAX_BODY_BYTES (none sent)."""
    host, port = base.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    conn.putrequest("POST", "/predict")
    conn.putheader("Content-Length", str(serve.MAX_BODY_BYTES + 1))
    conn.endheaders()
    code = conn.getresponse().status
    conn.close()
    return code


def series(text: str) -> list[str]:
    """The metric names and types of a Prometheus text page, in order."""
    return [line.split("{")[0].split(" ")[0] if not line.startswith("#") else line
            for line in text.splitlines()]


def test_max_body_and_buckets_parse_like_jax():
    assert serve.MAX_BODY_BYTES == jax_serve.MAX_BODY_BYTES
    for specs in (["DDPM-DiT=64,8,1", "convrnn=8"], [], ["a=1"]):
        assert serve.parse_model_buckets(specs) == jax_serve.parse_model_buckets(specs)
    for bad, match in ((["nonsense"], "NAME=B1,B2"), (["x=a,b"], "bad bucket list")):
        with pytest.raises(ValueError, match=match):
            serve.parse_model_buckets(bad)
        with pytest.raises(ValueError, match=match):
            jax_serve.parse_model_buckets(bad)


def test_endpoints_status_codes_and_series_agree_with_jax():
    """The same requests against both servers on stand-in predictors give
    the same codes and JSON keys: 503 while warming up, 200, 400 (bad
    payload, wrong geometry, unknown model), 413, 404, then 504 past the
    deadline and 429 when the queue is full."""
    past = np.zeros((2, 5, 4, 4, 3), np.float32).tolist()
    requests = [
        ("/healthz", None), ("/predict", {"past": past}), ("/nope", None),
    ]
    after_warmup = [
        ("/healthz", None), ("/predict", {"past": past, "seed": 7}),
        ("/predict", b'{"nope": 1}'), ("/predict", {"past": [[0.0]]}),
        ("/predict", {"model": "nope", "past": past}), ("/models", None),
    ]
    results = {}
    for name, module, stats in (("port", serve, PredictorStats),
                                ("jax", jax_serve, JaxPredictorStats)):
        app = module.ServingApp(FakePredictor(stats), max_delay_ms=1.0)
        with served(app, module) as base:
            got = [status(base, *r) for r in requests]
            app.ready.set()  # the stand-in warms nothing
            got += [status(base, *r) for r in after_warmup]
            got.append((oversized(base), None))
            metrics = status(base, "/metrics")[1]
        codes = [c for c, _ in got]
        keys = [sorted(b) if isinstance(b, dict) else None for _, b in got]
        results[name] = (codes, keys, series(metrics),
                         [got[i][1]["error"] for i in (6, 7)])
    assert results["port"][:3] == results["jax"][:3]
    assert results["port"][0] == [503, 503, 404, 200, 200, 400, 400, 400, 200, 413]
    assert results["port"][3] == results["jax"][3]  # the error messages


@pytest.mark.parametrize("module,stats", [(serve, PredictorStats),
                                          (jax_serve, JaxPredictorStats)],
                         ids=["port", "jax"])
def test_deadline_gives_504_and_a_full_queue_429(module, stats):
    pred = FakePredictor(stats)
    pred.ready_gate = threading.Event()  # never set here: the dispatcher stalls
    app = module.ServingApp(pred, max_delay_ms=1.0, max_queue=1, request_timeout_s=0.2)
    app.ready.set()
    body = {"past": np.zeros((1, 5, 4, 4, 3), np.float32).tolist()}
    try:
        with served(app, module) as base:
            assert status(base, "/predict", body)[0] == 504
            app.queue.submit(np.zeros((1, 5, 4, 4, 3), np.float32))  # fills the queue
            code, out = status(base, "/predict", body)
            assert code == 429 and "full" in out["error"]
            pred.ready_gate.set()
    finally:
        pred.ready_gate.set()


def test_timed_out_request_frees_its_queue_slot():
    """A request past its deadline leaves the queue and never dispatches."""
    pred = FakePredictor()
    pred.ready_gate = threading.Event()
    q = BatchingQueue(pred, max_delay_ms=1.0, max_queue=2)
    try:
        head = q.submit(np.zeros((1, 5, 4, 4, 3), np.float32), seed=0)
        deadline = time.time() + 5.0
        while q.depth > 0 and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(TimeoutError):
            q.predict(np.zeros((1, 5, 4, 4, 3), np.float32), timeout=0.1)
        assert q.depth == 0
        pred.ready_gate.set()
        head.result(5.0)
        time.sleep(0.2)
        assert pred.dispatch_sizes == [1]
    finally:
        pred.ready_gate.set()
        q.close()


def test_batching_queue_coalesces_concurrent_requests():
    """Three requests queued together dispatch as one of 6 rows."""
    pred = FakePredictor()
    pred.ready_gate = threading.Event()
    q = BatchingQueue(pred, max_delay_ms=200.0)
    try:
        futs = [q.submit(np.zeros((2, 5, 4, 4, 3), np.float32)) for _ in range(3)]
        pred.ready_gate.set()
        assert all(f.result(10.0).shape == (2, 3, 4, 4, 3) for f in futs)
        assert pred.dispatch_sizes == [6]
        assert q.dispatches == 1 and q.coalesced_requests == 3
    finally:
        q.close()


def test_seeded_requests_dispatch_solo_and_a_closed_queue_refuses():
    pred = FakePredictor()
    q = BatchingQueue(pred, max_delay_ms=50.0)
    try:
        out = q.predict(np.zeros((1, 5, 4, 4, 3), np.float32), seed=0, timeout=10.0)
        assert out.shape == (1, 3, 4, 4, 3) and pred.dispatch_sizes == [1]
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            q.submit(np.zeros((9, 5, 4, 4, 3), np.float32))
    finally:
        q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(np.zeros((1, 5, 4, 4, 3), np.float32))


def test_load_predictor_names_a_missing_checkpoint(tmp_path):
    paths = _configs(tmp_path, CONVRNN)
    with pytest.raises(FileNotFoundError, match="no checkpoint for ConvRNN"):
        load_predictor(str(paths["port"]), "ConvRNN", device="cpu")


def test_multi_model_routing():
    class Other(FakePredictor):
        input_spec = _shape = (4, 2, 6, 6, 3)
        arch = "DDPM-DiT"

    a, b = FakePredictor(), Other()
    app = serve.ServingApp({"unet": a, "dit": b}, max_delay_ms=1.0)
    app.ready.set()
    with served(app) as base:
        info = status(base, "/models")[1]
        assert set(info) == {"unet", "dit"}
        assert info["unet"]["default"] and not info["dit"]["default"]
        assert info["dit"]["past_shape"] == [4, 6, 6, 3]
        assert info["dit"]["future_shape"] == [2, 6, 6, 3]
        code, body = status(base, "/predict", {
            "model": "dit", "past": np.zeros((1, 4, 6, 6, 3), np.float32).tolist()})
        assert code == 200 and body["model"] == "dit"
        assert np.asarray(body["future"]).shape == (1, 2, 6, 6, 3)
        assert b.dispatch_sizes and not a.dispatch_sizes
        metrics = status(base, "/metrics")[1]
    assert 'crowdmod_requests_total{model="dit"} 1' in metrics
    assert 'crowdmod_requests_total{model="unet"} 0' in metrics


def _perturbed(tree, seed, std=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + rng.normal(0.0, std, np.shape(a)).astype(np.float32), tree)


def _configs(root, over):
    """A config file for each package (own checkpoint dirs) → paths."""
    paths = {}
    for name in ("port", "jax"):
        cfg = load_config("4test/ATC.yml", overrides={
            **over, "DATA_FS": {"SAVE_DIR": str(root / f"{name}_ckpts"),
                                "OUTPUT_DIR": str(root / f"{name}_out")}})
        paths[name] = root / f"{name}.yml"
        paths[name].write_text(yaml.safe_dump(cfg.to_dict()))
    return paths


@pytest.fixture(scope="module")
def convrnn(tmp_path_factory):
    """ConvRNN checkpoints of the same perturbed weights in both packages."""
    root = tmp_path_factory.mktemp("serve_convrnn")
    paths = _configs(root, CONVRNN)
    jtr = JaxTrainer(jax_load_config(str(paths["jax"])), "ConvRNN")
    jtr.setup()
    jtr.state = jtr.state.replace(params=_perturbed(jtr.state.params, 1))
    jtr.save(jtr.cfg.DATA_FS.SAVE_DIR, "000")
    cfg = load_config(str(paths["port"]))
    ckpt.save_checkpoint(
        Path(cfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, "ConvRNN", "000"),
        {"params": state_dict_from_jax(jtr.state.params["params"])},
        ckpt.build_metadata(cfg, "ConvRNN", "000"))
    return paths


def test_convrnn_future_matches_the_jax_server(convrnn):
    past = np.abs(np.random.default_rng(0).normal(size=(2, 5, 8, 12, 4))).astype(np.float32)
    out = {}
    for name, module, load, kw in (
            ("port", serve, load_predictor, {"device": "cpu"}),
            ("jax", jax_serve, jax_load_predictor, {})):
        pred = load(str(convrnn[name]), "ConvRNN", batch_buckets=(2,), **kw)
        app = module.ServingApp({"convrnn": pred}, max_delay_ms=1.0).warmup()
        with served(app, module) as base:
            code, body = status(base, "/predict", {"past": past.tolist(), "model": "convrnn"})
            assert code == 200 and body["model"] == "convrnn"
            out[name] = (np.asarray(body["future"], np.float32), status(base, "/models")[1])
    got, want = out["port"][0], out["jax"][0]
    assert got.shape == (2, 3, 8, 12, 4) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= FUTURE_RTOL * np.abs(want).max()
    assert out["port"][1] == out["jax"][1]


def test_seeded_ddpm_request_is_deterministic_per_seed(tmp_path):
    paths = _configs(tmp_path, DIT)
    cfg = load_config(str(paths["port"]))
    from crowdmod_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, "DDPM-DiT", device="cpu")
    gen = torch.Generator().manual_seed(1)
    for v in trainer.params.values():
        v.add_(0.02 * torch.randn(v.shape, generator=gen))
    trainer.save(cfg.DATA_FS.SAVE_DIR, "000")
    pred = load_predictor(str(paths["port"]), "DDPM-DiT", device="cpu", batch_buckets=(1, 2))
    app = serve.ServingApp(pred, max_delay_ms=1.0).warmup()
    past = np.random.default_rng(1).normal(size=(2, 5, 8, 12, 3)).astype(np.float32).tolist()
    with served(app) as base:
        a, b, c = (status(base, "/predict", {"past": past, "seed": s})[1]["future"]
                   for s in (7, 7, 8))
        d = status(base, "/predict", {"past": past[0]})[1]["future"]  # no batch dim
    assert np.isfinite(a).all() and np.asarray(a).shape == (2, 3, 8, 12, 3)
    assert a == b and a != c
    assert np.asarray(d).shape == (1, 3, 8, 12, 3)


def test_data_parallel_names_its_roadmap_item(convrnn, capsys):
    """Data-parallel serving is ported: on the CPU one replica, whose future
    is the plain predictor's, and two replicas on the CPU split a bucket
    (rounded up to an even size) and give the same future.  Tensor
    parallelism is ported: ``train`` refuses a model axis under 1 with
    exit 2, before any handshake."""
    from crowdmod_tpu_torch.cli import train
    from crowdmod_tpu_torch.serving import Predictor

    past = np.abs(np.random.default_rng(0).normal(size=(3, 5, 8, 12, 4))).astype(np.float32)
    plain = load_predictor(str(convrnn["port"]), "ConvRNN", device="cpu", batch_buckets=(1, 4))
    dp = load_predictor(str(convrnn["port"]), "ConvRNN", device="cpu", batch_buckets=(1, 4),
                        data_parallel=True)
    assert dp.batch_buckets == (1, 4) and np.array_equal(dp.predict(past), plain.predict(past))
    cfg = load_config(str(convrnn["port"]))
    path = Path(cfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, "ConvRNN", "000")
    two = Predictor(cfg, "ConvRNN", str(path), mesh=[torch.device("cpu")] * 2,
                    batch_buckets=(1, 4))
    assert two.batch_buckets == (2, 4)
    np.testing.assert_allclose(two.predict(past), plain.predict(past), rtol=1e-6, atol=1e-6)
    assert train.run(["--data-parallel", "--model-parallel", "0", "--device", "cpu"]) == 2
    assert "the model axis needs at least 1 process" in capsys.readouterr().err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_command_drains_on_sigterm_and_exits_0(convrnn, tmp_path):
    """``python -m crowdmod_tpu_torch.cli serve`` on the CPU: 200 from
    /healthz once warm, a request answered, then SIGTERM → exit 0."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "crowdmod_tpu_torch.cli", "serve", "--arch", "ConvRNN",
         "--config-yml-file", str(convrnn["port"]), "--device", "cpu",
         "--port", str(port), "--batch-buckets", "1"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if status(base, "/healthz")[0] == 200:
                    break
            except OSError:
                pass  # not listening yet
            time.sleep(0.2)
        else:
            raise AssertionError("the server never became ready")
        past = np.ones((1, 5, 8, 12, 4), np.float32).tolist()
        code, body = status(base, "/predict", {"past": past})
        assert code == 200 and np.asarray(body["future"]).shape == (1, 3, 8, 12, 4)
        assert "crowdmod_requests_total 2" in status(base, "/metrics")[1]  # + warmup
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
