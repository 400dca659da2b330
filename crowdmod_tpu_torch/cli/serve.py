"""``python -m crowdmod_tpu_torch.cli serve`` — HTTP inference server (port
of the JAX package's ``cli/serve.py``).

Wraps :class:`crowdmod_tpu_torch.serving.Predictor` (or, with
``--artifact``, :class:`crowdmod_tpu_torch.export_artifact.ArtifactPredictor`)
behind a threaded stdlib HTTP server with the JAX server's endpoints, JSON
keys, status codes and Prometheus series:

  * ``POST /predict``  — JSON ``{"past": [[...]], "seed": optional int,
    "model": optional name}`` → ``{"future": [[...]], "model": str,
    "latency_ms": float}``.  Concurrent requests coalesce into single
    dispatches on the card (:class:`~crowdmod_tpu_torch.serving.BatchingQueue`);
    bad geometry → 400, body over :data:`MAX_BODY_BYTES` → 413, queue full →
    429 (load shedding), warming up → 503, deadline exceeded → 504.  A
    payload's ``seed`` is the port's integer seed
    (``Predictor.predict(seed=)``): the same seed gives the same future.
  * ``GET /healthz``   — 200 once warmup has run every batch bucket, 503
    before that (readiness probe).
  * ``GET /models``    — per-model arch / geometry / batch buckets.
  * ``GET /metrics``   — Prometheus text format: request/sample counters,
    latency sum, queue depth, dispatch/coalesce counters (model-labelled
    when serving several models).

CUDA work runs only on each queue's dispatch thread (and its predictor's
replica threads), under its predictor's lock; the HTTP handler threads
parse, wait and answer.  SIGTERM/SIGINT
drain the queues, then the process exits 0; its last log line gives the
kernel launches of the run (warmup included).  ``--device`` defaults to
``cuda``; ``--data-parallel`` keeps one replica a card of this host and
splits each request over them (:class:`~crowdmod_tpu_torch.serving.
Predictor`'s ``mesh``).  The
JAX command's ``--compile-cache`` has no counterpart: eager PyTorch compiles
nothing at warmup, and the kernels' libraries are cached by source hash
(``ops/kernels/build.py``).
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from crowdmod_tpu_torch.cli import common_parser, setup_logging

# JSON-encoded pasts are ~8 B/float; the largest sane request (batch 64 of
# ATC 5×12×36×3 pasts) is ~33 MB, so 64 MB caps abuse without limiting use.
MAX_BODY_BYTES = 64 * 1024 * 1024


class ServingApp:
    """Predictor(s) + batching queue(s) + readiness state.

    Single-model: ``ServingApp(predictor)``.  Multi-model:
    ``ServingApp({"ddpm-dit": pred_a, "ddpm-unet": pred_b})`` — requests
    route by the payload's ``"model"`` field (the first registered model is
    the default), each model gets its own micro-batching queue, and
    /metrics reports per-model labelled series.
    """

    def __init__(self, predictors, *, max_delay_ms: float = 5.0,
                 max_queue: int = 4096, request_timeout_s: float = 30.0):
        from crowdmod_tpu_torch.serving import BatchingQueue

        if not isinstance(predictors, dict):
            predictors = {"default": predictors}
        if not predictors:
            raise ValueError("ServingApp needs at least one predictor")
        self.predictors = dict(predictors)
        self.default_model = next(iter(self.predictors))
        self.request_timeout_s = request_timeout_s
        self.queues = {
            name: BatchingQueue(p, max_delay_ms=max_delay_ms, max_queue=max_queue)
            for name, p in self.predictors.items()
        }
        self.ready = threading.Event()

    @property
    def predictor(self):
        return self.predictors[self.default_model]

    @property
    def queue(self):
        return self.queues[self.default_model]

    def warmup(self):
        for name, p in self.predictors.items():
            p.warmup()
            logging.info("model %r warmed", name)
        self.ready.set()
        return self

    def close(self):
        for q in self.queues.values():
            q.close()

    def handle_predict(self, payload: dict) -> dict:
        name = payload.get("model", self.default_model)
        if name not in self.predictors:
            raise ValueError(
                f"unknown model {name!r}; serving {sorted(self.predictors)}"
            )
        predictor = self.predictors[name]
        past = np.asarray(payload["past"], np.float32)
        if past.ndim == 4:  # single sequence without batch dim
            past = past[None]
        p, _, h, w, c = predictor.input_spec  # (P, F, H, W, C)
        if past.ndim != 5 or past.shape[1:] != (p, h, w, c):
            raise ValueError(
                f"past must be (N, {p}, {h}, {w}, {c}) for this model, "
                f"got {past.shape}"
            )
        seed = payload.get("seed")
        t0 = time.perf_counter()
        future = self.queues[name].predict(
            past, None if seed is None else int(seed), timeout=self.request_timeout_s
        )
        return {
            "future": np.asarray(future).tolist(),
            "model": name,
            "latency_ms": 1e3 * (time.perf_counter() - t0),
        }

    def models_info(self) -> dict:
        out = {}
        for name, p in self.predictors.items():
            past_len, f, h, w, c = p.input_spec
            out[name] = {
                "arch": p.arch,
                "past_shape": [past_len, h, w, c],
                "future_shape": [f, h, w, c],
                "batch_buckets": list(p.batch_buckets),
                "default": name == self.default_model,
            }
        return out

    def metrics_text(self) -> str:
        lines = [
            "# TYPE crowdmod_requests_total counter",
            "# TYPE crowdmod_samples_total counter",
            "# TYPE crowdmod_request_latency_seconds_sum counter",
            "# TYPE crowdmod_dispatches_total counter",
            "# TYPE crowdmod_coalesced_requests_total counter",
            "# TYPE crowdmod_queue_depth gauge",
        ]
        single = len(self.predictors) == 1
        for name, p in self.predictors.items():
            s, q = p.stats, self.queues[name]
            lbl = "" if single else f'{{model="{name}"}}'
            lines += [
                f"crowdmod_requests_total{lbl} {s.requests}",
                f"crowdmod_samples_total{lbl} {s.samples}",
                f"crowdmod_request_latency_seconds_sum{lbl} {s.total_latency_s:.6f}",
                f"crowdmod_dispatches_total{lbl} {q.dispatches}",
                f"crowdmod_coalesced_requests_total{lbl} {q.coalesced_requests}",
                f"crowdmod_queue_depth{lbl} {q.depth}",
            ]
        lines += [
            "# TYPE crowdmod_ready gauge",
            f"crowdmod_ready {int(self.ready.is_set())}",
        ]
        return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    app: ServingApp = None  # type: ignore[assignment]  # set by make_server
    # Socket read/write deadline: bounds how long a stalled client can hold
    # a handler thread (and therefore how long graceful drain can take).
    timeout = 60

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logging.debug("http: " + fmt, *args)

    def _send(self, code: int, body: str | bytes, content_type: str = "application/json"):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            if self.app.ready.is_set():
                self._send(200, '{"status": "ok"}')
            else:
                self._send(503, '{"status": "warming up"}')
        elif self.path == "/metrics":
            self._send(200, self.app.metrics_text(), "text/plain; version=0.0.4")
        elif self.path == "/models":
            self._send(200, json.dumps(self.app.models_info()))
        else:
            self._send(404, '{"error": "not found"}')

    def do_POST(self):
        if self.path != "/predict":
            self._send(404, '{"error": "not found"}')
            return
        if not self.app.ready.is_set():
            self._send(503, '{"error": "warming up"}')
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._send(413, json.dumps({
                    "error": f"request body {length} B exceeds {MAX_BODY_BYTES} B cap"
                }))
                return
            payload = json.loads(self.rfile.read(length))
            self._send(200, json.dumps(self.app.handle_predict(payload)))
        except (KeyError, ValueError, TypeError) as e:
            self._send(400, json.dumps({"error": str(e)}))
        except concurrent.futures.TimeoutError:
            # Deadline exceeded while queued/running: the client should
            # retry with backoff; the dispatch itself may still complete.
            self._send(504, json.dumps({"error": "request timed out"}))
        except RuntimeError as e:
            # Queue full (load shedding) or shutting down.
            self._send(429 if "full" in str(e) else 503, json.dumps({"error": str(e)}))
        except Exception as e:  # pragma: no cover
            logging.exception("predict failed")
            self._send(500, json.dumps({"error": str(e)}))


def parse_model_buckets(specs: list[str]) -> dict[str, tuple[int, ...]]:
    """``["ddpm-dit=1,8,64", "convrnn=8"]`` → per-model bucket tuples."""
    out: dict[str, tuple[int, ...]] = {}
    for spec in specs:
        name, _, rest = spec.partition("=")
        if not name or not rest:
            raise ValueError(f"--model-buckets entry {spec!r} must look like NAME=B1,B2")
        try:
            out[name.lower()] = tuple(sorted(int(b) for b in rest.split(",")))
        except ValueError as e:
            raise ValueError(f"bad bucket list in {spec!r}: {e}") from None
    return out


def make_server(app: ServingApp, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``port=0`` picks a free one."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    srv = ThreadingHTTPServer((host, port), handler)
    # Non-daemon handler threads: server_close() then joins them, so the
    # graceful-drain path waits for in-flight responses to finish writing.
    # The handler's socket timeout above bounds the join.
    srv.daemon_threads = False
    return srv


def build_parser():
    p = common_parser("Serve one or more trained models over HTTP.")
    p.add_argument("--epoch-tag", type=str, default="000")
    p.add_argument(
        "--extra-arch", type=str, nargs="*", default=[],
        help="additional archs to serve from the same config/checkpoint dir; "
             "requests route by their 'model' field (names are the "
             "lower-cased arch)",
    )
    p.add_argument(
        "--model-buckets", type=str, nargs="*", default=[], metavar="NAME=B1,B2,...",
        help="per-model batch-bucket override, e.g. ddpm-dit=1,8,64 "
             "(models not listed use --batch-buckets)",
    )
    p.add_argument(
        "--host", type=str, default="127.0.0.1",
        help="bind address; the server has no auth, so exposing beyond "
             "localhost (e.g. 0.0.0.0) must be an explicit choice",
    )
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-buckets", type=int, nargs="+", default=[1, 8, 64, 256])
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="micro-batching window for request coalescing")
    p.add_argument("--max-queue", type=int, default=4096,
                   help="pending-request cap; beyond it requests get 429")
    p.add_argument("--request-timeout-s", type=float, default=30.0,
                   help="per-request deadline; exceeded requests get 504")
    p.add_argument("--data-parallel", action="store_true",
                   help="one replica a card of this host, each request "
                        "batch split over them (buckets rounded up to the "
                        "replica count)")
    p.add_argument(
        "--artifact", type=str, nargs="+", default=None, metavar="PATH",
        help="serve exported sampler artifact(s) (python -m "
             "crowdmod_tpu_torch.cli export; one per batch bucket) instead of "
             "a checkpoint — no model/config code is loaded; --arch only "
             "names the model, and the artifact fixes the device",
    )
    return p


def run(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    setup_logging("logs/serve.log")

    if args.artifact:
        from crowdmod_tpu_torch.export_artifact import ArtifactPredictor

        if args.extra_arch:
            p.error("--artifact serves a single exported model; "
                    "--extra-arch needs the checkpoint path")
        if args.data_parallel:
            p.error("an artifact runs on the device it was exported for; "
                    "--data-parallel needs the checkpoint path")
        predictors = {args.arch.lower(): ArtifactPredictor(args.artifact)}
        logging.info("serving %d artifact bucket(s): %s", len(args.artifact), args.artifact)
    else:
        from crowdmod_tpu_torch.serving import load_predictor
        from crowdmod_tpu_torch.train.trainer import resolve_device

        resolve_device(args.device)  # no card and no --device cpu: fail at once
        overrides = parse_model_buckets(args.model_buckets)

        def load(arch):
            return load_predictor(
                args.config_yml_file, arch, datafiles_yml=args.configList_yml_file,
                epoch_tag=args.epoch_tag, device=args.device, seed=args.seed,
                data_parallel=args.data_parallel,
                batch_buckets=overrides.get(arch.lower(), tuple(args.batch_buckets)),
            )

        predictors = {arch.lower(): load(arch) for arch in [args.arch, *args.extra_arch]}
    app = ServingApp(predictors, max_delay_ms=args.max_delay_ms, max_queue=args.max_queue,
                     request_timeout_s=args.request_timeout_s)
    server = make_server(app, args.host, args.port)
    logging.info("listening on %s:%d (warming up)", *server.server_address)
    # Serve /healthz 503 while the buckets warm up, then flip ready.
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    # Graceful termination: stop accepting, drain the queues, exit 0 — what
    # a rolling deploy sends (SIGTERM) must not drop in-flight work.
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    app.warmup()
    logging.info("ready: %d model(s), buckets %s warmed", len(app.predictors),
                 {n: p.batch_buckets for n, p in app.predictors.items()})
    try:
        stop.wait()
        logging.info("shutdown signal received; draining")
    finally:
        server.shutdown()      # stop accepting new connections
        app.close()            # complete/fail everything queued for the card
        server.server_close()  # join in-flight handler threads
    from crowdmod_tpu_torch.ops.kernels import KERNELS

    logging.info("kernel launches: %s",
                 json.dumps({fn.__name__: fn.launches for fn in KERNELS}))
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
