"""``core/scene.py``, ``core/schedule.ddpm_reverse_step``,
``utils/profiling.py`` and ``utils/tracker.py`` of the port against the
JAX package's: ``MacroScene`` and the composite reverse step (its noise
injected) within 1e-6 (of max|ref| where it sums), ``StepTimer.summary``
equal on the same times, the Chrome trace written, and the tracker's
records (its artifacts and its W&B mirror, through a stub) equal to
JAX's."""

import json
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.core import schedule as jax_schedule
from crowdmod_tpu.core.scene import MacroScene as JaxScene
from crowdmod_tpu.utils import profiling as jax_profiling
from crowdmod_tpu.utils.tracker import RunTracker as JaxTracker
from crowdmod_tpu_torch import utils
from crowdmod_tpu_torch.core import schedule
from crowdmod_tpu_torch.core.scene import MacroScene
from crowdmod_tpu_torch.utils import profiling
from crowdmod_tpu_torch.utils.tracker import RunTracker


@pytest.mark.parametrize("channels", [3, 4])
def test_macro_scene_matches_jax(channels):
    grid = np.random.default_rng(channels).normal(size=(2, 5, 8, 12, channels)).astype(
        np.float32)
    scene, jscene = MacroScene.unpack(torch.from_numpy(grid)), JaxScene.unpack(grid)
    assert scene.num_channels == jscene.num_channels == channels
    assert (scene.sigma2 is None) == (jscene.sigma2 is None) == (channels == 3)
    for a, b in zip(scene, jscene):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(scene.pack(), torch.from_numpy(grid))
    want = np.asarray(jscene.total_density())  # float32 sums of 96 cells
    np.testing.assert_allclose(scene.total_density().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert scene.total_density().shape == (2, 5)
    with pytest.raises(ValueError, match="3 or 4"):
        MacroScene.unpack(torch.zeros(2, 5))


@pytest.mark.parametrize("t", [0, 1, 537, 999, "batch"])
def test_ddpm_reverse_step_matches_jax(t):
    """The step with JAX's own z (``normal(key)``) injected: x_{t-1},
    sigma_t and alpha_t within 1e-6 of max(1, max|ref|); z dropped at
    t = 0.  A ``(B,)`` t holds no 0 here: JAX's ``where(t > 0, z, 0)``
    aligns a ``(B,)`` mask with the channel axis, the port drops z on the
    rows whose t is 0 (checked against the scalar step below)."""
    shape = (3, 3, 8, 12, 3)
    rng = np.random.default_rng(0)
    x, eps = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    ts = np.array([1, 5, 999]) if t == "batch" else t
    sched = schedule.linear_schedule(1000, scale=0.5)
    jsched = jax_schedule.linear_schedule(1000, scale=0.5)
    key = jax.random.PRNGKey(3)
    want = jax_schedule.ddpm_reverse_step(jsched, jnp.asarray(eps), jnp.asarray(x),
                                          jnp.asarray(ts), key)
    z = torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))
    got = schedule.ddpm_reverse_step(sched, torch.from_numpy(eps), torch.from_numpy(x),
                                     torch.as_tensor(ts) if t == "batch" else t, z)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * max(1.0, np.abs(w).max()))
    if t == 0:  # no noise on the last step
        plain = schedule.ddpm_reverse_step(sched, torch.from_numpy(eps), torch.from_numpy(x), 0,
                                           torch.zeros(shape))
        assert torch.equal(got[0], plain[0])
    if t == "batch":  # a row at t = 0 takes the scalar step's values
        rows = schedule.ddpm_reverse_step(sched, torch.from_numpy(eps), torch.from_numpy(x),
                                          torch.tensor([0, 5, 999]), z)[0]
        for i, ti in enumerate((0, 5, 999)):
            one = schedule.ddpm_reverse_step(sched, torch.from_numpy(eps[i]),
                                             torch.from_numpy(x[i]), ti, z[i])[0]
            assert torch.equal(rows[i], one)


def test_step_timer_summary_matches_jax():
    times = [0.012, 0.5, 0.031, 0.0007, 0.2, 0.09]
    timer, jtimer = profiling.StepTimer(), jax_profiling.StepTimer()
    timer.times, jtimer.times = list(times), list(times)
    assert timer.summary() == jtimer.summary()
    assert profiling.StepTimer().summary() == jax_profiling.StepTimer().summary() == {}
    timer = utils.StepTimer()
    for block_on in (None, torch.ones(3), [torch.ones(2)], {"x": torch.ones(1)}):
        timer.start()
        timer.stop(block_on=block_on)
    assert timer.summary()["steps"] == 4 and timer.summary()["total_s"] >= 0


def test_trace_and_round_trip(tmp_path):
    with utils.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0).sum().item()
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()
    t0 = time.perf_counter()
    rt = profiling.measure_round_trip(iters=3, device="cpu")
    assert 0 < rt <= time.perf_counter() - t0


def _wandb_stub(calls):
    fake = types.ModuleType("wandb")
    run = types.SimpleNamespace(
        log=lambda d, step=None: calls.append(("log", sorted(d), step)),
        finish=lambda: calls.append(("finish",)))
    fake.init = lambda **kw: calls.append(("init", sorted(kw))) or run
    fake.Video = lambda p: ("video", p)
    fake.Image = lambda p: ("image", p)
    return fake


def test_tracker_matches_jax(tmp_path, monkeypatch):
    """The event records (metrics, artifacts) and the W&B calls of the same
    run, port and JAX; ``use_wandb=None`` follows ``WANDB_MODE``."""
    calls = {"port": [], "jax": []}
    records = {}
    for name, cls in (("port", RunTracker), ("jax", JaxTracker)):
        monkeypatch.setitem(sys.modules, "wandb", _wandb_stub(calls[name]))
        monkeypatch.delenv("WANDB_MODE", raising=False)
        with cls(tmp_path / name, config={"A": 1}, use_wandb=None) as tr:
            tr.log({"loss": torch.tensor(0.5) if name == "port" else 0.5})
            tr.log({"loss": 0.25}, step=7)
            for f in ("a.gif", "b.png", "c.svg", "d.txt"):
                tr.log_artifact(tmp_path / f, kind=f[0])
        records[name] = [{k: v for k, v in json.loads(ln).items() if k != "time"}
                         for ln in open(tmp_path / name / "events.jsonl")]
        records[name] = json.loads(json.dumps(records[name]).replace(str(tmp_path / name), ""))
    assert records["port"] == [
        {k: v for k, v in r.items()} for r in records["jax"]]
    assert calls["port"] == calls["jax"] and ("finish",) in calls["port"]
    assert (tmp_path / "port" / "config.json").read_text() == \
        (tmp_path / "jax" / "config.json").read_text()
    monkeypatch.setenv("WANDB_MODE", "disabled")
    before = len(calls["port"])
    RunTracker(tmp_path / "off", use_wandb=None).finish()
    assert len(calls["port"]) == before
