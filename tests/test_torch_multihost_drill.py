"""The port's multi-process rehearsal (``tools/dryrun_multihost_torch.py``)
against the JAX tool (``tools/dryrun_multihost.py``) on the CPU.

  * its corpus (``_write_corpus``) and each process's rows
    (``_local_rows`` over ``host_shard``) are the JAX tool's arrays;
  * a 2-process gloo run: the losses bitwise equal across the processes and
    within 1e-4 of the one-process control, the checkpoint committed once
    and restored equal on both;
  * the control's 3 steps within 1e-4 of the JAX tool's steps on the same
    rows, from the JAX initial weights (``state_dict_from_jax``) with
    ``ddpm_loss``'s t and ε drawn from JAX's ``PRNGKey(100 + i)``.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.train.trainer import StepDraws
from tools import dryrun_multihost as jax_tool
from tools import dryrun_multihost_torch as port_tool

LOSS_ATOL = 1e-4  # the JAX tool's control tolerance (dryrun_multihost.py:22-24)

@pytest.fixture(autouse=True)
def two_threads(monkeypatch):
    """Two intra-op threads for this process's work and each process a
    drill spawns: the models are tiny, and the test workers share the
    host's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)



@pytest.mark.parametrize("channels", [3, 4])
def test_corpus_and_rows_are_the_jax_tools(channels, tmp_path):
    jax_files = jax_tool._write_corpus(str(tmp_path / "jax"), channels=channels)
    port_files = port_tool._write_corpus(str(tmp_path / "port"), channels=channels)
    assert [os.path.basename(f) for f in jax_files] == \
        [os.path.basename(f) for f in port_files]
    for a, b in zip(jax_files, port_files):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            want, got = pickle.load(fa), pickle.load(fb)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    if channels == 4:
        return
    from crowdmod_tpu.data.prefetch import host_shard as jax_host_shard
    from crowdmod_tpu_torch.data.prefetch import host_shard

    for p in range(2):
        want = jax_tool._local_rows(jax_host_shard(jax_files, p, 2), port_tool.ROWS_PER_PROC)
        got = port_tool._local_rows(host_shard(port_files, p, 2), port_tool.ROWS_PER_PROC)
        for w, g in zip(want, got):
            assert g.shape == w.shape and np.array_equal(g, np.asarray(w))


def test_two_processes_over_gloo(tmp_path):
    """The orchestrator's own 2-process run: every check of its report, the
    workers' losses identical, the checkpoint once on disk."""
    out = tmp_path / "dryrun"
    rc = port_tool.main(["--nprocs", "2", "--device", "cpu", "--out", str(out),
                         "--timeout", "240"])
    report = json.loads((out / "report.json").read_text())
    assert rc == 0 and report["ok"], report
    assert report["same_across_processes"] and report["matches_single_process_control"]
    assert report["backend"] == "gloo" and report["checkpoint_roundtrip"]
    workers = [json.loads((out / f"worker_{i}.json").read_text()) for i in range(2)]
    assert workers[0]["losses"] == workers[1]["losses"] == report["losses"]
    assert len(report["losses"]) == 3 and np.all(np.isfinite(report["losses"]))
    np.testing.assert_allclose(report["losses"], report["control_losses"], rtol=0,
                               atol=LOSS_ATOL)
    assert sorted(os.listdir(out / "ckpt")) == ["metadata.json", "state.pt"]
    assert not [p for p in os.listdir(out) if p.endswith((".pending", ".meta.json"))]
    meta = json.loads((out / "ckpt" / "metadata.json").read_text())
    assert meta == {"harness": "dryrun_multihost", "nprocs": 2}


def test_control_steps_match_the_jax_tool(tmp_path):
    """One process emulating both shards, from the JAX tool's initial
    weights and its step keys' draws: the 3 losses within 1e-4 of the JAX
    tool's ``_train_schedule`` on the same files."""
    files = port_tool._write_corpus(str(tmp_path / "data"), n_files=4)
    state0, _, _ = jax_tool._train_schedule(2, files, emulate=True, fsdp=False, steps=0)
    init = jax.tree.map(np.asarray, state0.params)["params"]
    _, want, _ = jax_tool._train_schedule(2, files, emulate=True, fsdp=False, steps=3)

    rows = 2 * port_tool.ROWS_PER_PROC
    shape = (rows, port_tool.FUT, port_tool.H, port_tool.W, 3)
    draws = []
    for i in range(3):
        kt, kq = jax.random.split(jax.random.PRNGKey(100 + i))
        t = jax.random.randint(kt, (rows,), 0, 50)
        eps = jax.random.normal(kq, shape, jnp.float32)
        draws.append(StepDraws(t=torch.from_numpy(np.array(t)).long(),
                               eps=torch.from_numpy(np.array(eps))))
    _, got, _ = port_tool._train_schedule(
        2, files, emulate=True, fsdp=False, steps=3, device="cpu",
        weights=state_dict_from_jax(init), draws=draws)
    print("JAX", want, "port", got)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
