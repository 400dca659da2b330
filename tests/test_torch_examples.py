"""The port's quickstarts (``examples/*_torch.py``) run to their end at
their smallest flags on the CPU (``--device cpu``): the library flow (train,
sample three ways, score, render where matplotlib imports), serving over
HTTP, and a data 2 × model 2 mesh with FSDP and remat over gloo."""

import pytest
import torch

from examples import quickstart_torch, scaling_quickstart_torch, serving_quickstart_torch


@pytest.fixture(autouse=True)
def two_threads(monkeypatch):
    """Two intra-op threads for this process's work: the quickstarts'
    models are tiny, and the test workers share the host's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_quickstart(tmp_path, capsys):
    assert quickstart_torch.main(["--device", "cpu", "--epochs", "1", "--timesteps", "20",
                                  "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for name in ("ancestral", "ddim/10", "dpm-solver/15"):
        assert f"{name}: density PSNR" in out
    from crowdmod_tpu_torch.viz import plotting_unavailable

    assert (tmp_path / "out" / "pred.gif").exists() == (plotting_unavailable() is None)


def test_serving_quickstart(tmp_path, capsys):
    assert serving_quickstart_torch.main(["--device", "cpu", "--epochs", "1",
                                          "--timesteps", "10", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("future (1, 3, 8, 12, 3)") == 4
    assert "crowdmod_requests_total" in out and "crowdmod_ready 1" in out


def test_scaling_quickstart(tmp_path, capfd):
    assert scaling_quickstart_torch.main(["--device", "cpu", "--data", "2", "--model", "2",
                                          "--epochs", "1", "--out", str(tmp_path)]) == 0
    out = capfd.readouterr().out
    assert "mesh: {'data': 2, 'model': 2} on gloo" in out
    assert "cut over \"model\"" in out and "scaling quickstart OK" in out
