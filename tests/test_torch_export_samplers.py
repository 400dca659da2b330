"""Artifacts of the DDPM samplers beyond the serving default's, on the CPU:
DPM-Solver++(2M) (the scan's carry holds the previous x0), Distilled at
η = 0 and η = 1, and mass-preservation guidance (ancestral and DDIM-eta;
its closed-form gradient inside the loop).  Each artifact equals the
un-exported ``sampler_fn`` within ``ROUND_TRIP_ATOL`` for two seeds, and
the guided configurations the fast samplers refuse are refused by the
export as by ``Trainer.sample``; cross-device export (``--platform``)
exits 2 naming its ROADMAP item."""

import numpy as np
import pytest
import torch

from crowdmod_tpu_torch.export_artifact import export_sampler, load_sampler, sampler_fn
from test_torch_export import ROUND_TRIP_ATOL, _past, ddpm_case, tiny_trainer

ROUND_TRIPS = ("DPM-Solver", "Distilled-eta0", "Distilled-eta1", "DDPM-mass",
               "DDIM-eta-mass")


@pytest.mark.parametrize("case", ROUND_TRIPS)
def test_artifact_round_trip_matches_sampler_fn(case, tmp_path):
    trainer = tiny_trainer(**ddpm_case(case))
    path = str(tmp_path / "sampler.pt2")
    meta = export_sampler(trainer, path, batch_size=2)
    assert meta["batch_size"] == 2
    sample, _ = load_sampler(path)
    direct = sampler_fn(trainer)
    past = _past(2, seed=1)
    outs = []
    for seed in (7, 8):
        got = sample(past, seed)
        want = direct(torch.from_numpy(past), torch.tensor(seed))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=0, atol=ROUND_TRIP_ATOL)
        outs.append(got)
    if case != "Distilled-eta0" and case != "DPM-Solver":  # these draw x_T only
        assert (outs[0] - outs[1]).abs().max() > 1e-4
    else:
        assert not np.array_equal(outs[0].numpy(), outs[1].numpy())


@pytest.mark.parametrize("over,match", [
    ({"SAMPLER": "DPM-Solver", "GUIDANCE": "Sparsity"}, "does not implement guidance"),
    ({"SAMPLER": "Distilled", "GUIDANCE": "mass_preservation"},
     "Distilled sampler is guidance-free"),
    ({"SAMPLER": "Distilled", "GUIDANCE": "None", "CFG_SCALE": 2.0},
     "Distilled sampler is guidance-free"),
    ({"SAMPLER": "DDIM", "GUIDANCE": "mass_preservation"}, "Sparsity/None guidance only"),
])
def test_guided_configs_the_sampler_refuses_are_refused_by_the_export(over, match):
    trainer = tiny_trainer(**{"TIMESTEPS": 12, **over})
    with pytest.raises(ValueError, match=match):
        trainer.sample(_past(1))
    with pytest.raises(ValueError, match=match):
        sampler_fn(trainer)


def test_cross_device_export_is_refused_naming_its_item(capsys):
    from crowdmod_tpu_torch import cli

    assert cli.main(["export", "--output", "x.pt2", "--platform", "cuda",
                     "--device", "cpu"]) == 2
    assert "item 14" in capsys.readouterr().err
