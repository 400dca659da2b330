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


def test_cross_device_export_runs_without_a_card(tmp_path):
    """``export --device cpu --platform cuda`` on this host without a card
    writes the card's artifact of the DiT's ancestral chain: its sidecar
    says ``cuda``; its program holds a card step's operators (2·DEPTH
    attentions, the fused step, the draw), tanh-GELU and bf16 attention;
    loading it here is refused, naming the artifact's platforms, as the
    JAX package refuses a backend the artifact was not lowered for."""
    import json

    import yaml

    from crowdmod_tpu_torch import cli
    from crowdmod_tpu_torch.export_artifact import ArtifactPredictor, SamplerModule
    from test_torch_export import TINY
    from test_torch_export_cross import assert_cards_program

    trainer = tiny_trainer(root=tmp_path, SAMPLER="DDPM", TIMESTEPS=20)
    trainer.save(trainer.cfg.DATA_FS.SAVE_DIR, "000")
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(trainer.cfg.to_dict()))
    out = tmp_path / "card.pt2"
    assert cli.main(["export", "--config-yml-file", str(cfg_path), "--arch", "DDPM-DiT",
                     "--device", "cpu", "--platform", "cuda", "--batch", "2",
                     "--output", str(out)]) == 0
    meta = json.loads((tmp_path / "card.pt2.json").read_text())
    assert meta["platforms"] == ["cuda"] and meta["format"] == "torch.export"
    assert meta["bytes"] == out.stat().st_size > 0
    facts = assert_cards_program(SamplerModule(trainer, "cuda"), torch.export.load(out),
                                 {"crowdmod::ancestral_update": 1})
    assert facts["body"]["crowdmod::attention"] == 2 * TINY["MODEL"]["DDPM"]["DIT"]["DEPTH"]
    assert facts["gelu"] == {"tanh"}
    assert facts["dtypes"]["crowdmod::attention"] == {torch.bfloat16}
    assert facts["dtypes"]["crowdmod::ancestral_update"] == {torch.float32}
    assert not torch.cuda.is_available()
    for load in (lambda: load_sampler(out), lambda: ArtifactPredictor([str(out)])):
        with pytest.raises(ValueError, match=r"programs for \['cuda'\]"):
            load()
