"""A seeded request gets the same future from the port's ``Predictor`` (the
eager sampler: ``serve``) as from the artifact of the same weights
(``ArtifactPredictor``: ``serve --artifact``), as both paths of the JAX
package sample from ``PRNGKey(seed)``.  Both draw ``normal(seed, step)``:
step −1 for x_T (FM's x0), the timestep for each step's noise."""

import os

import numpy as np
import pytest

from crowdmod_tpu_torch.export_artifact import ArtifactPredictor, export_sampler
from crowdmod_tpu_torch.serving import Predictor
from crowdmod_tpu_torch.train import checkpoint as ckpt
from test_torch_export import ROUND_TRIP_ATOL, _past, tiny_trainer

CASES = {
    "DDPM-DiT DDIM-eta Sparsity": ("DDPM-DiT", {}),
    "DDPM-DiT ancestral T12": ("DDPM-DiT", {"SAMPLER": "DDPM", "TIMESTEPS": 12}),
    "FM-DiT Euler": ("FM-DiT", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_seeded_predictor_equals_its_artifact(case, tmp_path):
    arch, over = CASES[case]
    trainer = tiny_trainer(arch, root=tmp_path, **over)
    cfg = trainer.cfg
    trainer.save(cfg.DATA_FS.SAVE_DIR, "000")
    artifact = str(tmp_path / "sampler.pt2")
    export_sampler(trainer, artifact, batch_size=2)
    pred = Predictor(cfg, arch, os.path.join(cfg.DATA_FS.SAVE_DIR,
                                             ckpt.checkpoint_name(cfg, arch, "000")),
                     device="cpu", batch_buckets=(2,))
    served = ArtifactPredictor([artifact])
    past = _past(2, seed=3)
    for seed in (3, 4):
        got = pred.predict(past, seed=seed)
        want = served.predict(past, seed=seed)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=ROUND_TRIP_ATOL)
    assert np.abs(pred.predict(past, seed=3) - pred.predict(past, seed=4)).max() > 1e-4
