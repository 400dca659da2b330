"""Port parity: the metric suite (``metrics/functional.py``,
``metrics/generator.py``) and the trainer's metric protocol
(``select_ids``, ``select_past``, ``generate_metrics``) against the JAX
package on the CPU.

The same numpy arrays, random and walker fields from a seed, go through
both packages.  Tolerances, each the port against the JAX function:

  * PSNR ≤ 1e-4 relative + 1e-4 dB (a PSNR near 0 dB, a prediction as
    far off as the data's range, holds to the latter); an empty mask NaN
    on both sides;
  * SSIM ≤ 1e-5 absolute (the box filter is a difference of cumulative
    sums, which XLA and PyTorch add in other orders);
  * TV and RE_DENSITY ≤ 1e-4 relative to the sums they compare (each is a
    difference of two sums of a few hundred terms, added in other orders);
  * the 2-D histogram exact, and the 1-D histogram's bins exact, apart
    from elements whose magnitude or angle lies within float error of a bin
    edge (``log2`` and ``atan2`` differ from XLA's in the last bits): each
    such element is counted, and only its sequence may differ; the 1-D
    values, sums of magnitude^0.5, within 1e-5 of the vector's largest;
  * Bhattacharyya ≤ 1e-6 absolute on the same inputs (in the engine, on
    the two packages' histograms, also 1e-5 relative); everything else
    exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.data import ingest as jax_ingest
from crowdmod_tpu.data.synthetic import synthetic_walkers
from crowdmod_tpu.metrics import functional as J
from crowdmod_tpu.metrics import generator as jax_generator
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.data import ingest
from crowdmod_tpu_torch.metrics import functional as T
from crowdmod_tpu_torch.metrics import generator
from crowdmod_tpu_torch.train.trainer import ProtocolDraws, Trainer

N, FR, H, W, C = 8, 3, 12, 36, 3
CHUNK = 4
PSNR_RTOL = 1e-4
PSNR_ATOL = 1e-4  # dB
SSIM_ATOL = 1e-5
SUM_RTOL = 1e-4
HIST1D_RTOL = 1e-5
BHATT_ATOL = 1e-6
# XLA's sqrt and log2 differ from PyTorch's in the last bit, and each cell's
# min-max scale (255 over the cell's range) magnifies a last-bit difference
# of the cell's minimum.
MAG_ATOL = 2e-5
CSV_ATOL = 1e-4  # the files hold 4 decimals


def _stacks(kind):
    rng = np.random.default_rng(0 if kind == "random" else 1)
    if kind == "random":
        gt = rng.normal(size=(N, FR, H, W, C)).astype(np.float32)
        gt[..., 0] = np.abs(gt[..., 0]) * 2
        gt[0, 1, ..., 0] = 0.0  # an empty density mask: NaN masked PSNR
    else:  # angles 0 and π and zero velocities: bin edges, exactly
        gt = synthetic_walkers(N, H, W, FR)
    pred = (gt + 0.1 * rng.normal(size=gt.shape)).astype(np.float32)
    return pred, gt


@pytest.fixture(scope="module", params=["random", "walker"])
def stacks(request):
    pred, gt = _stacks(request.param)
    return request.param, pred, gt


def _j(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_angle_edges_are_jax_bits():
    want = _j(jnp.linspace(-jnp.pi, jnp.pi, 17))
    got = T._angle_edges(16).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    with pytest.raises(ValueError, match="16 angle bins"):
        T._angle_edges(8)


def test_ranges_psnr_and_mask(stacks):
    _, pred, gt = stacks
    r = _j(J.channel_ranges(jnp.asarray(gt)))
    assert np.array_equal(r, T.channel_ranges(_t(gt)).numpy())
    for masked in (False, True):
        want = _j(J.psnr_over_time(jnp.asarray(pred), jnp.asarray(gt),
                                   jnp.asarray(r), masked=masked))
        got = T.psnr_over_time(_t(pred), _t(gt), _t(r), masked=masked).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=PSNR_RTOL, atol=PSNR_ATOL)
    if stacks[0] == "random":
        assert np.isnan(got[0, 1]).all() and np.isfinite(got[1:]).all()


def test_ssim(stacks):
    _, pred, gt = stacks
    r = _j(J.channel_ranges(jnp.asarray(gt)))
    want = _j(J.ssim_over_time(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(r)))
    got = T.ssim_over_time(_t(pred), _t(gt), _t(r)).numpy()
    np.testing.assert_allclose(got, want, atol=SSIM_ATOL, rtol=0)
    # The symmetric pad repeats the edge pixel; reflect would not.
    x = np.arange(20, dtype=np.float32).reshape(4, 5)
    want_pad = np.pad(x, 3, mode="symmetric")
    got_pad = T._symmetric_pad(T._symmetric_pad(_t(x), 3, -2), 3, -1).numpy()
    assert np.array_equal(got_pad, want_pad)


def test_tv_and_re_density(stacks):
    _, pred, gt = stacks
    want = _j(J.tv_over_time(jnp.asarray(pred), jnp.asarray(gt)))
    got = T.tv_over_time(_t(pred), _t(gt)).numpy()

    scales = _sum_scales(pred, gt, CHUNK)
    assert (np.abs(got - want).reshape(N, -1) <= SUM_RTOL * scales["TV_OVER_TIME"]).all()
    want = _j(J.re_density(jnp.asarray(pred), jnp.asarray(gt)))
    got = T.re_density(_t(pred), _t(gt)).numpy()
    assert (np.abs(got - want) <= SUM_RTOL * scales["RE_DENSITY"]).all()


@pytest.mark.parametrize("op", ["max", "min"])
def test_chunk_reduce(stacks, op):
    _, pred, _ = stacks
    x = pred[:, :, 0, 0, :]
    want = _j(J.chunk_reduce(jnp.asarray(x), CHUNK, op=op))
    assert np.array_equal(T.chunk_reduce(_t(x), CHUNK, op=op).numpy(), want)
    with pytest.raises(ValueError) as jax_err:
        J.chunk_reduce(jnp.asarray(x[:7]), CHUNK, op=op)
    with pytest.raises(ValueError) as port_err:
        T.chunk_reduce(_t(x[:7]), CHUNK, op=op)
    assert str(port_err.value) == str(jax_err.value)


def _jax_bins(seq):
    """The JAX package's bins of each element of one sequence, by its own
    bucket arithmetic on its own magnitude and angle."""
    mag, angle = J.magnitude_angle(jnp.asarray(seq))
    mv, av = _j(J._volumes(mag, 1, 4)), _j(J._volumes(angle, 1, 4))

    def bucket(x, lo, hi, n):
        idx = np.floor(_j((jnp.asarray(x) - lo) / (hi - lo) * n)).astype(np.int64)
        idx = np.where(x == hi, n - 1, idx)
        return idx, (x >= lo) & (x <= hi)

    mi, mvalid = bucket(mv, 0.0, 8.0, 16)
    ai, avalid = bucket(av, -jnp.pi, jnp.pi, 16)
    edges = jnp.linspace(-jnp.pi, jnp.pi, 17)
    b1 = _j(jnp.searchsorted(edges, av, side="right")) - 1
    return mi * 16 + ai, mvalid & avalid, b1, (b1 >= 0) & (b1 < 16)


def _moved_rows(seqs):
    """Per sequence, the elements whose 2-D or 1-D bin differs between the
    packages, and the largest magnitude and angle difference overall."""
    mv, av = T.motion_volumes(_t(seqs))
    port = [x.numpy() for x in T.motion_bins(mv, av)]
    moved, mag_err, ang_err = [], 0.0, 0.0
    for i, seq in enumerate(seqs):
        jax_b = _jax_bins(seq)
        jm, ja = J.magnitude_angle(jnp.asarray(seq))
        mag_err = max(mag_err, float(np.abs(
            _j(J._volumes(jm, 1, 4)) - mv[i].numpy()).max()))
        ang_err = max(ang_err, float(np.abs(
            _j(J._volumes(ja, 1, 4)) - av[i].numpy()).max()))
        two = (jax_b[0] != port[0][i]) & (jax_b[1] | port[1][i]) | (jax_b[1] != port[1][i])
        one = (jax_b[2] != port[2][i]) & (jax_b[3] | port[3][i]) | (jax_b[3] != port[3][i])
        moved.append(int(two.sum() + one.sum()))
    return np.array(moved), mag_err, ang_err


def test_motion_features(stacks):
    kind, pred, gt = stacks
    for seqs in (pred, gt):
        moved, mag_err, ang_err = _moved_rows(seqs)
        assert mag_err <= MAG_ATOL and ang_err == 0.0, (mag_err, ang_err)
        same = moved == 0
        print(f"{kind}: {moved.sum()} elements moved bin, in {(~same).sum()} "
              f"of {len(seqs)} sequences")
        assert moved.sum() <= 1e-3 * seqs[..., 0].size
        want2 = _j(jax.vmap(J.motion_feature_2d)(jnp.asarray(seqs)))
        got2 = T.motion_feature_2d(_t(seqs)).numpy()
        assert np.array_equal(got2[same], want2[same])
        want1 = _j(jax.vmap(J.motion_feature_1d)(jnp.asarray(seqs)))
        got1 = T.motion_feature_1d(_t(seqs)).numpy()
        scale = want1.max(-1, keepdims=True)
        assert (np.abs(got1 - want1)[same] <= HIST1D_RTOL * scale[same]).all()
        # The same inputs, the same bits (the histograms are order-free).
        assert np.array_equal(T.motion_feature_1d(_t(seqs)).numpy(), got1)


def test_bhattacharyya_and_mse(stacks):
    _, pred, gt = stacks
    p = _j(jax.vmap(J.motion_feature_1d)(jnp.asarray(pred)))
    q = _j(jax.vmap(J.motion_feature_1d)(jnp.asarray(gt)))
    want_d, want_c = (_j(x) for x in jax.vmap(J.bhattacharyya)(jnp.asarray(q), jnp.asarray(p)))
    got_d, got_c = (x.numpy() for x in T.bhattacharyya(_t(q), _t(p)))
    np.testing.assert_allclose(got_d, want_d, atol=BHATT_ATOL, rtol=0)
    np.testing.assert_allclose(got_c, want_c, atol=BHATT_ATOL, rtol=0)
    want = np.array([_j(J.mse_vec(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(p, q)])
    np.testing.assert_allclose(T.mse_vec(_t(p), _t(q)).numpy(), want, rtol=1e-5)


def _read_csv(path):
    with open(path) as f:
        header = f.readline().strip()
    return header, np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def _tv(x):
    x = x.astype(np.float64)
    return (np.abs(np.diff(x, axis=2)).sum((2, 3))
            + np.abs(np.diff(x, axis=3)).sum((2, 3)))


def _sum_scales(pred, gt, chunk):
    """What each difference-of-sums metric is held to, times SUM_RTOL: the
    sums it compares (TV; RE_DENSITY = |P − G| / (G + eps), its sums over
    |G + eps| times (1 + re); and their chunk aggregates)."""
    p = np.abs(pred[..., 0]).astype(np.float64).sum((2, 3))
    g = np.abs(gt[..., 0]).astype(np.float64).sum((2, 3))
    sum_p, sum_g = (x[..., 0].astype(np.float64).sum((2, 3)) for x in (pred, gt))
    re = (p + g) / np.abs(sum_g + 1e-6) * (1 + np.abs(sum_p - sum_g) / np.abs(sum_g + 1e-6))
    n = len(pred) // chunk
    return {"TV_OVER_TIME": (_tv(pred) + _tv(gt)).reshape(len(pred), -1),
            "RE_DENSITY": re,
            "MIN_RE_DENSITY": re.reshape(n, chunk, -1).max(1)}


def _assert_close(label, name, g, w, scales, atol=0.0):
    """One metric's port values against JAX's, within its tolerance (plus
    ``atol``: the rounding of the CSVs)."""
    if name in scales:
        err = np.abs(g - w)
        assert (err <= SUM_RTOL * scales[name] + atol).all(), (label, name, err.max())
    elif "PSNR" in name:
        np.testing.assert_allclose(g, w, rtol=PSNR_RTOL, atol=PSNR_ATOL + atol,
                                   err_msg=name)
    elif "SSIM" in name:
        np.testing.assert_allclose(g, w, atol=SSIM_ATOL + atol, rtol=0, err_msg=name)
    elif name.startswith("MF_BHATT"):  # of the histograms' values
        np.testing.assert_allclose(g, w, atol=BHATT_ATOL + atol, rtol=HIST1D_RTOL,
                                   err_msg=name)
    else:  # ENERGY, MIN-ENERGY, MF_MSE: sums of squares
        np.testing.assert_allclose(g, w, rtol=SUM_RTOL, atol=atol, err_msg=name)


def _assert_outputs_match(got, want, port_dir, jax_dir, label, pred, gt, chunk,
                          moved_rows):
    """The port's metric arrays and files against the JAX package's: the
    same names, dtypes, NaNs, CSV names, headers and manifest keys; values
    within each metric's tolerance (in the CSVs, also their 4 decimals); the
    MF rows of a sequence that moved a bin excepted."""
    assert set(got) == set(want), label
    scales = _sum_scales(pred, gt, chunk)
    jm = json.loads((jax_dir / "metrics_files.json").read_text())
    pm = json.loads((port_dir / "metrics_files.json").read_text())
    assert pm.keys() == jm.keys() and pm["title"] == jm["title"]
    csvs = sorted(p.name for p in jax_dir.glob("*.csv"))
    assert sorted(p.name for p in port_dir.glob("*.csv")) == csvs
    assert len(csvs) == len(want) == len(jm) - 1
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, (label, name)
        assert np.array_equal(np.isnan(g), np.isnan(w)), (label, name)
        h_p, v_p = _read_csv(pm[name])
        h_j, v_j = _read_csv(jm[name])
        assert h_p == h_j and os.path.basename(pm[name]) == os.path.basename(jm[name])
        assert v_p.shape == v_j.shape == g.reshape(len(g), -1).shape, (label, name)
        assert np.array_equal(np.isnan(v_p), np.isnan(v_j)), (label, name)
        keep = moved_rows == 0 if name.startswith("MF_") else slice(None)
        _assert_close(label, name, g[keep], w[keep], scales)
        _assert_close(f"{label} csv", name, v_p[keep], v_j[keep], scales, atol=CSV_ATOL)


@pytest.mark.parametrize("metric", ["ALL", "PSNR", "MF_BHATT", "ENERGY"])
def test_engine_and_files_match_jax(stacks, metric, tmp_path):
    kind, pred, gt = stacks
    cfg = load_config("4test/ATC.yml")
    jcfg = jax_load_config("4test/ATC.yml")
    jeng = jax_generator.MetricsEngine(jnp.asarray(pred), jnp.asarray(gt), jcfg.METRICS,
                                       output_dir=str(tmp_path / "jax"), past_len=5)
    want = jax_generator.compute_metrics(
        jeng, metric, CHUNK, run_tag="TE2_PL5_FL3_CE000_NA", title="t",
        samples_per_batch=N, boxplots=False)
    peng = generator.MetricsEngine(_t(pred), _t(gt), cfg.METRICS,
                                   output_dir=str(tmp_path / "port"), past_len=5)
    got = generator.compute_metrics(
        peng, metric, CHUNK, run_tag="TE2_PL5_FL3_CE000_NA", title="t",
        samples_per_batch=N)
    moved = _moved_rows(pred)[0] + _moved_rows(gt)[0]
    _assert_outputs_match(got, want, tmp_path / "port", tmp_path / "jax",
                          f"{kind} {metric}", pred, gt, CHUNK, moved)
    assert not list((tmp_path / "port").glob("*.png"))


def test_engine_refuses_and_boxplots_raise(tmp_path):
    pred, gt = _stacks("random")
    cfg = load_config("4test/ATC.yml")
    with pytest.raises(ValueError, match="shape mismatch"):
        generator.MetricsEngine(_t(pred), _t(gt[:4]), cfg.METRICS)
    eng = generator.MetricsEngine(_t(pred), _t(gt), cfg.METRICS,
                                  output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="not in"):
        generator.compute_metrics(eng, "MOTION", CHUNK)
    with pytest.raises(NotImplementedError, match="item 17"):
        generator.compute_metrics(eng, "PSNR", CHUNK, boxplots=True)
    # The CSVs are written before the plots are asked for.
    assert (tmp_path / "metrics_files.json").exists()


# ---------------------------------------------------------------------------
# The trainer's metric protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, nsamples, chunk, same_past", [
    (8, 8, 1, False),    # one permutation
    (8, 8, 2, False),    # repeated past: first 4 ids twice each
    (3, 8, 2, False),    # a ragged batch wraps around
    (8, 6, 1, True),     # same past: the first id everywhere
    (5, 12, 4, True),
])
def test_select_ids_and_past_match_jax(n, nsamples, chunk, same_past):
    key = jax.random.PRNGKey(n * 100 + nsamples)
    perm = _j(jax.random.permutation(key, n))
    want = _j(JaxTrainer.select_ids(n, nsamples, key, same_past=same_past, chunk=chunk))
    got = Trainer.select_ids(n, nsamples, perm=torch.from_numpy(perm.copy()),
                             same_past=same_past, chunk=chunk)
    assert got.tolist() == want.tolist()
    past = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2)
    p, f, idx = Trainer.select_past(past, -past, nsamples, perm=perm.copy(),
                                    same_past=same_past, chunk=chunk)
    assert idx.tolist() == want.tolist()
    assert torch.equal(p, past[want]) and torch.equal(f, -past[want])
    # Drawn from a generator: a permutation's prefix, exactly nsamples rows.
    drawn = Trainer.select_ids(n, nsamples, torch.Generator().manual_seed(0),
                               chunk=chunk)
    assert drawn.shape == (nsamples,) and set(drawn.tolist()) <= set(range(n))
    with pytest.raises(ValueError, match="generator"):
        Trainer.select_ids(n, nsamples)


def _jax_protocol_draws(seed, n, nsamples, shape, timesteps, batches):
    """The JAX ``generate_metrics`` key stream, as the port's draws: each
    batch's permutation and its DDPM sampler's x_T and step noise."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(batches):
        key, ksel, ksamp = jax.random.split(key, 3)
        k_init, k_loop = jax.random.split(ksamp)
        draws = {None: jax.random.normal(k_init, shape, jnp.float32)}
        for t in range(timesteps):
            draws[t] = jax.random.normal(jax.random.fold_in(k_loop, t), shape,
                                         jnp.float32)
        out.append(ProtocolDraws(
            perm=torch.from_numpy(_j(jax.random.permutation(ksel, n))),
            noise=lambda t, d=draws: torch.from_numpy(np.array(d[t]))))
    return out


def test_generate_metrics_matches_jax(workspace, tmp_path):
    """The port's ``generate_metrics`` against the JAX ``Trainer``'s on the
    workspace's pickles: the same weights (carried by ``state_dict_from_jax``),
    the JAX selection and sampler noise injected, the same samples within
    1e-4, the same metric arrays and CSVs."""
    ws, seed, chunk, arch = workspace, 42, 2, "DDPM-UNet"
    jcfg = jax_load_config(ws["cfg"], ws["list"])
    cfg = load_config(ws["cfg"], ws["list"])
    jtr = JaxTrainer(jcfg, arch, seed=seed, run_dir=str(tmp_path / "jrun")).setup()
    rng = np.random.default_rng(7)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0, 0.05, np.shape(a)).astype(np.float32), jtr.state.params)
    jtr.state = jtr.state.replace(params=params)
    samples = {"jax": [], "port": []}
    j_sample = jtr.sample
    jtr.sample = lambda past, key, **kw: samples["jax"].append(
        _j(j_sample(past, key, **kw))) or jnp.asarray(samples["jax"][-1])

    jax_ds = jax_ingest.get_test_dataset(jcfg, 3, seed=seed)
    want = jtr.generate_metrics(jax_ds, chunk=chunk, output_dir=str(tmp_path / "jax"),
                                seed=seed)

    tr = Trainer(cfg, arch, device="cpu", seed=seed, run_dir=str(tmp_path / "run")).setup()
    sd = state_dict_from_jax(params["params"])
    tr.model.load_state_dict(sd)
    assert tr.ema_model is None and jtr.state.ema_params is None
    ds = ingest.get_test_dataset(cfg, 3, seed=seed, device="cpu")
    nsamples = cfg.DATASET.BATCH_SIZE * chunk
    shape = (nsamples, 3, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    draws = iter(_jax_protocol_draws(seed, min(len(ds), nsamples), nsamples, shape,
                                     cfg.MODEL.DDPM.TIMESTEPS, 1))
    p_sample, selected = tr.sample, []
    tr.sample = lambda *a, **kw: samples["port"].append(p_sample(*a, **kw)) or \
        samples["port"][-1]
    tr.select_past = lambda *a, **kw: selected.append(Trainer.select_past(*a, **kw)) \
        or selected[-1]
    got = tr.generate_metrics(ds, chunk=chunk, output_dir=str(tmp_path / "port"),
                              seed=seed, draws=lambda: next(draws))

    assert len(samples["port"]) == len(samples["jax"]) == 1
    pred = samples["port"][0].numpy()
    np.testing.assert_allclose(pred, samples["jax"][0], atol=1e-4, rtol=0)
    moved = _moved_rows(pred[..., :3])[0]
    print(f"generate_metrics: {moved.sum()} elements moved bin")
    gt = selected[0][1][..., :3].numpy()
    _assert_outputs_match(got, want, tmp_path / "port", tmp_path / "jax",
                          "generate_metrics", pred[..., :3], gt, chunk, moved)
    title = json.loads((tmp_path / "port" / "metrics_files.json").read_text())["title"]
    assert title == f"{nsamples} samples in total (BS:4, Rep:{chunk}, TB:1)-({arch})"
