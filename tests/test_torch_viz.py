"""The port's plots (``crowdmod_tpu_torch.viz``) against the JAX package's:
the same arrays (and the same overlays) through each JAX renderer and its
port counterpart give byte-equal files (SVG with ``SOURCE_DATE_EPOCH`` and
``svg.hashsalt`` fixed, PNG, GIF); the overlay metrics computed in PyTorch
match JAX's; ``compare`` and ``view`` write JAX's summary, figures and
HTML from the same directories."""

import json
import os
import time

import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.viz import compare_models as jax_compare
from crowdmod_tpu.viz import html_viewer as jax_viewer
from crowdmod_tpu.viz import plot_crowd as jax_crowd
from crowdmod_tpu.viz import plot_metrics as jax_metrics
from crowdmod_tpu.viz import plot_samples as jax_samples
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.viz import (
    compare_models,
    html_viewer,
    plot_crowd,
    plot_metrics,
    plot_samples,
    plotting_unavailable,
)

GRID = {"MACROPROPS": {"ROWS": 8, "COLS": 12}, "MODEL": {"NSAMPLES4PLOTS": 2}}


@pytest.fixture(autouse=True)
def fixed_svg(monkeypatch):
    """matplotlib's SVG date and ids fixed, so two renders are comparable."""
    import matplotlib

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    monkeypatch.setitem(matplotlib.rcParams, "svg.hashsalt", "crowdmod")


def _cfgs():
    return (load_config("4test/ATC.yml").updated(GRID),
            jax_load_config("4test/ATC.yml").updated(GRID))


def _seqs(n=2, p=5, f=3, h=8, w=12, c=4, seed=0):
    rng = np.random.default_rng(seed)
    past = rng.uniform(0, 2, (n, p, h, w, c)).astype(np.float32)
    fut = rng.uniform(0, 2, (n, f, h, w, c)).astype(np.float32)
    pred = fut + rng.normal(0, 0.1, fut.shape).astype(np.float32)
    return past, fut, pred


def _same_bytes(a, b):
    assert os.path.basename(a) == os.path.basename(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), f"{a} and {b} differ"


def test_plotting_available_here():
    assert plotting_unavailable() is None


def test_frame_indexes_and_name_helpers():
    for past, fut in ((5, 3), (4, 3), (2, 1)):
        for mode in plot_samples.PLOT_PASTS:
            assert plot_samples.frame_indexes(past, fut, mode) == \
                jax_samples.frame_indexes(past, fut, mode)
    assert plot_samples.FIGSIZE_MAP == jax_samples.FIGSIZE_MAP
    names = ["DDPM-UNet_ATC_TE200_DDIM_10", "DDPM-UNet_ATC_TE200", "m_DDIM_100",
             "m_DDIM_2", "m_plain", "FM-DiT_x_DDIM-5"]
    assert [plot_crowd.make_short_name(n) for n in names] == \
        [jax_crowd.make_short_name(n) for n in names]
    assert sorted(names, key=plot_crowd.ddim_sort_key) == \
        sorted(names, key=jax_crowd.ddim_sort_key)


def test_overlay_metrics_match_jax():
    """PSNR / masked PSNR within 1e-4 dB, SSIM and TV within 1e-5
    relative; identical sequences give SSIM 1 and TV 0."""
    cfg, jcfg = _cfgs()
    past, fut, pred = _seqs(n=3)
    pred_seq = np.concatenate([past, pred], axis=1)
    gt_seq = np.concatenate([past, fut], axis=1)
    gt_seq[0, :, :3, :4, 0] = 0.0  # a masked region
    got = plot_samples.overlay_metrics(torch.from_numpy(pred_seq), torch.from_numpy(gt_seq),
                                       cfg.METRICS, cfg.MACROPROPS.EPS)
    want = jax_samples.overlay_metrics(pred_seq, gt_seq, jcfg.METRICS, jcfg.MACROPROPS.EPS)
    assert got.keys() == want.keys()
    for name in ("psnr", "mpsnr"):
        assert got[name].shape == want[name].shape == (3, 8, 3)
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-4)
    for name in ("ssim", "tv"):
        scale = np.abs(want[name]).max()
        assert np.abs(got[name] - want[name]).max() <= 1e-5 * scale
    same = plot_samples.overlay_metrics(torch.from_numpy(gt_seq), torch.from_numpy(gt_seq),
                                        cfg.METRICS, cfg.MACROPROPS.EPS)
    assert np.allclose(same["ssim"], 1.0, atol=1e-5) and np.allclose(same["tv"], 0.0)


@pytest.mark.parametrize("plot_mprop", ["Density", "Density&Vel", "Uncertainty"])
def test_plot_static_and_density_bytes(tmp_path, plot_mprop):
    cfg, jcfg = _cfgs()
    past, fut, pred = _seqs()
    got = plot_samples.setup_predictions_plot(
        torch.from_numpy(pred), torch.from_numpy(past), torch.from_numpy(fut),
        plot_samples.MacropropPlotter(cfg, str(tmp_path / "port"), run_tag="T1"),
        plot_type="Static", plot_mprop=plot_mprop, plot_past="Last2")
    want = jax_samples.setup_predictions_plot(
        pred, past, fut, jax_samples.MacropropPlotter(jcfg, str(tmp_path / "jax"), run_tag="T1"),
        plot_type="Static", plot_mprop=plot_mprop, plot_past="Last2")
    assert got["static"].endswith(".svg")
    _same_bytes(got["static"], want["static"])
    assert len(got["density"]) == len(want["density"]) == 2
    for a, b in zip(got["density"], want["density"]):
        _same_bytes(a, b)


def test_plot_dynamic_bytes(tmp_path):
    """The same sequences and overlays dict: byte-equal GIFs (the overlay
    text of the predicted GIFs included)."""
    cfg, jcfg = _cfgs()
    past, fut, pred = _seqs()
    _, _, seqs = plot_samples.interleave(torch.from_numpy(pred), torch.from_numpy(past),
                                         torch.from_numpy(fut))
    seqs = seqs.numpy()
    overlays = jax_samples.overlay_metrics(seqs[0::2], seqs[1::2], jcfg.METRICS,
                                           jcfg.MACROPROPS.EPS)
    got = plot_samples.MacropropPlotter(cfg, str(tmp_path / "port"), fps=4).plot_dynamic(
        seqs, overlays)
    want = jax_samples.MacropropPlotter(jcfg, str(tmp_path / "jax"), fps=4).plot_dynamic(
        seqs, overlays)
    assert [os.path.basename(p) for p in got] == [
        "mprops_seq_1.gif", "mprops_GT_seq_1.gif", "mprops_seq_2.gif", "mprops_GT_seq_2.gif"]
    for a, b in zip(got, want):
        _same_bytes(a, b)
    with pytest.raises(ValueError, match="plot_type"):
        plot_samples.render_predictions(
            plot_samples.MacropropPlotter(cfg, str(tmp_path / "x")), seqs, overlays,
            plot_type="Sideways")


def test_crowd_renderers_bytes(tmp_path):
    rng = np.random.default_rng(0)
    seq = rng.uniform(0, 3, (4, 8, 12, 4)).astype(np.float32)
    c = plot_crowd.Crowd.from_frame(seq[0])
    assert c.rho.shape == (8, 12) and c.mu_v.shape == (8, 12, 2)
    assert plot_crowd.max_rho(seq) == jax_crowd.max_rho(seq)
    x, y = rng.random(50) * 12, rng.random(50) * 8
    for mod, d in ((plot_crowd, tmp_path / "port"), (jax_crowd, tmp_path / "jax")):
        d.mkdir()
        mod.render_sequence_gif(seq, str(d / "seq.gif"), fps=4)
        mod.render_pred_vs_gt_gif(seq, seq[::-1], str(d / "cmp.gif"), fps=4,
                                  draw_unc_pred=True)
        mod.draw_pred_vs_gt(seq[0], seq[1], "t=0", 3.0, save_path=str(d / "pair.png"))
        mod.plot_losses([1.0, 0.5, 0.3], [1.1, None, 0.4], "unit", str(d / "losses.png"))
        mod.plot_people_density(x, y, (0.0, 8.0), "density", save_path=str(d / "dens.png"),
                                grid_hw=(8, 12))
        mod.plot_rotation_comparison(x, y, y, x, 0.5, str(d / "rot.png"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6
    for name in names:
        _same_bytes(tmp_path / "port" / name, tmp_path / "jax" / name)


def _metric_data(seed=0, n=12):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(0, 1, s)  # noqa: E731
    return {"PSNR": 20 + 10 * u(n, 3), "MAX_PSNR": 25 + 10 * u(n // 2, 3),
            "SSIM": u(n, 3), "MAX_SSIM": u(n // 2, 3), "MF_MSE": u(n, 2),
            "MF_BHATT_COEF": u(n, 2), "MF_BHATT_DIST": u(n, 2),
            "ENERGY": u(n, 2), "MIN-ENERGY": u(n // 2, 2),
            "RE_DENSITY": np.concatenate([u(n - 1, 3), [[2e6, np.inf, 0.5]]]),
            "MIN_RE_DENSITY": u(n // 2, 3)}


def test_metric_boxplots_bytes(tmp_path):
    """save_metric_boxplots (every BP_*.png, RE_DENSITY at 2e6 with an
    infinity) and the motion histograms."""
    data = _metric_data()
    plot_metrics.save_metric_boxplots(data, {}, str(tmp_path / "port"), "t")
    jax_metrics.save_metric_boxplots(data, {}, str(tmp_path / "jax"), "t")
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["BP_BHATT.png", "BP_ENERGY.png", "BP_MF_MSE.png", "BP_PSNR.png",
                     "BP_RE_DENSITY.png", "BP_SSIM.png"]
    assert names == sorted(os.listdir(tmp_path / "jax"))
    hist = np.random.default_rng(1).uniform(0, 1, (8, 16))
    for mod, d in ((plot_metrics, tmp_path / "port"), (jax_metrics, tmp_path / "jax")):
        mod.plot_motion_hist2d(hist, str(d / "h2.png"), vmax=0.9)
        mod.plot_motion_hist1d(hist[0], str(d / "h1.png"))
    for name in names + ["h1.png", "h2.png"]:
        _same_bytes(tmp_path / "port" / name, tmp_path / "jax" / name)


def test_boxplot_huge_range_bytes(tmp_path):
    """A metric spanning 1e6+ with a fixed tick step renders in bounded time
    (past 200 ticks matplotlib's locator takes over), as JAX's does."""
    data = {"re": np.array([0.1, 2.0, 1.5e6, 3.0e6]), "inf": np.array([np.inf, 1.0, 2.0])}
    t0 = time.time()
    plot_metrics.boxplot(data, "huge-range", str(tmp_path / "bp.png"), ytick_step=2)
    assert time.time() - t0 < 30
    (tmp_path / "jax").mkdir()
    jax_metrics.boxplot(data, "huge-range", str(tmp_path / "jax" / "bp.png"), ytick_step=2)
    _same_bytes(tmp_path / "bp.png", tmp_path / "jax" / "bp.png")


def _model_dir(root, name, offset=0.0):
    d = root / name
    d.mkdir(parents=True)
    rng = np.random.default_rng(sum(map(ord, name)))
    manifest = {"title": name}
    for metric, cols in [("PSNR", "rho,vx,vy"), ("SSIM", "rho,vx,vy"),
                         ("MF_BHATT_COEF", "c2,c1"), ("MF_BHATT_DIST", "d2,d1")]:
        data = rng.uniform(0, 1, (20, len(cols.split(",")))) + offset
        p = d / f"{metric}_NS64_{name}.csv"
        np.savetxt(p, data, delimiter=",", header=cols, comments="", fmt="%.4f")
        manifest[metric] = str(p)
    (d / "metrics_files.json").write_text(json.dumps(manifest))
    return str(d)


def test_compare_matches_jax(tmp_path, capsys):
    dirs = [_model_dir(tmp_path, "DDPM-UNet_DDIM_10"), _model_dir(tmp_path, "DDPM-UNet"),
            _model_dir(tmp_path, "FM-UNet", offset=0.3)]
    for name, data in compare_models.load_manifest(dirs[0]).items():
        np.testing.assert_array_equal(data, jax_compare.load_manifest(dirs[0])[name])
    got = compare_models.compare_models(dirs, str(tmp_path / "port"))
    want = jax_compare.compare_models(dirs, str(tmp_path / "jax"))
    assert got.keys() == want.keys() == {"PSNR", "SSIM", "BHATT", "summary"}
    for k in got:
        _same_bytes(got[k], want[k])
    summary = open(got["summary"]).read().splitlines()
    assert summary[0].startswith("model,") and len(summary) == 4
    # The command: the same files, and the same printout up to the paths.
    assert compare_models.run([*dirs, "--output-dir", str(tmp_path / "p2"),
                               "--metrics", "PSNR"]) == 0
    out = capsys.readouterr().out
    assert jax_compare.run([*dirs, "--output-dir", str(tmp_path / "j2"),
                            "--metrics", "PSNR"]) == 0
    assert out.replace("p2", "j2") == capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "p2")) == sorted(os.listdir(tmp_path / "j2"))


def _gif_dir(root, name, n_gifs=2, n_frames=3):
    from PIL import Image

    d = root / name
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for g in range(n_gifs):
        frames = [Image.fromarray(rng.integers(0, 255, (16, 24, 3), dtype=np.uint8), "RGB")
                  for _ in range(n_frames)]
        frames[0].save(d / f"mprops_seq_{g + 1}.gif", save_all=True,
                       append_images=frames[1:], duration=200, loop=0)
    return str(d)


@pytest.mark.parametrize("embed", [True, False])
def test_view_html_matches_jax(tmp_path, embed):
    d1 = _gif_dir(tmp_path / "samples", "DDPM-UNet")
    d2 = _gif_dir(tmp_path / "samples", "FM-UNet", n_gifs=1)
    grid = html_viewer.scan_model_dirs([d1, d2])
    assert grid == jax_viewer.scan_model_dirs([d1, d2])
    assert html_viewer.extract_frames(grid["FM-UNet"]["mprops_seq_1"], embed=True) == \
        jax_viewer.extract_frames(grid["FM-UNet"]["mprops_seq_1"], embed=True)
    got = html_viewer.generate_html(grid, str(tmp_path / "port" / "v.html"), embed=embed)
    want = jax_viewer.generate_html(grid, str(tmp_path / "jax" / "v.html"), embed=embed)
    page = open(got).read()
    assert page == open(want).read()
    assert ("data:image/png;base64," in page) == embed and "togglePlay" in page
    if not embed:
        for sub in ("port", "jax"):
            cache = tmp_path / sub / "frames_cache"
            files = sorted(p.relative_to(cache) for p in cache.rglob("*.png"))
            assert len(files) == 9
        for p in (tmp_path / "port" / "frames_cache").rglob("*.png"):
            _same_bytes(p, tmp_path / "jax" / "frames_cache" / p.relative_to(
                tmp_path / "port" / "frames_cache"))


def test_view_command_matches_jax(tmp_path, capsys):
    """--list-models, --models-file and the λ mode, against the JAX
    command's output (up to the output paths)."""
    samples = tmp_path / "samples"
    _gif_dir(samples, "DDPM-UNet")
    _gif_dir(samples, "FM-UNet")
    (samples / "empty").mkdir()
    for lam in ("0.5", "2.0", "1.0"):
        _gif_dir(tmp_path / "sweep", f"run_lambda_{lam}", n_gifs=1)
    models_yml = tmp_path / "models_list.yml"
    models_yml.write_text(yaml.safe_dump({"MODELS": ["FM-UNet", "DDPM-UNet"]}))
    assert html_viewer.load_models_file(str(models_yml), str(samples)) == \
        jax_viewer.load_models_file(str(models_yml), str(samples))
    assert html_viewer.scan_lambda_dirs(str(tmp_path / "sweep")) == \
        jax_viewer.scan_lambda_dirs(str(tmp_path / "sweep"))
    cases = [["--list-models", "--main-models-dir", str(samples)],
             ["--models-file", str(models_yml), "--main-models-dir", str(samples),
              "--output", "{out}/models.html"],
             [str(tmp_path / "sweep"), "--mode", "lambda", "--output", "{out}/lam.html"],
             [str(tmp_path / "nothing")]]
    (tmp_path / "nothing").mkdir()
    for args in cases:
        outs = []
        for mod, sub in ((html_viewer, "port"), (jax_viewer, "jax")):
            (tmp_path / sub).mkdir(exist_ok=True)
            argv = [a.format(out=tmp_path / sub) for a in args]
            outs.append((mod.run(argv),
                         capsys.readouterr().out.replace(str(tmp_path / sub), "OUT")))
        assert outs[0] == outs[1], args
    for name in ("models.html", "lam.html"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
