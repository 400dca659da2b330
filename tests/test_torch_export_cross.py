"""Cross-device export (``export_artifact``'s ``platforms``, ``export
--platform``): on this host without a card, the card's program of a tiny
DDPM-UNet (DDIM-eta + Sparsity, its level-0 blocks fused) and DDPM-DiT
(DDIM-eta here; ancestral in ``test_torch_export_samplers.py``, through
the command) is traced on ``meta`` as the card's: the ``crowdmod::``
operators of one denoiser forward on the card's route (counted on an eager
``meta`` forward) in the scan's step, the draws, bf16 compute where the
config asks for it, tanh-GELU, every tensor of the graph on ``cuda:0`` but
the host's seed and step tables, and the weights on the host until load.
An artifact with ``--platform cpu --platform cuda`` holds both programs;
its CPU program runs here bitwise equal to a plain CPU export and to
``sampler_fn``.  On the card ``chip_smoke.py`` holds the cross artifacts
bitwise to the artifacts exported there."""

import collections
import copy
import io
import json
import zipfile

import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

from crowdmod_tpu_torch import cli
from crowdmod_tpu_torch.export_artifact import (
    MULTI_FORMAT,
    SamplerModule,
    export_program,
    export_sampler,
    load_sampler,
    sampler_fn,
)
from crowdmod_tpu_torch.models.backbones import fused_apply
from crowdmod_tpu_torch.ops.kernels.library import tracing_for
from test_torch_export import F, H, P, W, _past, tiny_trainer

BATCH = 2
SHAPE = (BATCH, P, H, W, 3)


def _op(target) -> str | None:
    schema = getattr(target, "_schema", None)
    return schema.name if schema is not None and schema.name.startswith("crowdmod::") else None


class _Calls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _op(func):
            self.counts[_op(func)] += 1
        return func(*args, **(kwargs or {}))


def card_forward_calls(module: SamplerModule) -> collections.Counter:
    """The ``crowdmod::`` operator calls of one eager denoiser forward on
    the card's route: the sampler's model on ``meta`` under
    ``tracing_for("cuda")``."""
    model = copy.deepcopy(module.model).to("meta")
    x = torch.empty((BATCH, F, H, W, 3), device="meta")
    t = torch.zeros(BATCH, dtype=torch.int64, device="meta")
    with torch.no_grad(), tracing_for("cuda"), _Calls() as calls:
        model(x, t, torch.empty(SHAPE, device="meta"))
    return calls.counts


def graph_facts(program) -> dict:
    """The operator calls of the scan's step (``body``) and of the graph
    around it (``top``), the devices of every value, the GELUs' modes and
    the dtypes of each operator's outputs."""
    facts = {"body": collections.Counter(), "top": collections.Counter(),
             "devices": set(), "gelu": set(), "dtypes": collections.defaultdict(set)}
    for name, gm in program.graph_module.named_modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            val = node.meta.get("val")
            for v in val if isinstance(val, (tuple, list)) else [val]:
                if isinstance(v, torch.Tensor):
                    facts["devices"].add(str(v.device))
            if node.op != "call_function":
                continue
            if "gelu" in str(node.target):
                facts["gelu"].add(node.kwargs.get("approximate", "none"))
            op = _op(node.target)
            if op:
                facts["top" if name == "" else "body"][op] += 1
                facts["dtypes"][op].add(val.dtype)
    return facts


def assert_cards_program(module: SamplerModule, program, step_ops: dict) -> dict:
    facts = graph_facts(program)
    want = card_forward_calls(module) + collections.Counter(
        {"crowdmod::normal": 1, **step_ops})
    assert facts["body"] == want
    assert facts["top"] == {"crowdmod::normal": 1}  # x_T
    assert facts["devices"] == {"cuda:0", "cpu"}
    placeholders = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
    devices = {s.target or s.arg.name: placeholders[s.arg.name].device.type
               for s in program.graph_signature.input_specs}
    assert {k for k, d in devices.items() if d == "cpu"} == {"start", "steps", "seed"}
    for table in (program.state_dict, program.constants):
        assert all(t.device.type == "cpu" for t in table.values())  # moved at load
    return facts


def test_cross_export_of_the_unet_is_the_cards_program(monkeypatch):
    """DDIM-eta + Sparsity, the level-0 blocks fused (the tiny grid's
    volume 768 routed): the kernels of a card forward in the step, bf16
    everywhere the config computes in bf16."""
    monkeypatch.setattr(fused_apply, "MIN_FUSED_VOLUME", 512)
    trainer = tiny_trainer("DDPM-UNet", TIMESTEPS=20)  # serving/ATC.yml: bf16
    module = SamplerModule(trainer, "cuda")
    assert module.model.dtype == torch.bfloat16 and trainer.compute_dtype == torch.float32
    program = export_program(module, SHAPE)
    facts = assert_cards_program(module, program, {})
    assert facts["body"]["crowdmod::resblock"] == 3  # encoder 0, decoder 3 and 4
    assert {op for op in facts["body"] if op != "crowdmod::normal"} == {
        "crowdmod::resblock", "crowdmod::conv3d_im2col", "crowdmod::group_norm",
        "crowdmod::attention"}
    for op in ("crowdmod::resblock", "crowdmod::attention"):
        assert facts["dtypes"][op] == {torch.bfloat16}, op
    # the final conv to the 3 output channels computes in f32, as on the card
    assert facts["dtypes"]["crowdmod::conv3d_im2col"] == {torch.bfloat16, torch.float32}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """``export --device cpu --platform cpu --platform cuda`` of the tiny
    DiT (DDIM-eta + Sparsity), and a plain CPU export of it."""
    root = tmp_path_factory.mktemp("cross")
    trainer = tiny_trainer(root=root)
    trainer.save(trainer.cfg.DATA_FS.SAVE_DIR, "000")
    cfg_path = root / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(trainer.cfg.to_dict()))
    out = root / "both.pt2"
    assert cli.main(["export", "--config-yml-file", str(cfg_path), "--arch", "DDPM-DiT",
                     "--device", "cpu", "--batch", str(BATCH), "--platform", "cpu",
                     "--platform", "cuda", "--output", str(out)]) == 0
    plain = root / "plain.pt2"
    export_sampler(trainer, plain, batch_size=BATCH)
    return dict(trainer=trainer, out=out, plain=plain)


def test_both_platforms_artifact_runs_its_cpu_program_bitwise(both):
    meta = json.loads((both["out"].parent / "both.pt2.json").read_text())
    assert meta["platforms"] == ["cpu", "cuda"] and meta["format"] == MULTI_FORMAT
    with zipfile.ZipFile(both["out"]) as zf:
        assert sorted(zf.namelist()) == ["cpu.pt2", "cuda.pt2"]
    sample, got_meta = load_sampler(both["out"])
    assert got_meta == meta
    plain, _ = load_sampler(both["plain"])
    past = _past(BATCH, seed=4)
    got = sample(past, 11)
    assert got.device.type == "cpu" and got.shape == (BATCH, F, H, W, 3)
    assert torch.equal(got, plain(past, 11))
    assert torch.equal(got, sampler_fn(both["trainer"])(torch.from_numpy(past),
                                                         torch.tensor(11)))


def test_both_platforms_artifact_holds_the_cards_program(both):
    """Its ``cuda`` member is the card's program, as an export of that
    platform alone gives it."""
    with zipfile.ZipFile(both["out"]) as zf:
        program = torch.export.load(io.BytesIO(zf.read("cuda.pt2")))
    module = SamplerModule(both["trainer"], "cuda")
    facts = assert_cards_program(module, program, {})
    assert facts["gelu"] == {"tanh"}
    # serving/ATC.yml computes in bf16: the card's program does, the CPU's not
    assert facts["dtypes"]["crowdmod::attention"] == {torch.bfloat16}
    assert both["trainer"].compute_dtype == torch.float32
