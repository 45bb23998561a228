"""The serving export on the CPU: ``Predictor.export`` -> ``load_exported``
for RFN (``tiny_rfn_config``, ``chain_impl='sample'``) and SRNN
(``torch_family_utils.config('SRNN')``) at B=2, on weights of the port's
own init (``tests/test_torch_export_jax.py`` holds the program against the
JAX package on converted weights):

* the artifact written to a file and returned as bytes serves the same
  frames from either, and they equal ``Predictor(seed=7).predict`` bit for
  bit (the same program and the same draws, taken from the seed in the
  order recorded at export);
* the exported graph calls the kernels' operators (``rft.glowchain``,
  ``rft.coupling_transform``, ``rft.convlstm_gates``; SRNN the gates);
* the export CLI on a tiny checkpoint written by ``Trainer.checkpoint``
  gives an artifact that serves (as ``tests/test_serving.py`` holds the
  JAX CLI); ``--platforms tpu`` raises; a context of another shape raises;
  a process that never registered the port's operators cannot load the
  artifact.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_family_utils as F
import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.config import TrainConfig
from recurrent_flows_tpu_torch.cli import export_serving
from recurrent_flows_tpu_torch.data import MovingMNIST
from recurrent_flows_tpu_torch.models import RFN, SRNN
from recurrent_flows_tpu_torch.serving import Predictor, load_exported
from recurrent_flows_tpu_torch.training import Trainer

B, N_COND, N_PRED = 2, 2, 3


# (model class, JAX config, train config, the operators its graph calls)
FAMILIES = {"RFN": (RFN, U.tiny_rfn_config(), U.tiny_train_config(),
                    {"rft.glowchain.default", "rft.coupling_transform.default",
                     "rft.convlstm_gates.default"}),
            "SRNN": (SRNN, F.config("SRNN"),
                     TrainConfig(batch_size=F.B, n_frames=F.T, preprocess_range="1.0"),
                     {"rft.convlstm_gates.default"})}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def exported(request, tmp_path_factory):
    cls, cfg, tcfg, nodes = FAMILIES[request.param]
    model = cls(U.to_port(cfg), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # off the zero inits, so that every net matters
        g = torch.Generator().manual_seed(1)
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    pred = Predictor(model, U.to_port(tcfg), n_conditions=N_COND, n_predictions=N_PRED,
                     device="cpu")
    path = tmp_path_factory.mktemp("export") / f"{request.param}.pt2"
    blob = pred.export(str(path), batch_size=B)
    return dict(cfg=cfg, model=model, tcfg=tcfg, path=path, blob=blob, nodes=nodes)


def _context(cfg, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (B, N_COND, cfg.image_size, cfg.image_size, cfg.x_channels)).astype(np.float32)


def test_file_and_bytes_serve_what_predict_gives(exported):
    e = exported
    assert e["blob"] == e["path"].read_bytes()
    from_file, from_bytes = load_exported(str(e["path"])), load_exported(e["blob"])
    ctx = _context(e["cfg"])
    a, b = from_file(ctx, 7), from_bytes(torch.tensor(ctx), 7)
    assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
    ref = Predictor(e["model"], U.to_port(e["tcfg"]), n_conditions=N_COND,
                    n_predictions=N_PRED, seed=7, device="cpu").predict(ctx)
    assert a.shape == (B, N_PRED) + ctx.shape[2:] and 0.0 <= a.min() and a.max() <= 1.0
    assert torch.equal(a, b)
    assert np.array_equal(a.numpy(), ref)
    assert not torch.equal(from_file(ctx, 8), a)  # another seed, other draws
    called = {str(n.target) for n in from_file.program.graph.nodes if n.op == "call_function"}
    assert e["nodes"] <= called, called
    with pytest.raises(ValueError, match="exported for"):
        from_file(_context(e["cfg"])[:1], 7)


def test_export_cli_serves_a_trained_checkpoint(tmp_path, capsys):
    cfg = U.to_port(U.tiny_rfn_config(
        image_size=16, L=2, K=1, extractor_structure=((4, "pool", 8), (8, "pool", 8)),
        upscaler_structure=((8,), ("upsample", 4))))
    tcfg = U.to_port(TrainConfig(batch_size=B, n_frames=4, steps_per_epoch=1, beta_steps=10))
    data = MovingMNIST(seq_len=4, image_size=16, digit_size=8, num_digits=1,
                       digit_bank="synthetic", device="cpu")
    trainer = Trainer(RFN(cfg), tcfg, data, str(tmp_path), device="cpu").build()
    trainer.train_epoch(1)
    trainer.checkpoint("last")
    ckpt, out = str(tmp_path / "model_folder" / "last"), str(tmp_path / "rfn.pt2")
    argv = ["--checkpoint", ckpt, "--out", out, "--batch_size", str(B),
            "--n_conditions", str(N_COND), "--n_predictions", str(N_PRED), "--device", "cpu"]
    with pytest.raises(ValueError, match="platform 'tpu'"):
        export_serving.main(argv + ["--platforms", "tpu"])
    export_serving.main(argv + ["--platforms", "cpu"])
    assert "wrote" in capsys.readouterr().out
    ctx = data.sample(torch.Generator().manual_seed(0), B)[:, :N_COND].numpy()
    frames = load_exported(out)(ctx, 3)
    assert frames.shape == (B, N_PRED, 16, 16, 1) and torch.isfinite(frames).all()
    ref = Predictor.from_checkpoint(ckpt, device="cpu", n_conditions=N_COND,
                                    n_predictions=N_PRED, seed=3).predict(ctx)
    assert np.array_equal(frames.numpy(), ref)
    assert export_serving.build_parser().parse_args(argv[:6]).device == "cuda"
    # a process that never registered the port's operators cannot load it
    code = f"import torch; torch.export.load({out!r})"
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode != 0 and "torch.ops.rft." in run.stderr
