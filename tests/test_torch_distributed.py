"""Data-parallel training of the port over ``torch.distributed`` (CPU, gloo).

- ``parallel.distributed``: the batch-slicing arithmetic and the primary
  rank with the rank and world size mocked (as ``test_distributed.py``
  holds the JAX package's), and ``initialize``'s arguments;
- one real two-process run (``torch_dp_worker.py``): build with the
  data-dependent init, then one train step of a tiny RFN with batch-norm
  feature nets and one of a tiny SRNN with ``norm_type_model='batchnorm'``,
  each process holding half of the global batch with the global draws
  replayed and sliced: the averaged metrics, every buffer and every
  updated parameter equal the single-process whole-batch step within rtol
  5e-5, atol 1e-6 (``test_multidevice_equivalence.py``'s bar), and every
  averaged gradient within rtol 5e-5, atol ``G_FLOOR`` of the largest;
  then the RFN CLI with ``--multigpu`` on both ranks: rank 1 writes no
  file and ends with rank 0's parameters, bit for bit.

Adam's first step moves each element by lr·g/(|g|+1e-8), lr·sign(g) where
|g| >> 1e-8. Where g is float32 rounding noise (the bias of a conv before
a batch norm has a gradient that is zero in exact arithmetic; a few
kernel elements have gradients of ~1e-7 of the largest) that sign is
arbitrary in the single-process step itself, and two summation orders
give ±lr. Such elements, |g| <= G_FLOOR·max|g| in the reference, are held
by their gradient (above) and not by their updated value.
"""

import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from torch_parity_utils import _two_torch_threads  # noqa: F401  (two torch threads)
from recurrent_flows_tpu_torch import models
from recurrent_flows_tpu_torch.config import RFNConfig, SRNNConfig, TrainConfig
from recurrent_flows_tpu_torch.parallel import distributed
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.utils import NoiseSource

REPO = Path(__file__).resolve().parents[1]
GLOBAL_BATCH, FRAMES, IMG = 4, 3, 16
# a gradient element at or below this fraction of the largest is rounding
# noise (the mismatches measured in a first run: at most 7e-7 of it)
G_FLOOR = 1e-5


@pytest.mark.parametrize("n_proc", [1, 2, 4])
def test_process_local_batch_slice_partitions(n_proc):
    global_batch = 16
    slices = []
    with mock.patch.object(distributed.dist, "is_initialized", return_value=True), \
            mock.patch.object(distributed.dist, "get_world_size", return_value=n_proc):
        for pid in range(n_proc):
            with mock.patch.object(distributed.dist, "get_rank", return_value=pid):
                slices.append(distributed.process_local_batch_slice(global_batch))
    covered = []
    for s in slices:
        assert (s.stop - s.start) == global_batch // n_proc
        covered.extend(range(s.start, s.stop))
    assert covered == list(range(global_batch))


def test_is_primary_only_on_rank_zero():
    assert distributed.is_primary()  # no group: one process, the primary
    with mock.patch.object(distributed.dist, "is_initialized", return_value=True), \
            mock.patch.object(distributed.dist, "get_world_size", return_value=4):
        with mock.patch.object(distributed.dist, "get_rank", return_value=0):
            assert distributed.is_primary()
        with mock.patch.object(distributed.dist, "get_rank", return_value=3):
            assert not distributed.is_primary()


def test_initialize_joins_only_when_asked(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize("cpu") is None  # no torchrun environment
    with mock.patch.object(distributed.dist, "is_initialized", return_value=False), \
            mock.patch.object(distributed.dist, "init_process_group") as init, \
            mock.patch("recurrent_flows_tpu_torch.parallel.data_parallel.dist") as dd:
        dd.get_rank.return_value, dd.get_world_size.return_value = 1, 4
        dp = distributed.initialize("cpu", init_method="tcp://localhost:1234",
                                    world_size=4, rank=1)
        init.assert_called_once_with("gloo", init_method="tcp://localhost:1234",
                                     world_size=4, rank=1)
        assert (dp.rank, dp.world, dp.primary, dp.owns_group) == (1, 4, False, True)
        init.reset_mock()
        monkeypatch.setenv("WORLD_SIZE", "4")
        distributed.initialize("cpu")
        init.assert_called_once_with("gloo", init_method="env://", world_size=-1, rank=-1)


class _Recorder(NoiseSource):
    """Fresh draws from a seeded generator, kept in call order."""

    def __init__(self, seed):
        super().__init__(generator=torch.Generator().manual_seed(seed))
        self.draws = []

    def _keep(self, d):
        self.draws.append(d.clone())
        return d

    def normal(self, like):
        return self._keep(super().normal(like))

    def uniform(self, like, low, high):
        return self._keep(super().uniform(like, low, high))

    def randint(self, low, high, shape, device):
        return self._keep(super().randint(low, high, shape, device))


def _families():
    rfn = RFNConfig(
        x_channels=1, image_size=IMG, h_dim=8, z_dim=2, a_dim=4, L=2, K=2,
        extractor_structure=((4, "pool", 8), (8, "pool", 8)),
        upscaler_structure=((8,), ("upsample", 4)), prior_structure=(4,),
        encoder_structure=(4,), norm_type="batchnorm", norm_type_features="batchnorm")
    srnn = SRNNConfig(x_channels=1, image_size=IMG, h_dim=8, z_dim=4, a_dim=8,
                      norm_type="batchnorm")
    return {"RFN": (rfn, "0.5", True), "SRNN": (srnn, "1.0", False)}


_CLI_ARGV = ["--choose_data", "mnist", "--image_size", "16", "--digit_size", "8",
             "--num_digits", "1", "--batch_size", str(GLOBAL_BATCH), "--n_frames", "3",
             "--n_epochs", "1", "--steps_per_epoch", "2", "--n_conditions", "2",
             "--n_predictions", "1", "--h_dim", "8", "--z_dim", "2", "--a_dim", "4",
             "--L", "2", "--K", "2", "--extractor_structure", "4-pool-8", "8-pool-8",
             "--upscaler_structure", "8", "upsample-4", "--prior_structure", "4",
             "--encoder_structure", "4", "--n_units_affine", "8", "--n_units_prior", "8"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The single-process reference steps, then both ranks' runs."""
    folder = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    case, refs = {"families": {}, "cli_argv": _CLI_ARGV}, {}
    for i, (family, (cfg, prange, run_ddi)) in enumerate(_families().items()):
        tcfg = TrainConfig(batch_size=GLOBAL_BATCH, n_frames=FRAMES, preprocess_range=prange)
        model = getattr(models, family)(cfg, device="cpu",
                                        generator=torch.Generator().manual_seed(i))
        state = {k: v.clone() for k, v in model.state_dict().items()}
        batch = torch.tensor(rng.random((GLOBAL_BATCH, FRAMES, IMG, IMG, 1), np.float32))
        init, step = _Recorder(10 + i), _Recorder(20 + i)
        tr = Trainer(model, tcfg, [batch], device="cpu").build(run_ddi=run_ddi, noise=init)
        metrics = tr.train_step(batch, 0.5, 1e-3, noise=step)
        refs[family] = dict(metrics={k: float(v) for k, v in metrics.items()},
                            state=tr.model.state_dict(),
                            grads={n: p.grad for n, p in tr.model.named_parameters()
                                   if p.grad is not None})
        assert all(d.shape[0] == GLOBAL_BATCH for d in step.draws)
        case["families"][family] = dict(config=cfg, tcfg=tcfg, state=state, batch=batch,
                                        run_ddi=run_ddi, init_draws=init.draws,
                                        step_draws=step.draws, beta=0.5, lr=1e-3)
    torch.save(case, folder / "case.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dp_worker.py"),
                               str(r), "2", str(folder / "store"), str(folder)],
                              cwd=folder, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return folder, refs


@pytest.mark.parametrize("family", ["RFN", "SRNN"])
def test_two_ranks_step_equals_the_whole_batch_step(two_ranks, family):
    folder, refs = two_ranks
    ref = refs[family]
    for rank in range(2):
        got = torch.load(folder / f"{family}_rank{rank}.pt", weights_only=False)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=5e-5, atol=1e-6,
                                       err_msg=f"rank {rank} {k}")
        assert got["state"].keys() == ref["state"].keys()
        assert got["grads"].keys() == ref["grads"].keys()
        g_max = max(g.abs().max().item() for g in ref["grads"].values())
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=5e-5,
                                       atol=G_FLOOR * g_max, err_msg=f"rank {rank} d{name}")
        for name, v in ref["state"].items():
            determined = (ref["grads"][name].abs() > G_FLOOR * g_max if name in ref["grads"]
                          else torch.ones_like(v, dtype=torch.bool))
            np.testing.assert_allclose(got["state"][name][determined].numpy(),
                                       v[determined].numpy(), rtol=5e-5, atol=1e-6,
                                       err_msg=f"rank {rank} {name}")


def test_multigpu_cli_writes_only_on_rank_zero(two_ranks):
    folder, _ = two_ranks
    assert not (folder / "cli_rank1").exists()
    run = folder / "cli_rank0" / "model_folder"
    assert (run / "last" / "meta.json").is_file()
    status = (run / "status.txt").read_text().splitlines()
    assert status[0].startswith("data_source moving_mnist bank=")
    assert len(status) == 2 and status[1].startswith("epoch 1 ")
    r0, r1 = (torch.load(folder / f"cli_rank{r}.pt", weights_only=False) for r in range(2))
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert all(torch.equal(v, r1["state"][k]) for k, v in r0["state"].items())
