"""The port's (data x model) grid, ``parallel/mesh.py``, on the CPU: gloo
processes (``torch_mesh_worker.py``), one spawn per grid serving all of
its cases, the three grids spawned together.

(a) The collectives on a 1x4 grid: ``halo`` (both sides, and top only as
    a stride-2 conv takes it), ``gather_rows`` and the reduction over
    'model' equal slicing one padded global tensor, and each backward
    passes the dot-product test <f(x), y> = <x, f^T(y)> (summed over the
    ranks, float64) to 1e-6 relative.
(b) JAX's one-device train step (``Trainer._train_step``) against the
    port's step on grids 1x2, 2x2 and 1x4: ``test_rfn.tiny_cfg()`` (16x16,
    L=2, K=2) with batch-norm feature nets on
    ``test_multidevice_equivalence.py``'s batch (8 Moving MNIST sequences
    of 3 frames, key 42), the JAX weights perturbed and converted, JAX's
    draws replayed and sliced to each rank's batch and rows, the global
    gradient clip active; the port's step with recomputation on.
(c) The bar of ``test_multidevice_equivalence.py``: metrics within rtol
    1e-5, updated parameters within rtol 5e-5, atol 1e-6; elements whose
    reference gradient is rounding noise (at most ``G_FLOOR`` of the
    largest) are held by their gradient (rtol 5e-5, atol ``G_FLOOR`` of the
    largest), as ``test_torch_distributed.py`` does (JAX's gradient is
    Adam's first moment over 1-beta1). The grid's step is held with this
    bar to the port's one-process step on the same weights and draws, and
    to JAX's step with it on top of the distance between the port's
    one-process step and JAX's (which, at this size, is 1.7e-5 relative in
    kl and 2.5e-5 of the largest gradient in the split's conditional
    conv: float32 rounding of one process, not of the grid;
    ``scripts/torch_mesh_margins.py`` prints these margins). The halo
    exchanges of each step equal the count predicted below, and the
    gathers.
(d) The gather rule: a 1x4 case at image_size=8 (one row per rank in
    front of block 1's 4x4 -> 2x2 pool and of the flow's second squeeze;
    from there the latent and scale 1 are replicated) against JAX's step
    at that size, and ``chain_impl='all'`` on 1x2 (both scales gathered
    for the chain kernel's plain version) against JAX's module-path step
    of (b), the same function.
(e) SRNN, VRNN and SVG (batch norm, 16x16) on 1x2 against the port's
    one-process step on the same weights and draws, with the same bar but
    a gradient noise floor of ``FAMILY_FLOOR``: SRNN's gradients of its
    batch-constant initial latents (through ``PhiZ``'s batch norm) are all
    below 1e-5 of the largest and move by more than 1e-5 of it when the
    row sums are split over two ranks (1.4e-5 in
    ``scripts/torch_mesh_margins.py``'s run).
(f) ``spatial_constraint`` raises ValueError, naming the shape, where
    n_model does not divide H, on every rank and in this process.

Predicted exchanges per rank of one step (forward 'halo', backward
'halo_grad'; with recomputation each frame's step runs its forward
twice). Case (b): the extractor's four 3x3 convs (once over all frames),
the h-LSTM's gate conv per frame (2), and per frame of the loss (2): the
encoder's and prior's two convs each (4), the upscaler's two (2), the
flow's 13 (per GlowStep the coupling's two 3x3, 2 x 2 x 2; the split's
two; the base prior's three) = 19; so 4 + 2 + 2·19 = 44 halos, and 44 +
38 recomputed = 82 forward, and 43 backward: the frames carry no
gradient, so the halo of the extractor's first conv has no backward (nor,
below, a gather of the frame's own rows). No gather: the 1x4 grid's 4x4 latent keeps a
row per rank. Case (d) image 8 on 1x4: the extractor's convs at 8 and 4
(3; block 1's pool gathers, its conv runs replicated at 2x2), per frame
the upscaler's conv after the upsample (1) and the flow's scale 0 (4 +
split 2), scale 1 gathered at its squeeze: 3 + 2·7 = 17 halos (16
backward), 3 gathers (+14 and +2 recomputed). Case (d) chain: the flow
keeps the split's and the base prior's 5 per frame, so 4 + 2 + 2·11 = 28
halos (+22; 27 backward), and each frame gathers z and the condition of
both scales, 8 gathers (+8), of which scale 0's z (the squeezed frame)
has no backward: 6.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (two torch threads)
from recurrent_flows_tpu.config import TrainConfig as JTrainConfig
from recurrent_flows_tpu.data import MovingMNIST
from recurrent_flows_tpu.models import RFN as JRFN
from recurrent_flows_tpu.training.trainer import Trainer as JTrainer
from recurrent_flows_tpu_torch import models
from recurrent_flows_tpu_torch.config import SRNNConfig, SVGConfig, VRNNConfig
from recurrent_flows_tpu_torch.convert import tree_from_flax
from recurrent_flows_tpu_torch.parallel import Mesh, spatial_constraint
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.utils import NoiseSource, RecordingNoise
from test_rfn import tiny_cfg

REPO = Path(__file__).resolve().parents[1]
B, T, BETA, LR, CLIP = 8, 3, 1.0, 1e-3, 1.0
G_FLOOR = 1e-5  # test_torch_distributed.py's
FAMILY_FLOOR = 5e-5  # (e) in the docstring
GRIDS = {"1x2": (2, 2), "2x2": (4, 2), "1x4": (4, 4)}  # name: (world, n_model)
STEPS = {"1x2": ("rfn", "rfn_chain", "SRNN", "VRNN", "SVG"), "2x2": ("rfn",),
         "1x4": ("rfn", "rfn_img8")}
EXCHANGES = {  # (halo, halo_grad, gather, gather_grad) per rank, from the docstring
    "rfn": (82, 43, 0, 0), "rfn_img8": (31, 16, 5, 3), "rfn_chain": (50, 27, 16, 6)}


def _jax_step(cfg, batch, workdir):
    """JAX's one-device step on perturbed weights: (the port's RFN on the
    weights before it, the port's draws, metrics, parameters after it,
    gradients)."""
    tcfg = JTrainConfig(batch_size=B, n_frames=T, beta_steps=10, learning_rate=LR,
                        grad_clip=CLIP)
    jm = JRFN(cfg, remat=False)
    object.__setattr__(jm, "init", jax.jit(jm.init))  # build() inits eagerly
    tr = JTrainer(jm, tcfg, [batch], str(workdir))
    tr.build(jax.random.key(0), run_ddi=False)
    params = U.perturb(tr.state.params, 0)
    tr.state = tr.state.replace(params=params, opt_state=tr.optimizer.init(params))
    model = U.port_from(models.RFN(U.to_port(cfg), device="cpu"),
                        {"params": params, "consts": tr.state.consts})
    key = jax.random.key(5)
    draws = U.rfn_loss_noise(key, cfg, B, T)
    state, metrics = tr._train_step(tr.state, jnp.asarray(batch), BETA, LR, key)
    mu = [s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda n: hasattr(n, "mu"))
          if hasattr(s, "mu")][0].mu
    grads = {k: v / (1 - 0.9) for k, v in tree_from_flax(mu, model).items()}
    return dict(model=model, draws=draws, tcfg=U.to_port(tcfg),
                metrics={k: float(v) for k, v in metrics.items()},
                params=tree_from_flax(state.params, model), grads=grads)


def _family(name):
    kw = dict(x_channels=1, image_size=16, norm_type="batchnorm")
    return {"SRNN": SRNNConfig(h_dim=8, z_dim=4, a_dim=8, **kw),
            "VRNN": VRNNConfig(h_dim=8, z_dim=4, **kw),
            "SVG": SVGConfig(z_dim=4, c_features=16, h_dim=16, **kw)}[name]


def _port_step(model, tcfg, batch, noise):
    """The port's one-process step: (the model's state before it, the
    draws, metrics, parameters after it, gradients)."""
    state = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, tcfg, [batch], device="cpu").build(run_ddi=False)
    metrics = tr.train_step(torch.tensor(batch), BETA, LR, noise=noise)
    return dict(state=state, cfg=model.cfg, family=type(model).__name__, tcfg=tcfg,
                draws=getattr(noise, "tensors", None),
                metrics={k: float(v) for k, v in metrics.items()},
                params={n: p.detach().clone() for n, p in model.named_parameters()},
                grads={n: p.grad for n, p in model.named_parameters() if p.grad is not None})


def _family_step(family, batch, seed):
    """A family's one-process step on weights moved off their zero inits,
    with fresh draws."""
    model = getattr(models, family)(_family(family), device="cpu",
                                    generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    tcfg = U.to_port(JTrainConfig(batch_size=B, n_frames=T, learning_rate=LR,
                                  grad_clip=CLIP, preprocess_range="1.0"))
    return _port_step(model, tcfg, batch,
                      RecordingNoise(torch.Generator().manual_seed(seed + 2)))


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The reference steps, then every grid's ranks: ({grid: folder},
    {step: dict(port=the one-process step, jax=JAX's step or None)})."""
    folder = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    batches = {"rfn": np.asarray(MovingMNIST(seq_len=T, image_size=16, digit_size=8,
                                             num_digits=1).sample(jax.random.key(42), B)),
               "rfn_img8": rng.random((B, T, 8, 8, 1), np.float32)}
    refs = {}
    for name, size in (("rfn", 16), ("rfn_img8", 8)):
        j = _jax_step(tiny_cfg(image_size=size, norm_type_features="batchnorm"),
                      batches[name], folder / name)
        refs[name] = dict(jax=j, port=_port_step(j["model"], j["tcfg"], batches[name],
                                                 NoiseSource(replay=j["draws"])))
        refs[name]["port"]["draws"] = j["draws"]
    cfg, j = refs["rfn"]["jax"]["model"].cfg, refs["rfn"]["jax"]
    chain = models.RFN(dataclasses.replace(cfg, glow=dataclasses.replace(
        cfg.glow, chain_impl="all")), device="cpu")
    chain.load_state_dict(refs["rfn"]["port"]["state"])
    batches["rfn_chain"] = batches["rfn"]
    refs["rfn_chain"] = dict(jax=j, port=dict(
        _port_step(chain, j["tcfg"], batches["rfn"], NoiseSource(replay=j["draws"])),
        draws=j["draws"]))
    for i, family in enumerate(("SRNN", "VRNN", "SVG")):
        batches[family] = rng.random((B, T, 16, 16, 1), np.float32)
        refs[family] = dict(jax=None, port=_family_step(family, batches[family], 10 * i))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    procs, out = [], {}
    for name, (world, n_model) in GRIDS.items():
        out[name] = sub = folder / f"grid{name}"
        sub.mkdir()
        steps = {}
        for step in STEPS[name]:
            r = refs[step]["port"]
            steps[step] = dict(family=r["family"], config=r["cfg"], tcfg=r["tcfg"],
                               state=r["state"], batch=torch.tensor(batches[step]),
                               draws=r["draws"], beta=BETA, lr=LR, remat=True)
        torch.save(dict(steps=steps, adjoints=name == "1x4"), sub / "case.pt")
        procs += [(name, r, subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_mesh_worker.py"), str(r), str(world),
             str(n_model), str(sub / "store"), str(sub)], cwd=sub, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for r in range(world)]
    for name, r, p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, f"grid {name} rank {r}:\n{log[-4000:]}"
    return out, refs


def _ranks(folder, name, world):
    return [torch.load(folder / f"{name}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _within(got, want, rtol, atol, base, msg):
    """|got - want| <= |base - want| + atol + rtol·|want| elementwise (no
    slack without ``base``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    slack = 0.0 if base is None else np.abs(np.asarray(base, np.float64) - want)
    err = np.abs(got - want) - slack - atol - rtol * np.abs(want)
    assert np.all(err <= 0), f"{msg}: {int((err > 0).sum())} elements off by up to {err.max():.3g}"


def _check_step(got, ref, context, floor=G_FLOOR, base=None):
    """(c)'s bar for one rank's step against the reference step ``ref``;
    with ``base`` (the port's one-process step) on top of its distance
    to ``ref``."""
    b = base or {}
    for k, v in ref["metrics"].items():
        _within(got["metrics"][k], v, 1e-5, 0.0, b.get("metrics", {}).get(k),
                f"{context} {k}")
    grads = ref["grads"]
    g_max = max(g.abs().max().item() for g in grads.values())
    for name, g in grads.items():
        if name not in got["grads"]:  # a parameter the loss never reaches
            assert not g.any(), f"{context} d{name}"
            continue
        _within(got["grads"][name], g, 5e-5, floor * g_max,
                None if base is None else base["grads"][name], f"{context} d{name}")
    assert set(got["grads"]) <= set(grads), context
    for name, v in ref["params"].items():
        if name not in grads:  # no gradient, no step
            assert torch.equal(got["state"][name], v), f"{context} {name}"
            continue
        determined = grads[name].abs() > floor * g_max
        _within(got["state"][name][determined], v[determined], 5e-5, 1e-6,
                None if base is None else base["params"][name][determined],
                f"{context} {name}")


def _check_exchanges(got, step, context):
    c = got["counts"]
    assert (c["halo"], c["halo_grad"], c["gather"], c["gather_grad"]) == EXCHANGES[step], (
        context, c)


def test_collectives_and_their_adjoints_on_1x4(grids):
    folder, _ = grids
    for r, got in enumerate(torch.load(folder["1x4"] / f"adjoints_rank{r}.pt",
                                       weights_only=False) for r in range(4)):
        for name in ("halo", "halo_top", "gather_rows", "model_sum"):
            res = got[name]
            # data movement is exact; the sum's order is the collective's
            assert res["forward_err"] <= (1e-12 if name == "model_sum" else 0.0), (r, name, res)
            assert abs(res["lhs"] - res["rhs"]) <= 1e-6 * abs(res["lhs"]), (r, name, res)
        assert "(2, 3, 18, 8, 1)" in got["validation"], got["validation"]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_step_equals_the_jax_one_device_step(grids, grid):
    folder, refs = grids
    ref = refs["rfn"]
    for r, got in enumerate(_ranks(folder[grid], "rfn", GRIDS[grid][0])):
        _check_step(got, ref["port"], f"{grid} rank {r} vs one process")
        _check_step(got, ref["jax"], f"{grid} rank {r} vs JAX", base=ref["port"])
        _check_exchanges(got, "rfn", f"{grid} rank {r}")


@pytest.mark.parametrize("step,grid", [("rfn_img8", "1x4"), ("rfn_chain", "1x2")])
def test_gathered_rows_equal_the_jax_step(grids, step, grid):
    folder, refs = grids
    ref = refs[step]
    for r, got in enumerate(_ranks(folder[grid], step, GRIDS[grid][0])):
        _check_step(got, ref["port"], f"{step} rank {r} vs one process")
        _check_step(got, ref["jax"], f"{step} rank {r} vs JAX", base=ref["port"])
        _check_exchanges(got, step, f"{step} rank {r}")


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_coupling_nets_run_nhwc_on_a_grid(grids, grid):
    """Every coupling net of a grid's step takes the NHWC path (its convs
    exchange halo rows): per GlowStep of the module path one net, 4 a frame
    (L=2, K=2), the loss's 2 frames twice (recomputed); none with the chain
    kernel on every scale."""
    folder, _ = grids
    for step in STEPS[grid]:
        if not step.startswith("rfn"):
            continue
        for r, got in enumerate(_ranks(folder[grid], step, GRIDS[grid][0])):
            want = 0 if step == "rfn_chain" else 16
            assert got["couplings"] == dict(channel_major=0, nhwc=want), (grid, step, r)


@pytest.mark.parametrize("family", ["SRNN", "VRNN", "SVG"])
def test_families_on_1x2_equal_the_one_process_step(grids, family):
    folder, refs = grids
    for r, got in enumerate(_ranks(folder["1x2"], family, 2)):
        _check_step(got, refs[family]["port"], f"{family} rank {r}", floor=FAMILY_FLOOR)
        assert got["counts"]["halo"] > 0 and got["counts"]["gather"] > 0, got["counts"]


def test_spatial_constraint_takes_rows_and_validates():
    x = torch.arange(2 * 3 * 8 * 4).reshape(2, 3, 8, 4, 1).float()
    for m in range(4):
        mesh = Mesh("cpu", rank=m, world=4, n_model=4)
        assert torch.equal(spatial_constraint(mesh, x), x[:, :, 2 * m:2 * m + 2])
        assert mesh.frame == (8, 4)
        with pytest.raises(ValueError, match=r"\(2, 3, 6, 4, 1\)"):
            spatial_constraint(mesh, x[:, :, :6])
    one = Mesh("cpu", rank=0, world=2, n_model=1)
    assert spatial_constraint(one, x) is x and spatial_constraint(None, x) is x
    assert spatial_constraint(Mesh("cpu", 0, 2, 2), x[0, 0]) is not x[0, 0]
