"""The port's ``Evaluator``, linear baseline and eval CLI against the JAX
package's, on the CPU.

The RFN of ``test_rfn.tiny_cfg`` (16x16 gray, L=2, with batch-norm
feature nets, so that a resample folded into the batch would change the
statistics) on converted weights: the JAX ``Evaluator`` runs its protocol
once per module (B=2, 2 batches, 2 resamples, 2 context and 3 predicted
frames, FVD over 2 with ``random3d``), recording every batch its sampler
gives and every per-resample metric track; the port's ``Evaluator`` gets
the same batches and, through its ``noise`` hook, the draws of JAX's keys
(``fold_in``/``split`` as the JAX methods make them), and must give the
same best-of-N picks, tracks, summaries, bits/dim, FVD, diagnostics and
``compare_bpp``, using every draw. Then SRNN's IW-ELBO through the
``Evaluator`` (the tiny family config), ``plot_temperatures`` keeping
``eval_norm``, the figures, the linear baseline against JAX's (optax Adam
against ``torch.optim.Adam``), and the CLI: ``evaluations.json`` with the
JAX CLI's keys, the thesis protocol's constants, and the data it refuses.

Tolerances (float32): what passes through a model (tracks, bits/dim,
FVD, the diagnostics, the linear baseline's weights) within
1e-4·(1+|ref|) elementwise; counts and picks exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_utils as F
import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.config import TrainConfig as JTrainConfig
from recurrent_flows_tpu.data import MovingMNIST as JMovingMNIST
from recurrent_flows_tpu.evaluation import averagemodel as j_avg
from recurrent_flows_tpu.evaluation import evaluator as j_ev
from recurrent_flows_tpu_torch import config as port_config
from recurrent_flows_tpu_torch.cli import common as port_common
from recurrent_flows_tpu_torch.cli import eval_settings as port_cli
from recurrent_flows_tpu_torch.data import MovingMNIST
from recurrent_flows_tpu_torch.evaluation import evaluator as t_ev
from recurrent_flows_tpu_torch.evaluation.averagemodel import SimpleLinearModel
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.training import Trainer
from recurrent_flows_tpu_torch.utils import NoiseSource
from test_rfn import tiny_cfg

B, R, NC, NP, NB = 2, 2, 2, 3, 2
T = NC + NP
SETTINGS = dict(n_conditions=NC, n_predictions=NP, resamples=R, n_batches=NB,
                batch_size=B, fvd_horizon=2)
KEYS = dict(eval=3, loss=4, fvd=5, probability_future=6, elbo_gap=7, compare=8)
TOL = 1e-4
fold = jax.random.fold_in


class Recorded:
    """A JAX sampler that keeps the batches it gives, per ``phase``."""

    def __init__(self, sample):
        self._sample, self.phase, self.batches = sample, None, {}

    def sample(self, key, bs):
        x = self._sample(key, bs)
        self.batches.setdefault(self.phase, []).append(np.asarray(x))
        return x


class Replayed:
    """The port's side of a ``Recorded`` phase: the same batches, in order
    (the Evaluator's generator goes unused)."""

    def __init__(self, batches):
        self._it = iter(batches)

    def sample(self, generator, bs):
        x = next(self._it)
        assert x.shape[0] == bs
        return torch.tensor(x)


class Hook:
    """The port Evaluator's ``noise``: a replay of the draws of a key, each
    replay kept so the test can check that it was used up."""

    def __init__(self, draws):
        self.draws, self.sources = draws, []

    def __call__(self, call, batch, resample):
        self.sources.append(NoiseSource(replay=self.draws(call, batch, resample)))
        return self.sources[-1]

    def used_up(self):
        return bool(self.sources) and all(s.exhausted() for s in self.sources)


def _rfn_draws(cfg, keys):
    """JAX's draws per (call, batch, resample), as the JAX Evaluator makes
    its keys (evaluator.py: get_eval_values, get_loss, get_fvd_values,
    probability_future_bpp, elbo_gap)."""
    def draws(call, i, r):
        if call == "eval":
            k = jax.random.split(fold(fold(keys["eval"], i), 100), R)[r]
            return U.rfn_predict_noise(k, cfg, B, NC, NP)
        if call == "eval_loss":
            return U.rfn_loss_noise(fold(fold(keys["eval"], i), 999), cfg, B, T)
        if call == "loss":
            return U.rfn_loss_noise(fold(fold(keys["loss"], 5000 + i), r), cfg, B, T)
        if call == "fvd":
            return U.rfn_predict_noise(fold(fold(keys["fvd"], 7000 + i), 1), cfg, B, NC, NP)
        if call == "probability_future":
            k = fold(fold(keys["probability_future"], 7000 + i), 1)
            return U.rfn_probability_future_noise(k, cfg, B, T, NC)
        assert call == "elbo_gap", call
        return U.rfn_elbo_gap_noise(fold(fold(keys["elbo_gap"], 8000 + i), 1), cfg, B, T,
                                    sample=False)
    return draws


def _tracks_recorder(module, out: list):
    """Wrap ``module.eval_seq`` so that every call's tracks are kept."""
    inner = module.eval_seq

    def eval_seq(true, pred, data_range=1.0):
        res = inner(true, pred, data_range)
        out.append({k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
                    for k, v in res.items()})
        return res
    return eval_seq


class Jitted:
    """A JAX model whose ``apply`` runs jitted, where the JAX package calls
    it eagerly (``compare_bpp``, ``importance_weighted_elbo``): the same
    computation, compiled once rather than dispatched op by op. ``loss``
    reuses the JAX Evaluator's jitted loss."""

    def __init__(self, model, loss=None, **static):
        self._apply = jax.jit(model.apply, static_argnames=("method",), **static)
        self._loss = loss

    def apply(self, v, *args, method):
        if method == "loss" and self._loss is not None:
            return self._loss(v, *args)
        return self._apply(v, *args, method=method)


@pytest.fixture(scope="module")
def rfn():
    """The JAX protocol on the tiny RFN, once: (cfg, JAX model, variables,
    recorded batches, keys, results, per-resample tracks)."""
    cfg = tiny_cfg(norm_type_features="batchnorm")
    jm, v = U.jax_rfn_variables(cfg, seed=0, batch=B)
    ds = JMovingMNIST(seq_len=T, image_size=16, digit_size=8, num_digits=1)
    data = Recorded(lambda k, bs: ds.sample(k, bs) - 0.5)
    ev = j_ev.Evaluator(jm, v, data, j_ev.EvalSettings(**SETTINGS),
                        postprocess=lambda a: jnp.clip(a + 0.5, 0, 1))
    keys = {k: jax.random.key(s) for k, s in KEYS.items()}
    tracks, ref = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ev, "eval_seq", _tracks_recorder(j_ev, tracks))
        data.phase = "eval"
        ref["eval"] = ev.get_eval_values(keys["eval"], with_lpips=True)
    data.phase = "loss"
    ref["loss"] = ev.get_loss(keys["loss"], resamples=2)
    data.phase = "fvd"
    ref["fvd"] = ev.get_fvd_values(keys["fvd"], embedder="random3d")
    data.phase = "probability_future"
    ref["probability_future"] = ev.probability_future_bpp(keys["probability_future"])
    data.phase = "elbo_gap"
    ref["elbo_gap"] = ev.elbo_gap(keys["elbo_gap"])
    data.phase = "compare"
    x = data.sample(keys["compare"], B)
    ref["compare"] = j_ev.compare_bpp({"rfn": (Jitted(jm, ev._loss), v)}, x, keys["compare"])
    return cfg, jm, v, data.batches, keys, ref, tracks


def _port(cfg, v):
    return U.port_from(RFN(U.to_port(cfg), device="cpu"), v)


def _close(got, ref, what):
    U.assert_close_rel(np.asarray(got, np.float64), np.asarray(ref, np.float64), TOL, what)


def _same_result(got, ref, what=""):
    """Same keys; arrays and floats within TOL·(1+|ref|); the rest equal."""
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k, r in ref.items():
        if isinstance(r, dict):
            _same_result(got[k], r, f"{what}.{k}")
        elif isinstance(r, (int, str)) and not isinstance(r, bool):
            assert got[k] == r, (what, k, got[k], r)
        elif isinstance(r, float) and np.isnan(r):
            assert np.isnan(got[k]), (what, k)
        else:
            _close(got[k], r, f"{what}.{k}")


METHODS = ["get_eval_values", "get_loss", "get_fvd_values", "probability_future_bpp",
           "elbo_gap", "compare_bpp"]


@pytest.mark.parametrize("method", METHODS)
def test_evaluator_matches_jax(rfn, method, monkeypatch):
    cfg, _, v, batches, keys, ref, ref_tracks = rfn
    model = _port(cfg, v)
    hook = Hook(_rfn_draws(cfg, keys))
    phase = {"get_eval_values": "eval", "get_loss": "loss", "get_fvd_values": "fvd",
             "probability_future_bpp": "probability_future", "elbo_gap": "elbo_gap",
             "compare_bpp": "compare"}[method]
    ev = t_ev.Evaluator(model, Replayed(batches[phase]), t_ev.EvalSettings(**SETTINGS),
                        postprocess=lambda a: torch.clamp(a + 0.5, 0, 1), device="cpu",
                        noise=hook)
    if method == "get_eval_values":
        tracks = []
        monkeypatch.setattr(t_ev, "eval_seq", _tracks_recorder(t_ev, tracks))
        got = ev.get_eval_values(with_lpips=True)
        assert len(tracks) == len(ref_tracks) == NB * R
        for i in range(NB):  # the best-of-N picks, per batch and metric
            for m in ("ssim", "psnr", "mse"):
                a = np.stack([t[m] for t in tracks[i * R:(i + 1) * R]])
                r = np.stack([t[m] for t in ref_tracks[i * R:(i + 1) * R]])
                _close(a, r, f"batch {i} {m} tracks")
                pick = np.argmin if m == "mse" else np.argmax
                np.testing.assert_array_equal(pick(a.mean(-1), 0), pick(r.mean(-1), 0))
        assert got["ssim_best"].shape == (NB * B, NP)
        _same_result(got, ref["eval"])
    elif method == "compare_bpp":  # every model's loss on the same key
        hook.draws = lambda *a: U.rfn_loss_noise(keys["compare"], cfg, B, T)
        got = t_ev.compare_bpp({"rfn": model}, torch.tensor(batches["compare"][0]),
                               noise=lambda name: hook("compare", 0, 0))
        _same_result(got, ref["compare"])
    elif method == "get_loss":
        _close(ev.get_loss(resamples=2), ref["loss"], "get_loss")
    elif method == "get_fvd_values":
        _same_result(ev.get_fvd_values(embedder="random3d"), ref["fvd"])
    else:
        _same_result(getattr(ev, method)(), ref[phase])
    assert hook.used_up()


def test_importance_weighted_elbo_matches_jax():
    """SRNN at the tiny family config (norm 'none'), K=3, 2 batches of 2."""
    cfg, K = F.config("SRNN", norm_type="none"), 3
    jm, v, pm = F.pair(cfg)
    data = Recorded(lambda k, bs: jax.random.uniform(k, (bs, F.T, F.IMG, F.IMG, 1)))
    settings = dict(n_batches=2, batch_size=F.B)
    key = jax.random.key(9)
    ref = j_ev.Evaluator(Jitted(jm, static_argnums=(2,)), v, data,
                         j_ev.EvalSettings(**settings)).importance_weighted_elbo(key, K=K)
    hook = Hook(lambda call, i, r: F.iw_noise(fold(fold(key, 9000 + i), 1), cfg, K))
    ev = t_ev.Evaluator(pm, Replayed(data.batches[None]), t_ev.EvalSettings(**settings),
                        device="cpu", noise=hook)
    _close(ev.importance_weighted_elbo(K=K), ref, "iw_elbo")
    assert hook.used_up()


def _eval_norm_rfn():
    """The tiny RFN with tracked running statistics (off 0 and 1) and
    every parameter moved off its init."""
    cfg = U.to_port(tiny_cfg(norm_type="batchnorm", norm_type_features="batchnorm",
                             track_running_stats=True))
    model = RFN(cfg, eval_norm=True, device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(torch.exp(0.2 * torch.randn(b.shape, generator=g)))
    return cfg, model


def test_plot_temperatures_keeps_eval_norm():
    """The sweep rolls out the model as it is (eval_norm kept), at each
    temperature: the same as ``predict`` with that temperature, and not
    what the same weights give with batch statistics."""
    cfg, model = _eval_norm_rfn()
    x = torch.rand(B, T, 16, 16, 1, generator=torch.Generator().manual_seed(4)) - 0.5
    s = t_ev.EvalSettings(n_conditions=NC, n_predictions=NP, batch_size=B)
    ev = t_ev.Evaluator(model, Replayed([x.numpy()]), s, device="cpu", seed=5)
    out = ev.plot_temperatures(temperatures=(1.0, 0.5), kl_temperatures=(1.0,))
    assert list(out) == [(1.0, 1.0), (0.5, 1.0)]
    gen = torch.Generator().manual_seed(5)
    batch_stats = RFN(cfg, eval_norm=False, device="cpu")
    batch_stats.load_state_dict(model.state_dict())
    for t in (1.0, 0.5):
        noise = NoiseSource(generator=gen)
        state = gen.get_state()
        _, want = model.predict(x, NP, NC, noise, kl_temperature=1.0, temperature=t)
        np.testing.assert_array_equal(out[(t, 1.0)], want.numpy())
        gen.set_state(state)
        _, other = batch_stats.predict(x, NP, NC, NoiseSource(generator=gen), temperature=t)
        assert not np.allclose(out[(t, 1.0)], other.numpy())
    assert not np.allclose(out[(1.0, 1.0)], out[(0.5, 1.0)])
    # a model whose predict takes no temperature rolls out as it is
    srnn = F.port_model(F.config("SRNN", norm_type="none"), F.jax_variables(
        F.config("SRNN", norm_type="none"))[1])
    xs = torch.rand(B, F.T, F.IMG, F.IMG, 1, generator=torch.Generator().manual_seed(6))
    ev = t_ev.Evaluator(srnn, Replayed([xs.numpy()]), dataclasses.replace(s, n_predictions=2),
                        device="cpu")
    assert ev.plot_temperatures(temperatures=(0.5,))[(0.5, 1.0)].shape == (2, B, 16, 16, 1)


def test_figures_are_written(tmp_path):
    """Each figure method on the port's RFN writes its file (matplotlib)."""
    cfg, model = _eval_norm_rfn()
    data = MovingMNIST(seq_len=6, image_size=16, digit_size=8, num_digits=1,
                       digit_bank="synthetic", device="cpu")
    sync = MovingMNIST(seq_len=6, image_size=16, digit_size=8, num_digits=1,
                       digit_bank="synthetic", synchronized=True, device="cpu")

    class Shifted:
        def __init__(self, inner):
            self.inner = inner

        def sample(self, generator, bs):
            out = self.inner.sample(generator, bs)
            return (out[0] - 0.5, out[1]) if isinstance(out, tuple) else out - 0.5

    s = t_ev.EvalSettings(n_conditions=NC, n_predictions=NP, resamples=1, n_batches=1,
                          batch_size=B)
    ev = t_ev.Evaluator(model, Shifted(data), s, device="cpu",
                        postprocess=lambda a: torch.clamp(a + 0.5, 0, 1))
    paths = {n: str(tmp_path / f"{n}.png") for n in
             ("long", "temps", "interp", "params", "rollouts", "diversity", "curves")}
    assert ev.plot_long_rollout(4, paths["long"]).shape == (4, 16, 16, 1)
    assert len(ev.plot_temperatures(temperatures=(0.5, 1.0), path=paths["temps"])) == 2
    assert ev.get_interpolations(n_alphas=3, n_conditions=3,
                                 path=paths["interp"]).shape == (3, B, 16, 16, 1)
    traj = ev.param_plots(Shifted(sync), path=paths["params"])
    assert traj["mu_p"].shape == (5,) and traj["hit_boundary"].shape == (6,)
    assert ev.plot_random_samples(n_sequences=2, path=paths["rollouts"]).shape == (
        2, NC + NP, 16, 16, 1)
    assert ev.plot_diversity(2, paths["diversity"]).shape == (2, NP, 16, 16, 1)
    t_ev.plot_eval_curves({"exp": ev.get_eval_values(with_lpips=False)}, paths["curves"])
    for n, p in paths.items():
        assert (tmp_path / f"{n}.png").exists(), n


def test_simple_linear_model_matches_jax():
    """Six Adam steps (optax against torch.optim), then the rollout's
    metrics. Both start from the same weights moved off the copy-last
    init: there the bias's gradient is float noise around 0 (a translated
    digit keeps the frame's mass), and Adam's first step divides it by
    |g| + eps, so two summation orders move the bias by different amounts
    (test_torch_trainer.py states the same rule for the train step)."""
    ds = JMovingMNIST(seq_len=7, image_size=16, digit_size=8, num_digits=1)
    data = Recorded(ds.sample)
    jl = j_avg.SimpleLinearModel(n_conditions=3)
    w0 = np.asarray(jl.w) + 0.1 * np.random.default_rng(0).standard_normal(jl.w.shape)
    jl.w, jl.b = jnp.asarray(w0, jnp.float32), jnp.asarray(0.05, jnp.float32)
    m = SimpleLinearModel(n_conditions=3, device="cpu")
    m.w, m.b = torch.tensor(np.asarray(jl.w)), torch.tensor(np.asarray(jl.b))
    data.phase = "fit"
    ref_loss = jl.fit(data, jax.random.key(0), steps=6, batch_size=4, lr=1e-2)
    data.phase = "evaluate"
    ref = jl.evaluate(data, jax.random.key(1), n_predictions=4, batch_size=4)
    loss = m.fit(Replayed(data.batches["fit"]), None, steps=6, batch_size=4, lr=1e-2)
    got = m.evaluate(Replayed(data.batches["evaluate"]), None, n_predictions=4, batch_size=4)
    _close(loss, ref_loss, "final loss")
    _close(m.w.numpy(), jl.w, "w")
    _close(m.b.numpy(), jl.b, "b")
    _same_result(got, ref)
    assert got["ssim"].shape == (4,)


# --- the CLI -------------------------------------------------------------------

CLI_ARGS = ["--n_batches", str(NB), "--batch_size", str(B), "--n_conditions", str(NC),
            "--n_predictions", str(NP), "--resamples", str(R), "--fvd_horizon", "2",
            "--fvd_embedder", "random3d", "--no-debug_plot"]


def _key_tree(d):
    """Keys at every level; a list by its shape."""
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    if isinstance(d, list):
        return ("list", np.shape(d))
    return type(d).__name__ if not isinstance(d, (int, float)) else "number"


def _all_finite(d) -> bool:
    """Every number in a JSON tree is finite."""
    if isinstance(d, dict):
        return all(_all_finite(v) for v in d.values())
    if isinstance(d, list):
        return bool(np.isfinite(np.asarray(d, dtype=float)).all())
    return isinstance(d, str) or bool(np.isfinite(d))


def test_eval_cli_writes_the_jax_keys(rfn, tmp_path, monkeypatch):
    """The port's CLI on a port checkpoint of the tiny RFN, on the CPU,
    writes ``evaluations.json`` with the keys, shapes and ``_meta`` the JAX
    CLI writes for the same model and protocol (the JAX CLI run with its
    Evaluator's results from the fixture)."""
    from recurrent_flows_tpu.cli import eval_settings as jax_cli

    cfg, jm, v, _, _, ref, _ = rfn
    monkeypatch.chdir(tmp_path)  # no ./data: synthetic digits, no weight files
    tcfg = port_config.TrainConfig(batch_size=B, n_frames=T, digit_size=8, num_digits=1)
    Trainer(_port(cfg, v), tcfg, [], str(tmp_path), device="cpu").build(
        run_ddi=False).checkpoint("last")

    class JaxResults:
        def __init__(self, *a, **k):
            pass

        def get_eval_values(self, key, with_lpips=True, save_grids_dir=None):
            return ref["eval"]

        get_loss = lambda self, key, resamples=3: ref["loss"]  # noqa: E731
        get_fvd_values = lambda self, key, embedder="auto": ref["fvd"]  # noqa: E731
        probability_future_bpp = lambda self, key: ref["probability_future"]  # noqa: E731
        elbo_gap = lambda self, key: ref["elbo_gap"]  # noqa: E731

    meta = json.loads((tmp_path / "model_folder" / "last" / "meta.json").read_text())
    monkeypatch.setattr(jax_cli, "Evaluator", JaxResults)
    monkeypatch.setattr(jax_cli, "load_model_from_checkpoint", lambda d, t: (
        jm, v, JTrainConfig(**dataclasses.asdict(tcfg)), meta))
    argv = ["--path", str(tmp_path)] + CLI_ARGS
    jax_cli.main(argv)
    want = json.loads((tmp_path / "eval" / "evaluations.json").read_text())
    payload = port_cli.main(argv + ["--device", "cpu"])
    got = json.loads((tmp_path / "eval" / "evaluations.json").read_text())
    assert _key_tree(got) == _key_tree(want)
    assert got["_meta"] == want["_meta"] and got["_meta"]["model_class"] == "RFN"
    assert _all_finite({k: x for k, x in got.items() if k != "_meta"})
    assert got["fvd"]["embedder"] == "random3d"
    assert set(payload) == set(got)
    lines = (tmp_path / "eval" / "eval_avg_losses.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[1].startswith("temp=None bpd=")


def test_eval_cli_protocol_flags_match_jax():
    from recurrent_flows_tpu.cli import eval_settings as jax_cli

    for argv in (["--path", "/x", "--thesis_protocol"], ["--path", "/x"],
                 ["--path", "/x", "--thesis_protocol", "--temperature", "0.5",
                  "--n_sequences", "16", "--no-use_lpips"]):
        want = vars(jax_cli.apply_thesis_protocol(jax_cli.build_parser().parse_args(argv)))
        got = vars(port_cli.apply_thesis_protocol(port_cli.build_parser().parse_args(argv)))
        assert got.pop("device") == "cuda"  # the card unless asked
        assert got == want
    args = port_cli.apply_thesis_protocol(port_cli.build_parser().parse_args(
        ["--path", "/x", "--thesis_protocol"]))
    assert (args.n_conditions, args.n_predictions, args.resamples, args.fvd_horizon,
            args.temperature, args.n_sequences) == (5, 25, 30, 13, 0.7, 128)


# the ids name the ROADMAP items these sources were missing under; both
# are ported now, and the ids stay those of the earlier test
@pytest.mark.parametrize("data", ["shapes", "kth", "bair"],
                         ids=["shapes-item 5b", "kth-item 7", "bair-item 7"])
def test_eval_cli_names_what_the_port_lacks(data, tmp_path):
    """The eval CLI's data: the shapes are made on the device; KTH and BAIR
    are read from PNG trees, and without one what is missing is the data,
    named by the FileNotFoundError."""
    args = dataclasses.make_dataclass("A", ["choose_data", "data_root", "n_frames",
                                            "batch_size", "image_size"])(
        data, str(tmp_path), 10, 8, 32)
    if data == "shapes":
        x = port_common.build_dataset(args, train=False, device="cpu").sample(
            torch.Generator().manual_seed(0), 2)
        assert x.shape == (2, 10, 32, 32, 1) and x.device.type == "cpu"
        return
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        port_common.build_dataset(args, train=False, device="cpu")
