"""The port's ``SRNN`` against the JAX package, on converted weights with
the JAX draws replayed (``torch_family_utils``, which states the
tolerances): the loss pieces and gradients over the four likelihoods,
smoothing on and off, the residual posterior, latent overshooting (D=1),
recomputation, batch norm (float64) and running statistics with
``eval_norm``, the options combined into six configurations; ``predict``,
``reconstruct``, ``sample`` and the IW-ELBO, with and without batch norm.

Size: B=2, T=4, 16x16 gray frames, h = a = 8, z = 4.
"""

import pytest
import torch

import torch_family_utils as F
from torch_family_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
import torch_parity_utils as U
from recurrent_flows_tpu_torch.models import SRNN
from recurrent_flows_tpu_torch.utils import NoiseSource

NONE = dict(norm_type="none")
EVAL = dict(track_running_stats=True, loss_type="gaussian")  # batch norm on
MOL = dict(NONE, loss_type="mol", preprocess_range="minmax", enable_smoothing=False,
           res_q=True, D=1)
LOSS_CASES = {
    "bernoulli": (NONE, {}),
    "gaussian_res_q": (dict(NONE, loss_type="gaussian", res_q=True), {}),
    "mse_overshoot_D1_remat": (dict(NONE, loss_type="mse", D=1, overshot_w=0.7),
                               dict(remat=True)),
    "mol_no_smoothing_res_q_D1_remat": (MOL, dict(remat=True)),
    "batchnorm_f64": ({}, dict(f64=True)),
    "eval_norm_gaussian": (EVAL, dict(eval_norm=True)),
}
METHOD_CASES = {
    "bernoulli": (NONE, {}),
    "mol_no_smoothing_res_q": (MOL, {}),
    # batch norm over each of the K samples' own batch: folding K into the
    # batch axis would give other statistics and fail here
    "batchnorm_f64": ({}, dict(f64=True)),
    "eval_norm_gaussian": (EVAL, dict(eval_norm=True)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_pieces_and_gradients_match_jax(case, monkeypatch):
    kw, opts = LOSS_CASES[case]
    F.check_loss_and_grads(F.config("SRNN", **kw), monkeypatch, **opts)


@pytest.mark.parametrize("case", list(METHOD_CASES))
def test_predict_reconstruct_sample_and_iw_elbo_match_jax(case, monkeypatch):
    kw, opts = METHOD_CASES[case]
    F.check_methods(F.config("SRNN", **kw), monkeypatch, **opts)


def test_stats_refresh_updates_the_running_statistics_as_jax():
    # the norms of phi_x (4), phi_z, enc, prior and dec (5)
    F.check_stats_refresh(F.config("SRNN", **EVAL), 12)


def test_loss_checks_its_input_and_draws_from_a_generator():
    model = SRNN(U.to_port(F.config("SRNN", norm_type="none")), device="cpu")
    with pytest.raises(ValueError, match="B, T"):
        model.loss(torch.zeros(2, 16, 16, 1), NoiseSource(generator=torch.Generator()))
    x = torch.rand(2, 3, 16, 16, 1)
    outs = [model.loss(x, NoiseSource(generator=torch.Generator().manual_seed(s)))
            for s in (0, 0, 1)]
    assert all(torch.isfinite(v) for v in outs[0].values())
    assert outs[0]["kl"] == outs[1]["kl"] and outs[0]["kl"] != outs[2]["kl"]
