"""The port's ``VRNN`` against the JAX package, on converted weights with
the JAX draws replayed (``torch_family_utils``, which states the
tolerances): the loss pieces and gradients over the likelihoods,
recomputation, batch norm (float64) and running statistics with
``eval_norm``; ``predict``, ``reconstruct``, ``sample`` and the IW-ELBO;
``stats_refresh``.

Size: B=2, T=4, 16x16 gray frames, h = 8, z = 4.
"""

import pytest

import torch_family_utils as F
from torch_family_utils import _two_torch_threads  # noqa: F401 (autouse fixture)

NONE = dict(norm_type="none")
LOSS_CASES = {
    "bernoulli": (NONE, {}),
    "gaussian_remat": (dict(NONE, loss_type="gaussian"), dict(remat=True)),
    "mse": (dict(NONE, loss_type="mse"), {}),
    "mol": (dict(NONE, loss_type="mol", preprocess_range="minmax"), {}),
    "batchnorm_f64_remat": ({}, dict(f64=True, remat=True)),
    "eval_norm": (dict(track_running_stats=True), dict(eval_norm=True)),
}
METHOD_CASES = {
    "bernoulli": (NONE, {}),
    "gaussian": (dict(NONE, loss_type="gaussian"), {}),
    "mol": (dict(NONE, loss_type="mol", preprocess_range="minmax"), {}),
    # batch norm over each of the K samples' own batch, as the JAX vmap
    "batchnorm_f64": ({}, dict(f64=True)),
    "eval_norm": (dict(track_running_stats=True), dict(eval_norm=True)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_pieces_and_gradients_match_jax(case, monkeypatch):
    kw, opts = LOSS_CASES[case]
    F.check_loss_and_grads(F.config("VRNN", **kw), monkeypatch, **opts)


@pytest.mark.parametrize("case", list(METHOD_CASES))
def test_predict_reconstruct_sample_and_iw_elbo_match_jax(case, monkeypatch):
    kw, opts = METHOD_CASES[case]
    F.check_methods(F.config("VRNN", **kw), monkeypatch, **opts)


def test_stats_refresh_updates_the_running_statistics_as_jax():
    # the norms of phi_x (4), phi_z, enc, prior and dec (5)
    F.check_stats_refresh(F.config("VRNN", track_running_stats=True), 12)
