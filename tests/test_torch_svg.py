"""The port's ``SVG`` against the JAX package, on converted weights with
the JAX draws replayed (``torch_family_utils``, which states the
tolerances): the loss pieces and gradients over its three likelihoods,
recomputation, batch norm (float64) and running statistics with
``eval_norm``; ``predict``, ``reconstruct``, ``sample`` and the IW-ELBO;
``stats_refresh``; the encoder and decoder at 64x64 (four stages, a 4x4
'VALID' bottleneck and its transposed conv).

Size: B=2, T=4, 16x16 gray frames, g = 16, rnn 16, z = 4.
"""

import jax
import numpy as np
import pytest
import torch

import torch_family_utils as F
from torch_family_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
import torch_parity_utils as U
from recurrent_flows_tpu.models.svg import SVGDecoder as JDecoder
from recurrent_flows_tpu.models.svg import SVGEncoder as JEncoder
from recurrent_flows_tpu_torch.models.svg import SVGDecoder, SVGEncoder

TOL_DEEP = 1e-4  # the 64x64 encoder and decoder (see the test)
NONE = dict(norm_type="none")
LOSS_CASES = {
    "mse": (NONE, {}),
    "bernoulli_remat": (dict(NONE, loss_type="bernoulli"), dict(remat=True)),
    "gaussian_two_layer_lstms": (dict(NONE, loss_type="gaussian", variance=0.3,
                                      posterior_rnn_layers=2, prior_rnn_layers=2), {}),
    "batchnorm_f64": ({}, dict(f64=True)),
    "eval_norm": (dict(track_running_stats=True), dict(eval_norm=True)),
}
METHOD_CASES = {
    "mse": (NONE, {}),
    # batch norm over each of the K samples' own batch, as the JAX vmap
    "batchnorm_f64": ({}, dict(f64=True)),
    "eval_norm": (dict(track_running_stats=True), dict(eval_norm=True)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_pieces_and_gradients_match_jax(case, monkeypatch):
    kw, opts = LOSS_CASES[case]
    F.check_loss_and_grads(F.config("SVG", **kw), monkeypatch, **opts)


@pytest.mark.parametrize("case", list(METHOD_CASES))
def test_predict_reconstruct_sample_and_iw_elbo_match_jax(case, monkeypatch):
    kw, opts = METHOD_CASES[case]
    F.check_methods(F.config("SVG", **kw), monkeypatch, **opts)


def test_stats_refresh_updates_the_running_statistics_as_jax():
    # the encoder's 4 layers and bottleneck, the decoder's up0 and 3 layers
    F.check_stats_refresh(F.config("SVG", track_running_stats=True), 9)


def test_encoder_and_decoder_at_64x64_match_jax():
    """The preset's geometry: 4 stages (2, 2, 3, 3 layers), the 4x4 'VALID'
    bottleneck, ``up0`` a 'VALID' 4x4 transposed conv from 1x1, decoder
    stages of 3, 3, 2, 1 layers; batch norm on, B=2. Each element within
    1e-4·(1+|ref|): up to 10 float32 convs deep, with sums of up to 9·1024
    terms each, the two frameworks differ by up to 1.5e-5 of it."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    je = JEncoder(8, 64)
    ve = {"params": U.perturb(jax.jit(je.init)(jax.random.key(0), x)["params"], 0, 0.01)}
    h, skips = jax.jit(je.apply)(ve, x)
    enc = U.port_from(SVGEncoder(8, 64, 1, device="cpu"), ve)
    got_h, got_skips = enc(torch.tensor(x))
    U.assert_close_rel(got_h.detach().numpy(), np.asarray(h), TOL_DEEP, "h")
    assert [tuple(s.shape) for s in got_skips] == [
        (2, 64, 64, 64), (2, 32, 32, 128), (2, 16, 16, 256), (2, 8, 8, 512)]
    for i, (g, r) in enumerate(zip(got_skips, skips)):
        U.assert_close_rel(g.detach().numpy(), np.asarray(r), TOL_DEEP, f"skip {i}")
    jd = JDecoder(8, 64, 1)
    vd = {"params": U.perturb(jax.jit(jd.init)(jax.random.key(1), h, skips)["params"], 1,
                              0.01)}
    ref = jax.jit(jd.apply)(vd, h, skips)
    dec = U.port_from(SVGDecoder(8, 64, 1, device="cpu"), vd)
    got = dec(torch.tensor(np.asarray(h)), [torch.tensor(np.asarray(s)) for s in skips])
    assert got.shape == (2, 64, 64, 1)
    U.assert_close_rel(got.detach().numpy(), np.asarray(ref), TOL_DEEP, "frame")
