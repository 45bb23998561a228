"""The rest of RFN against the JAX package, on converted weights and the JAX
draws replayed: ``reconstruct``, ``sample``, ``probability_future`` and the
interpolation API (``get_zt_ht_from_seq``, ``predicts_from_zt_ht``);
``ListGlow.sample`` given z. ``test_torch_rfn_diagnostics.py`` holds
``param_analysis`` and ``reconstruct_elbo_gap``,
``test_torch_rfn_lifecycle_variants.py`` and
``test_torch_rfn_batchnorm_reconstruct.py`` the other configurations and
the ``Predictor`` endpoints.

Configuration: the tiny one of ``torch_parity_utils`` (64x64, L=3, K=2,
U=16, ``chain_impl='sample'``: scale 0 on the module path, scales 1-2
through the chain in reverse), B=2, T=4. The JAX side runs its Pallas
kernels interpreted on the CPU.

Tolerance: every output within 1e-5·(1+|ref|) elementwise (the skip maps
of ``get_zt_ht_from_seq``: see there). No method here
feeds a frame it made back through the extractor except ``sample``, whose
later frames do, as ``predict``'s (measured ~2e-6 on outputs of order 3).
After each call the replayed noise must be used up.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu_torch.utils import NoiseSource

B, T, N_COND = 2, 4, 2
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return U.rfn_pair(U.tiny_rfn_config())


def _frames(seed=0, t=T, img=U.IMG):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (B, t, img, img, U.CIN)).astype(np.float32)


def _close(got, ref, what=""):
    U.assert_close_rel(got, ref, TOL, what)


def _jax(jm, method, v, *args, **kw):
    """The JAX method, jitted over the variables (the rest are constants)."""
    return jax.jit(lambda v: jm.apply(v, *args, method=method, **kw))(v)


def _replay(draws):
    return NoiseSource(replay=draws)


def test_reconstruct_matches_jax(pair):
    cfg, jm, v, tm = pair
    x, key = _frames(), jax.random.key(3)
    ref = _jax(jm, "reconstruct", v, x, key)
    noise = _replay(U.rfn_reconstruct_noise(key, cfg, B, T))
    recons, recons_flow = tm.reconstruct(torch.tensor(x), noise)
    assert noise.exhausted()
    assert recons.shape == (T - 1, B, U.IMG, U.IMG, U.CIN)
    assert recons.abs().max() > 0.1
    _close(recons, ref[0], "recons")
    _close(recons_flow, ref[1], "recons_flow")


def test_sample_matches_jax(pair):
    cfg, jm, v, tm = pair
    x, key, n = _frames(1), jax.random.key(4), 3
    ref = _jax(jm, "sample", v, x, n, key)
    noise = _replay(U.rfn_sample_noise(key, cfg, B, n))
    got = tm.sample(torch.tensor(x), n, noise)
    assert noise.exhausted()
    assert got.shape == (n, B, U.IMG, U.IMG, U.CIN) and got.abs().max() > 0.1
    _close(got, ref)


def test_probability_future_matches_jax(pair):
    cfg, jm, v, tm = pair
    x, key = _frames(3), jax.random.key(6)
    ref = _jax(jm, "probability_future", v, x, N_COND, key)
    noise = _replay(U.rfn_probability_future_noise(key, cfg, B, T, N_COND))
    got = tm.probability_future(torch.tensor(x), N_COND, noise)
    assert noise.exhausted()
    assert got.shape == (B, 2, T - N_COND)
    _close(got, ref)


def test_interpolation_api_matches_jax(pair):
    cfg, jm, v, tm = pair
    x, key, k2 = _frames(5), jax.random.key(8), jax.random.key(9)
    zt, ht, sk = _jax(jm, "get_zt_ht_from_seq", v, x, N_COND + 1, key)
    noise = _replay(U.posterior_scan_noise(key, cfg, B, N_COND + 1))
    got = tm.get_zt_ht_from_seq(torch.tensor(x), N_COND + 1, noise)
    assert noise.exhausted()
    _close(got[0], zt, "zt")
    _close(got[1], ht, "ht")
    # the skips are the extractor's maps, batch-normalised over all frames:
    # the two frameworks agree on them to 2.6e-5 (measured), so they are
    # held to atol 1e-4, as test_torch_rfn.py holds what passed the extractor
    assert len(got[2]) == len(sk)
    for g, r in zip(got[2], sk):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)
    ref = _jax(jm, "predicts_from_zt_ht", v, zt, ht, sk, k2)
    noise = _replay(U.flow_sample_noise(k2, cfg.glow, cfg.x_channels, cfg.image_size, B))
    frame = tm.predicts_from_zt_ht(*got, noise)
    assert noise.exhausted()
    _close(frame, ref)


def test_flow_sample_given_z_draws_no_base_eps(pair):
    """ListGlow.sample(z=...) maps z through g and draws only the split
    eps; eval_params returns the base distribution's (mean, std)."""
    cfg, _, _, tm = pair
    hu = cfg.image_size // 2 ** cfg.L
    g = torch.Generator().manual_seed(0)
    conds = [torch.randn((B, hw, hw, c), generator=g)
             for hw, c in zip(tm.flow.scale_hw, (m[2] for m in tm.flow.scale_shapes))]
    base = torch.randn((B, hu, hu, cfg.h_dim + cfg.z_dim), generator=g)
    hw, c = tm.flow.final_hw, tm.flow.final_channels
    z = torch.randn((B, hw, hw, c), generator=g)
    splits = U.flow_sample_noise(jax.random.key(1), cfg.glow, 1, cfg.image_size, B,
                                 base=False)
    with torch.no_grad():
        noise = _replay(splits)
        x = tm.flow.sample(conds, base, noise, 0.7, z=z)
        assert noise.exhausted()
        mean, log_scale = tm.flow.base_params(base, B)
        noise = _replay([((z - mean) / (torch.exp(log_scale) * 0.7)).numpy()] + splits)
        x2, (mu, std) = tm.flow.sample(conds, base, noise, 0.7, eval_params=True)
        assert noise.exhausted()
    torch.testing.assert_close(x2, x, rtol=1e-5, atol=1e-5)
    assert torch.equal(mu, mean) and torch.equal(std, torch.exp(log_scale))
