"""RFN's diagnostics against the JAX package, on converted weights and the
JAX draws replayed: ``param_analysis`` and ``reconstruct_elbo_gap`` (with
``sample`` True and False). Configuration, sizes and tolerance as in
``test_torch_rfn_lifecycle.py``: the tiny configuration of
``torch_parity_utils`` with ``chain_impl='sample'``, B=2, T=4, every
output within 1e-5·(1+|ref|), the replayed noise used up.
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


def test_param_analysis_matches_jax(pair):
    cfg, jm, v, tm = pair
    x, key = _frames(2), jax.random.key(5)
    ref = _jax(jm, "param_analysis", v, x, key)
    noise = _replay(U.rfn_param_analysis_noise(key, cfg, B, T))
    got = tm.param_analysis(torch.tensor(x), noise)
    assert noise.exhausted()
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], k)


@pytest.mark.parametrize("sample", [True, False])
def test_reconstruct_elbo_gap_matches_jax(pair, sample):
    cfg, jm, v, tm = pair
    x, key = _frames(4), jax.random.key(7)
    ref = _jax(jm, "reconstruct_elbo_gap", v, x, key, sample=sample)
    noise = _replay(U.rfn_elbo_gap_noise(key, cfg, B, T, sample))
    got = tm.reconstruct_elbo_gap(torch.tensor(x), noise, sample=sample)
    assert noise.exhausted()
    for name, g, r in zip(("recons", "recons_flow", "kld", "nll"), got, ref):
        if r is None:
            assert g is None, name
        else:
            _close(g, r, name)
    assert got[3].shape == (2, T - 1, B) and got[2].shape == (T - 1, B)
