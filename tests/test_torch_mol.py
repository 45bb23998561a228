"""The port's discretized mixture of logistics (``ops/mol.py``) against the
JAX package's (``recurrent_flows_tpu/ops/mol.py``): log-probabilities,
RGB and 1-D, on the 8-bit grid and its edges (±1, where the edge cases
take over) and off it; their gradients; samples with JAX's two uniforms
replayed. Both sides float32. A log-probability is a log of
sigmoid(a) - sigmoid(b) for a, b one bin apart, a difference that cancels
the leading digits, so the two frameworks' sigmoids (a few ulps apart)
give log-probabilities up to 2e-5·(1+|ref|) apart: they and their
gradients are held within 1e-4·(1+|ref|), as ``tests/test_mol.py`` holds the
JAX package's against the reference. Samples, which take no such
difference, within 1e-5·(1+|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_family_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.ops import mol as jmol
from recurrent_flows_tpu_torch.ops import mol
from recurrent_flows_tpu_torch.utils import NoiseSource

B, H, W, NMIX, TOL, TOL_LOG_PROB = 2, 6, 6, 3, 1e-5, 1e-4
FAMILIES = {"rgb": (3, 10, jmol.mol_log_prob_rgb, mol.mol_log_prob_rgb,
                    jmol.mol_sample_rgb, mol.mol_sample_rgb),
            "1d": (1, 3, jmol.mol_log_prob_1d, mol.mol_log_prob_1d,
                   jmol.mol_sample_1d, mol.mol_sample_1d)}


def _inputs(c, per, grid: bool, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, H, W, c)).astype(np.float32)
    if grid:  # the 8-bit grid, with its two edges present
        x = (np.round((x + 1) * 127.5) / 127.5 - 1.0).astype(np.float32)
        x[0, 0, 0], x[0, 0, 1] = -1.0, 1.0
    logits = (2 * rng.standard_normal((B, H, W, per * NMIX))).astype(np.float32)
    return x, logits


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert (np.abs(got - ref) <= tol * (1 + np.abs(ref))).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "off_grid"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_log_prob_and_its_gradient_match_jax(family, grid):
    c, per, jfn, fn, _, _ = FAMILIES[family]
    x, logits = _inputs(c, per, grid)
    ref, ref_grad = jfn(x, logits), jax.grad(lambda l: jnp.sum(jfn(x, l)))(logits)
    lt = torch.tensor(logits, requires_grad=True)
    got = fn(torch.tensor(x), lt)
    assert got.shape == (B, H, W)
    _close(got.detach(), ref, TOL_LOG_PROB)
    got.sum().backward()
    _close(lt.grad, ref_grad, TOL_LOG_PROB)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sample_matches_jax_on_replayed_uniforms(family):
    c, per, _, _, jsample, sample = FAMILIES[family]
    _, logits = _inputs(c, per, True, seed=1)
    key = jax.random.key(5)
    ref = jsample(key, jnp.asarray(logits))
    k1, k2 = jax.random.split(key)
    draws = [np.asarray(jax.random.uniform(k1, (B, H, W, NMIX), minval=1e-5,
                                           maxval=1.0 - 1e-5)),
             np.asarray(jax.random.uniform(k2, (B, H, W, c), minval=1e-5,
                                           maxval=1.0 - 1e-5))]
    noise = NoiseSource(replay=draws)
    got = sample(noise, torch.tensor(logits))
    assert noise.exhausted() and got.shape == (B, H, W, c)
    _close(got, ref)
    assert got.min() >= -1 and got.max() <= 1


def test_log_prob_is_a_pmf_over_the_8_bit_grid():
    """exp(log p) summed over the 256 levels is 1 (1-D, one pixel)."""
    logits = torch.randn(1, 1, 1, 3 * NMIX, generator=torch.Generator().manual_seed(0))
    grid = (torch.arange(256.0) / 127.5 - 1.0).reshape(256, 1, 1, 1)
    total = mol.mol_log_prob_1d(grid, logits.expand(256, 1, 1, -1)).exp().sum()
    assert abs(total.item() - 1.0) < 1e-3


def test_fresh_samples_are_in_range_and_follow_the_generator():
    logits = torch.randn(B, H, W, 10 * NMIX)
    draw = lambda s: mol.DiscretizedMixtureLogits(NMIX).sample(
        NoiseSource(generator=torch.Generator().manual_seed(s)), logits)
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (B, H, W, 3) and a.abs().max() <= 1
