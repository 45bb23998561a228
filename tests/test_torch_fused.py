"""The port's coupling tail and ConvLSTM gates (recurrent_flows_tpu_torch.ops.fused)
against the JAX package's jnp versions and its Pallas kernels run in
interpret mode, on the same numpy inputs. On the CPU the wrappers take
their plain versions; the Triton kernels themselves are compared with the
plain versions on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: both sides compute the same float32 formula elementwise, so
they agree to a few ulps (atol/rtol 1e-6); the logdet is a sum of
B·H·W·C/2 terms taken in another order (rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recurrent_flows_tpu.ops.pallas import fused as jfused
from recurrent_flows_tpu_torch.ops import fused

B = 2


@pytest.fixture()
def force_pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas paths in interpreter mode on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("RFT_PALLAS", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


def _coupling_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, 32, 32, 2)  # AffineCoupling at scale 0 of a 64x64 image
    z2 = rng.standard_normal(shape).astype(np.float32)
    shift = rng.standard_normal(shape).astype(np.float32)
    s = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    return z2, shift, s


def _gates_inputs(seed=0, hw=2, hc=16):
    rng = np.random.default_rng(seed)
    gates = rng.standard_normal((B, hw, hw, 4 * hc)).astype(np.float32)
    c = rng.standard_normal((B, hw, hw, hc)).astype(np.float32)
    peeps = [(0.1 * rng.standard_normal((1, hw, hw, hc))).astype(np.float32)
             for _ in range(3)]
    return gates, c, peeps


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _check_coupling(got, ref):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_plain_matches_jnp(reverse):
    z2, shift, s = _coupling_inputs()
    ref = jfused._coupling_fwd_jnp(jnp.asarray(z2), jnp.asarray(shift), jnp.asarray(s), reverse)
    _check_coupling(fused.coupling_transform_ref(*_t(z2, shift, s), reverse), ref)


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_plain_matches_pallas_interpret(force_pallas_interpret, reverse):
    z2, shift, s = _coupling_inputs(1)
    ref = jfused._coupling_pallas(jnp.asarray(z2), jnp.asarray(shift), jnp.asarray(s), reverse)
    _check_coupling(fused.coupling_transform(*_t(z2, shift, s), reverse), ref)


def _check_gates(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_gates_plain_matches_jnp():
    gates, c, peeps = _gates_inputs()
    ref = jfused._gates_jnp(*(jnp.asarray(a) for a in (gates, c, *peeps)))
    _check_gates(fused.convlstm_gates_ref(*_t(gates, c, *peeps)), ref)


def test_gates_plain_matches_pallas_interpret(force_pallas_interpret):
    gates, c, peeps = _gates_inputs(1, hw=8, hc=8)
    ref = jfused._gates_pallas(*(jnp.asarray(a) for a in (gates, c, *peeps)))
    _check_gates(fused.convlstm_gates(*_t(gates, c, *peeps)), ref)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    z2, shift, s = _t(*_coupling_inputs())
    gates, c, peeps = _gates_inputs()
    before = (fused.coupling_transform.launches, fused.convlstm_gates.launches)
    out = fused.coupling_transform(z2, shift, s, True)
    ref = fused.coupling_transform_ref(z2, shift, s, True)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    h, cn = fused.convlstm_gates(*_t(gates, c, *peeps))
    rh, rc = fused.convlstm_gates_ref(*_t(gates, c, *peeps))
    assert torch.equal(h, rh) and torch.equal(cn, rc)
    assert (fused.coupling_transform.launches,
            fused.convlstm_gates.launches) == before


def test_wrappers_check_their_inputs():
    z2, shift, s = _t(*_coupling_inputs())
    with pytest.raises(TypeError):
        fused.coupling_transform(z2.double(), shift.double(), s.double())
    with pytest.raises(ValueError, match="shape"):
        fused.coupling_transform(z2, shift[:, :16], s)
    with pytest.raises(ValueError, match="contiguous"):
        fused.coupling_transform(z2.transpose(1, 2), shift.transpose(1, 2),
                                 s.transpose(1, 2))
    g_np, c_np, p_np = _gates_inputs()
    gates, c, *peeps = _t(g_np, c_np, *p_np)
    with pytest.raises(ValueError, match="shape"):
        fused.convlstm_gates(gates[..., :-4].contiguous(), c, *peeps)
    with pytest.raises(ValueError, match="shape"):
        fused.convlstm_gates(gates, c, peeps[0].expand(B, -1, -1, -1), *peeps[1:])
