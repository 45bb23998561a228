"""``RFN.loss`` and its gradients against the JAX package, on converted
weights and the JAX draws replayed, over the three configurations of the
training step (A module path, B ``coupling_impl='fused'``, C
``chain_impl='all'``), the three skip modes, smoothing, the residual
posterior, free bits, latent overshooting (D > 0) and per-frame
recomputation (``remat``), as cases of one parametrised test.

Size: 32x32 frames, L=2, K=2, U=16, B=2, T=4. The JAX side runs its Pallas
kernels interpreted on the CPU.

Tolerances (float32 on both sides): each loss piece within 1e-5·(1+|ref|);
each parameter's gradient within rtol 1e-4 and atol 1e-4 of the tensor's
largest entry (the two frameworks sum convolutions and reductions in
another order; measured 5e-6 to 7e-6 of the largest entry). A gradient
that is zero by construction (a conv bias in front of a batch norm) is
float noise on both sides, so the atol never goes below 1e-6 of the
largest gradient entry of the whole model.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu_torch.convert import tree_from_flax
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.utils import NoiseSource

IMG, B, T, BETA = 32, 2, 4, 0.5

VARIANTS = {
    "A_module_path": dict(),
    "B_fused": dict(glow=dict(coupling_impl="fused")),
    "C_chain_all": dict(glow=dict(chain_impl="all")),
    "only_skip": dict(skip_connection_flow="only_skip"),
    "no_skip_list": dict(skip_connection_flow="without_skip",
                         skip_connection_features=False, norm_type="batchnorm",
                         glow=dict(clamp_type="glow", split2d_act="exp",
                                   learn_prior=False)),
    "smoothing_res_q": dict(skip_connection_flow="without_skip",
                            enable_smoothing=True, res_q=True),
    "free_bits": dict(free_bits=1.0),
    "overshoot_D2": dict(D=2, overshot_w=0.7, enable_smoothing=True),
}
CASES = [(name, False) for name in VARIANTS] + [("A_module_path", True),
                                                ("C_chain_all", True)]


def _config(**kw):
    glow = dict(chain_impl="off")
    glow.update(kw.pop("glow", {}))
    return U.tiny_rfn_config(
        image_size=IMG, L=2, K=2, glow=glow,
        extractor_structure=((4, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8)), **kw)


_jax_results = {}


def _jax_loss_and_grads(name):
    """JAX loss pieces and gradients of nll + BETA·kl_free_bits, computed
    once per variant."""
    if name not in _jax_results:
        cfg = _config(**VARIANTS[name])
        jm, v = U.jax_rfn_variables(cfg)
        x = np.random.default_rng(0).uniform(
            -0.5, 0.5, (B, T, IMG, IMG, U.CIN)).astype(np.float32)
        key = jax.random.key(3)

        def objective(params):
            out = jm.apply({"params": params, "consts": v["consts"]}, x, key,
                           method="loss")
            return out["nll"] + BETA * out["kl_free_bits"], out

        (_, out), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            v["params"])
        _jax_results[name] = (cfg, v, x, key, {k: float(a) for k, a in out.items()},
                              grads)
    return _jax_results[name]


@pytest.mark.parametrize("name,remat", CASES,
                         ids=[n + ("_remat" if r else "") for n, r in CASES])
def test_loss_pieces_and_gradients_match_jax(name, remat):
    cfg, v, x, key, ref, ref_grads = _jax_loss_and_grads(name)
    model = U.port_from(RFN(U.to_port(cfg), remat=remat), v)
    noise = NoiseSource(replay=U.rfn_loss_noise(key, cfg, B, T))
    out = model.loss(torch.tensor(x), noise)
    assert noise.exhausted()  # every JAX draw consumed, in JAX's order
    assert set(out) == {"kl_free_bits", "kl", "nll"}
    for k, r in ref.items():
        assert abs(out[k].item() - r) <= 1e-5 * (1 + abs(r)), (k, out[k].item(), r)
    if name == "free_bits":
        assert out["kl_free_bits"].item() > out["kl"].item()
    (out["nll"] + BETA * out["kl_free_bits"]).backward()
    want = tree_from_flax(ref_grads, model)
    floor = 1e-6 * max(r.abs().max().item() for r in want.values())
    for pname, p in model.named_parameters():
        r = want[pname].numpy()
        if p.grad is None:  # a parameter this configuration does not use
            assert not r.any(), pname
            continue
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4,
                                   atol=max(1e-4 * np.abs(r).max(), floor),
                                   err_msg=pname)


def test_loss_draws_fresh_noise_from_a_generator_and_checks_its_input():
    cfg = _config()
    model = RFN(U.to_port(cfg))
    x = torch.tensor(np.random.default_rng(1).uniform(
        -0.5, 0.5, (B, 3, IMG, IMG, U.CIN)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a = model.loss(x, NoiseSource(generator=gen))
        b = model.loss(x, NoiseSource(generator=gen))
        c = model.loss(x, NoiseSource(generator=torch.Generator().manual_seed(0)))
    assert all(torch.isfinite(v) for v in a.values())
    assert a["nll"] != b["nll"] and a["nll"] == c["nll"]
    with pytest.raises(ValueError, match=r"\[B, T, H, W, C\]"):
        model.loss(x[:, 0], NoiseSource(generator=gen))
