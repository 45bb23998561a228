"""Which scales the two GlowStep kernels take, and the folded 1x1 above 64
channels, on the CPU.

The gates (``GlowStep.fused_eligible``, ``ListGlow.chain_eligible``) admit
a scale only where ``ops.launch_plan`` has a plan for its shape
(``ops.plan_exists``) and the step is the one the kernels compute (relu,
actnorm step norm and coupling norm, LU 1x1). At every preset and skip mode
where a shape has no plan, that scale takes the module path; the model
then equals the JAX package's module path. The folded 1x1's plan
(``ops.ainv_plan``) tiles every width above 64 channels (and the RGB widths
24-96), each term of each output covered once.

Tolerances: ``RFN.loss`` pieces within 1e-5·(1+|ref|) and gradients as in
test_torch_loss.py; ``RFN.predict`` atol 2e-5 on the first predicted frame,
1e-4 on all, as in test_torch_rfn.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu_torch import config as pconfig
from recurrent_flows_tpu_torch.convert import tree_from_flax
from recurrent_flows_tpu_torch.flows import glow as tglow
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.ops import ainv_plan, launch_plan, plan_exists
from recurrent_flows_tpu_torch.ops.fused import AINV_REGISTER_WORK, AINV_TILE_ROWS, N_SMS
from recurrent_flows_tpu_torch.utils import NoiseSource
from test_torch_flow_kernel_plans import _check_ainv_plan

# (preset, skip mode) -> the scales whose launch plan raises, at B = 8 and at
# the preset's training batch
NO_PLAN = {
    ("rfn_mnist_production", "with_skip"): {1},  # 16x16x8, cond 96
    ("rfn_mnist_production", "without_skip"): set(),
    ("rfn_kth", "with_skip"): {1},  # 16x16x4, cond 192
    ("rfn_bair", "without_skip"): {1},  # 16x16x12, cond 64
    ("rfn_bair", "with_skip"): {1, 2},  # 16x16x12 cond 192, 8x8x48 cond 384
}


def _preset(name, skip, **glow):
    model, train = getattr(pconfig, name)()
    model = dataclasses.replace(model, skip_connection_flow=skip,
                                glow=dataclasses.replace(model.glow, **glow))
    return model, train


@pytest.mark.parametrize("preset,skip", sorted(NO_PLAN))
def test_gates_agree_with_the_launch_plan(preset, skip):
    cfg, tcfg = _preset(preset, skip, chain_impl="all", coupling_impl="fused")
    model = RFN(cfg, device="meta")
    flow = model.flow
    for b in (8, tcfg.batch_size):
        for l, (hw, c, cc) in enumerate(flow.scale_shapes):
            fits = True
            try:
                launch_plan(b, hw, hw, c, cc, cfg.glow.n_units_affine)
            except ValueError:
                fits = False
            if hw * hw > tglow.CHAIN_MAX_HW:
                assert not flow.chain_eligible(l, b, reverse=False)
                continue
            assert fits == (l not in NO_PLAN[(preset, skip)]), (b, l)
            assert plan_exists(b, hw, hw, c, cc, cfg.glow.n_units_affine) == fits
            x = torch.empty((b, hw, hw, c), device="meta")
            cond = torch.empty((b, hw, hw, cc), device="meta")
            for reverse in (False, True):
                assert flow.chain_eligible(l, b, reverse) == fits, (b, l, reverse)
            assert flow.step(l, 0).fused_eligible(x, cond) == fits, (b, l)
            # a step the kernels do not compute never goes to them
            for knob in (dict(flow_norm="batchnorm"), dict(lu_decomposed=False),
                         dict(coupling_norm="batchnorm"), dict(coupling_norm="none"),
                         dict(non_lin="leakyrelu")):
                g = dataclasses.replace(cfg.glow, **knob)
                assert not tglow.kernel_fits(g, b, hw, hw, c, cc), knob


def test_plan_exists_is_false_on_bad_shapes():
    assert not plan_exists(8, 4, 4, 7, 16, 16)  # odd C
    assert not plan_exists(0, 4, 4, 8, 16, 16)
    with pytest.raises(ValueError, match="bad shape"):
        launch_plan(8, 4, 4, 7, 16, 16)


# --- a tiny model with a scale that has no plan --------------------------------

IMG, B, T = 32, 2, 3


def _tiny(**glow):
    """32x32, L=2: scale 0 (16x16x4) has a 192-channel condition, which no
    launch plan takes; scale 1 (8x8x8, cond 32) fits."""
    return U.tiny_rfn_config(
        image_size=IMG, L=2, K=2, glow={"chain_impl": "off", **glow},
        extractor_structure=((128, "pool"), (16, "pool")),
        upscaler_structure=((16,), ("upsample", 64)))


@pytest.fixture(scope="module")
def tiny_jax():
    cfg = _tiny()  # the JAX module path
    jm, v = U.jax_rfn_variables(cfg, seed=3)
    x = np.random.default_rng(4).uniform(-0.5, 0.5, (B, T, IMG, IMG, 1)).astype(np.float32)
    return cfg, jm, v, x


def test_tiny_model_has_one_scale_without_a_plan():
    flow = RFN(U.to_port(_tiny(chain_impl="all")), device="meta").flow
    assert flow.scale_shapes == [(16, 4, 192), (8, 8, 32)]
    assert [flow.chain_eligible(l, B) for l in range(2)] == [False, True]


@pytest.mark.parametrize("glow", [dict(coupling_impl="fused"), dict(chain_impl="all")],
                         ids=["fused", "chain_all"])
def test_loss_with_kernels_asked_equals_jax_module_path(tiny_jax, glow, monkeypatch):
    cfg, jm, v, x = tiny_jax
    key = jax.random.key(5)

    def objective(params):
        out = jm.apply({**v, "params": params}, x, key, method="loss")
        return out["nll"] + 0.5 * out["kl_free_bits"], out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(v["params"])
    model = U.port_from(RFN(U.to_port(_tiny(**glow))), v)
    calls = []
    for name in ("glowstep", "glowchain"):
        kernel = getattr(tglow, name)
        monkeypatch.setattr(tglow, name, lambda *a, _k=kernel: (
            calls.append(tuple(a[0].shape)), _k(*a))[1])
    out = model.loss(torch.tensor(x), NoiseSource(replay=U.rfn_loss_noise(key, cfg, B, T)))
    for k, r in ref.items():
        assert abs(out[k].item() - float(r)) <= 1e-5 * (1 + abs(float(r))), k
    # only scale 1 (8x8x8) reaches a kernel; scale 0 takes the module path
    assert calls and set(calls) == {(B, 8, 8, 8)}
    (out["nll"] + 0.5 * out["kl_free_bits"]).backward()
    want = tree_from_flax(ref_grads, model)
    floor = 1e-6 * max(r.abs().max().item() for r in want.values())
    for pname, p in model.named_parameters():
        r = want[pname].numpy()
        if p.grad is None:  # a parameter this configuration does not use
            assert not r.any(), pname
            continue
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4,
                                   atol=max(1e-4 * np.abs(r).max(), floor), err_msg=pname)


def test_predict_with_the_chain_asked_equals_jax_module_path(tiny_jax):
    cfg, jm, v, x = tiny_jax
    key = jax.random.key(6)
    _, ref = jax.jit(lambda v, x, k: jm.apply(v, x, 2, 2, k, method="predict"))(v, x, key)
    model = U.port_from(RFN(U.to_port(_tiny(chain_impl="sample"))), v)
    assert sorted(model.flow.prepare_chain(B)) == [1]
    noise = NoiseSource(replay=U.rfn_predict_noise(key, cfg, B, 2, 2))
    _, got = model.predict(torch.tensor(x), 2, 2, noise)
    assert noise.exhausted()
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# --- F1: the folded 1x1 above 64 channels ---------------------------------------


@pytest.mark.parametrize("rows", [32 * 16, 8 * 16, 7, 1, 131])
@pytest.mark.parametrize("c", [128, 192, 256, 66, 100])
def test_ainv_plan_tiles_every_width_above_64(rows, c):
    plan = ainv_plan(rows, c)
    assert plan.vec == 2
    assert ainv_plan(rows, c, aligned=False) == plan  # scalar loads: any alignment
    # under two waves of N_SMS blocks until the tiles hold AINV_TILE_ROWS rows
    assert plan.blocks < 2 * N_SMS or plan.rows_per_block == AINV_TILE_ROWS
    _check_ainv_plan(plan, rows, c)


# x [B·H·W, C] at rfn_bair's four scales (train B=32), then ragged rows
@pytest.mark.parametrize("rows,c", [(32 * 1024, 12), (32 * 256, 24), (32 * 64, 48),
                                    (32 * 16, 96), (7, 12), (131, 24), (1, 48), (33, 96)])
def test_ainv_plan_takes_the_rgb_widths_in_registers(rows, c):
    # C = 12, and 24-96 up to AINV_REGISTER_WORK (rows · C²), in the
    # compile-time instance, a thread's row and W's rows in registers; the
    # train step's 24, 48 and 96 (B=32) in the tile design, a 4x4 register
    # tile per thread over x and W staged in shared memory
    plan = ainv_plan(rows, c)
    if c == 12 or rows * c * c <= AINV_REGISTER_WORK:
        assert plan.vec == 1 and plan.lanes == (4 if c >= 32 else 1)
        assert plan.groups == (1 if c == 12 else 2)  # a power of 2 dividing C/4
    else:
        assert rows == 32 * (96 // c) ** 2 * 16 and plan.vec == 2 and plan.k_stage == c
    _check_ainv_plan(plan, rows, c)
    # unaligned pointers: the run-time width up to 64, the tiles above
    assert ainv_plan(rows, c, aligned=False).vec == (0 if c <= 64 else 2)
    _check_ainv_plan(ainv_plan(rows, c, aligned=False), rows, c)


def test_ainv_plan_keeps_the_measured_regimes_up_to_64():
    # the widths of rfn_mnist_production keep their measured plans (vec 1), other
    # widths up to 64 the run-time one
    assert all(ainv_plan(30 * 16, c).vec == 1 for c in (4, 8, 16, 32, 64))
    assert ainv_plan(50, 40).vec == 0 and ainv_plan(50, 65).vec == 2
