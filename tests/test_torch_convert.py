"""from_flax: every leaf of a JAX RFN's parameter and const trees lands in
the port, and anything missing, extra or misshapen raises; a gradient tree
converts the same way and optax's Adam state loads into torch's. Also the
port's own configs against the JAX package's, and the configurations the
port refuses at construction."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from recurrent_flows_tpu import config as jconfig
from recurrent_flows_tpu import configs as jconfigs
from recurrent_flows_tpu.models import RFN as JRFN
from recurrent_flows_tpu_torch import config as pconfig
from recurrent_flows_tpu_torch.config import check_supported, rfn_mnist_production
from recurrent_flows_tpu_torch.convert import adam_from_optax, from_flax, tree_from_flax
from recurrent_flows_tpu_torch.models import RFN


@pytest.fixture(scope="module")
def small_rfn():
    """Every leaf kind: conv kernels and biases, batch-norm scale/bias,
    actnorm, LU + consts, Conv2dZeros logs, realnvp scales, peepholes of
    both LSTMs, learned initial states."""
    cfg = U.tiny_rfn_config(
        image_size=32, L=2, K=2, enable_smoothing=True,
        extractor_structure=((4, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8)))
    x0 = jnp.zeros((2, 2, 32, 32, 1))
    v = jax.jit(JRFN(cfg, remat=False).init)(jax.random.key(0), x0, jax.random.key(1))
    return cfg, jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray, v["consts"])


def _flat(tree, prefix=()):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (k,))
        else:
            yield prefix + (k,), val


def test_from_flax_consumes_every_leaf(small_rfn):
    cfg, params, consts = small_rfn
    model = RFN(U.to_port(cfg))
    state = from_flax(params, consts, model)
    leaves = list(_flat(params)) + list(_flat(consts))
    assert len(state) == len(leaves) == len(model.state_dict())
    for path, leaf in leaves:
        got = state[".".join(path)].numpy()
        want = leaf.transpose(3, 2, 0, 1) if path[-1] == "kernel" and leaf.ndim == 4 else leaf
        assert np.array_equal(got, want), path
    model.load_state_dict(state)  # strict: names and shapes agree
    assert {n for n, _ in model.named_buffers()} == {
        ".".join(p) for p, _ in _flat(consts)}


def test_from_flax_raises_on_missing_extra_or_misshapen_leaves(small_rfn):
    cfg, params, consts = small_rfn
    model = RFN(U.to_port(cfg))
    extra = dict(params, stray={"kernel": np.zeros((3, 3, 1, 1), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        from_flax(extra, consts, model)
    missing = {k: v for k, v in params.items() if k != "h_0"}
    with pytest.raises(KeyError, match="h_0"):
        from_flax(missing, consts, model)
    with pytest.raises(KeyError, match="sign_s"):
        from_flax(params, None, model)
    bad = dict(params, z_0=np.zeros((1, 2, 2, 99), np.float32))
    with pytest.raises(ValueError, match="z_0"):
        from_flax(bad, consts, model)
    # a const handed in as a trainable parameter has no counterpart
    moved = dict(params, flow=dict(params["flow"], scale0_step0=dict(
        params["flow"]["scale0_step0"],
        invconv=dict(params["flow"]["scale0_step0"]["invconv"],
                     p=consts["flow"]["scale0_step0"]["invconv"]["p"]))))
    with pytest.raises(KeyError, match="invconv/p"):
        from_flax(moved, consts, model)


def test_tree_from_flax_and_adam_from_optax(small_rfn):
    """A tree shaped like the parameters (gradients, moments) converts with
    the parameters' layout changes, and the Adam state lands on each
    parameter; a tree that leaves a parameter out, or carries a const, raises."""
    cfg, params, consts = small_rfn
    model = RFN(U.to_port(cfg))
    rng = np.random.default_rng(0)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    nu = jax.tree.map(lambda a: rng.uniform(0, 1, a.shape).astype(np.float32), params)
    got = tree_from_flax(mu, model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    k = mu["lstm"]["gates"]["kernel"]
    assert np.array_equal(got["lstm.gates.kernel"].numpy(), k.transpose(3, 2, 0, 1))
    assert np.array_equal(got["h_0"].numpy(), mu["h_0"])
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    adam_from_optax(mu, nu, 7, model, opt)
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == 7.0
        assert torch.equal(st["exp_avg"], got[name])
        assert st["exp_avg_sq"].shape == p.shape
    with pytest.raises(KeyError, match="h_0"):
        tree_from_flax({k: v for k, v in mu.items() if k != "h_0"}, model)
    with pytest.raises(KeyError, match="no counterpart"):
        tree_from_flax(dict(mu, flow=consts["flow"]), model)
    with pytest.raises(ValueError, match="does not hold"):
        adam_from_optax(mu, nu, 7, model,
                        torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))]))


@pytest.mark.parametrize("name", ["GlowConfig", "RFNConfig", "TrainConfig"])
def test_port_configs_have_the_jax_fields_and_defaults(name):
    """The port keeps its own copy of the config dataclasses (it imports
    nothing of the JAX package): same fields, same defaults."""
    ours, theirs = getattr(pconfig, name), getattr(jconfig, name)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert not isinstance(ours(), theirs)


def test_port_preset_and_dsl_match_jax():
    for ours, theirs in zip(rfn_mnist_production(), jconfigs.rfn_mnist_production()):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert U.to_port(theirs) == ours  # asdict -> config_from_dict round trip
    specs = ["16-16-pool-32", "upsample-8", "4-conv"]
    assert pconfig.parse_structure(specs) == jconfig.parse_structure(specs)
    assert pconfig.parse_structure("8-pool 16") == jconfig.parse_structure("8-pool 16")
    assert pconfig.parse_block("32-32-pool") == (32, 32, "pool")
    cfg = pconfig.RFNConfig(L=2, K=3, extractor_structure=((4,), (8,)),
                            upscaler_structure=((8,), ("upsample", 4)))
    assert (cfg.glow.L, cfg.glow.K) == (2, 3)  # the flow's depth follows the model's
    with pytest.raises(ValueError, match="one block per flow scale"):
        pconfig.RFNConfig(L=3)


def _glow(**kw):
    cfg, _ = rfn_mnist_production()
    return dataclasses.replace(cfg, glow=dataclasses.replace(cfg.glow, **kw))


@pytest.mark.parametrize("cfg,exc", [
    (_glow(packed_layout="lanes"), ValueError),
    (_glow(dual_stream=True), ValueError),
    (_glow(coupling_dtype="bfloat16"), ValueError),
    (_glow(fold_weights=False), ValueError),
    (_glow(coupling_impl="im2col"), ValueError),
    (_glow(chain_impl="always"), ValueError),
    (_glow(clamp_type="tanh"), ValueError),
    (_glow(flow_norm="batchnorm"), NotImplementedError),
    (_glow(base_norm="batchnorm"), NotImplementedError),
    (_glow(lu_decomposed=False), NotImplementedError),
    (dataclasses.replace(rfn_mnist_production()[0], track_running_stats=True),
     NotImplementedError),
], ids=["packed_layout", "dual_stream", "coupling_dtype", "fold_weights",
        "im2col", "bad_chain_impl", "bad_clamp", "batchnorm_flow", "base_norm",
        "no_lu", "running_stats"])
def test_unsupported_configs_raise_at_construction(cfg, exc):
    with pytest.raises(exc):
        check_supported(cfg)
    with pytest.raises(exc):
        RFN(cfg, device="meta")


def test_the_slice_config_is_supported():
    check_supported(_glow(chain_impl="sample"))
    check_supported(_glow(chain_impl="off"))
    # the training slice's kernels: the whole-step kernel and the chain forward
    check_supported(_glow(coupling_impl="fused"))
    check_supported(_glow(chain_impl="all"))
    RFN(_glow(chain_impl="all", coupling_impl="fused"), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(dataclasses.replace(
            rfn_mnist_production()[0],
            extractor_structure=((16, "squeeze"),) * 5))
