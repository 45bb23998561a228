"""The port's dense and transposed-conv building blocks against the JAX
package's, on converted weights: ``DenseLSTMCell`` (gates i, f, g, o),
``SVGLSTM`` and ``SVGGaussianLSTM`` over a few steps (``nn/dense_lstm.py``);
``ConvTranspose2d`` against flax's ``nn.ConvTranspose`` on a kernel that
is not symmetric, 'SAME' (k=4, s=2) and 'VALID', which only the converter's
spatial flip makes agree; and the dense-latent nets of SRNN and VRNN
(``models/dense_latent.py``). Float32 on both sides; each element within
1e-5·(1+|ref|).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils as U
from torch_family_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.models import dense_latent as jdl
from recurrent_flows_tpu.nn import dense_lstm as jdn
from recurrent_flows_tpu_torch.convert import from_flax
from recurrent_flows_tpu_torch.models import dense_latent as dl
from recurrent_flows_tpu_torch.nn import ConvTranspose2d, dense_lstm
from recurrent_flows_tpu_torch.utils import NoiseSource

TOL = 1e-5
B = 3


def _close(got, ref, what=""):
    U.assert_close_rel(got.detach().numpy(), np.asarray(ref), TOL, what)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(module, params):
    module.load_state_dict(from_flax(params, None, module))
    return module


def _state(n_layers, hidden, seed):
    return tuple((_rand(B, hidden, seed=seed + i), _rand(B, hidden, seed=seed + 10 + i))
                 for i in range(n_layers))


def _tt(state):
    return tuple((torch.tensor(h), torch.tensor(c)) for h, c in state)


def test_dense_lstm_cell_matches_flax():
    jm = jdn.DenseLSTMCell(6)
    x, state = _rand(B, 5), _state(1, 6, 1)[0]
    p = U.perturb(jm.init(jax.random.key(0), x, state)["params"], 0)
    h, (h2, c2) = jm.apply({"params": p}, x, state)
    cell = _port(dense_lstm.DenseLSTMCell(5, 6), p)
    assert cell.gates.kernel.shape == (11, 24)  # flax's [in, out], as it is
    got, (gh, gc) = cell(torch.tensor(x), _tt([state])[0])
    for g, r, w in ((got, h, "h"), (gh, h2, "h"), (gc, c2, "c")):
        _close(g, r, w)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_svg_lstm_stacks_match_flax_over_steps(n_layers):
    xs = _rand(4, B, 7, seed=2)
    jf = jdn.SVGLSTM(5, 8, n_layers)
    jg = jdn.SVGGaussianLSTM(3, 8, n_layers)
    s0 = _state(n_layers, 8, 3)
    pf = U.perturb(jf.init(jax.random.key(0), xs[0], s0)["params"], 1)
    pg = U.perturb(jg.init(jax.random.key(1), xs[0], s0, jax.random.key(2))["params"], 2)
    pf_ = _port(dense_lstm.SVGLSTM(7, 5, 8, n_layers), pf)
    pg_ = _port(dense_lstm.SVGGaussianLSTM(7, 3, 8, n_layers), pg)
    sf = sg = s0
    tf = tg = _tt(s0)
    for t, x in enumerate(xs):
        key = jax.random.key(10 + t)
        out, sf = jf.apply({"params": pf}, x, sf)
        z, mu, std, sg = jg.apply({"params": pg}, x, sg, key)
        got, tf = pf_(torch.tensor(x), tf)
        eps = torch.tensor(np.asarray(jax.random.normal(key, (B, 3))))
        gz, gmu, gstd, tg = pg_(torch.tensor(x), tg, eps)
        for g, r, w in ((got, out, "out"), (gz, z, "z"), (gmu, mu, "mu"), (gstd, std, "std")):
            _close(g, r, f"{w} step {t}")
    for (gh, gc), (rh, rc) in zip(tf + tg, sf + sg):
        _close(gh, rh, "h")
        _close(gc, rc, "c")
    assert pg_(torch.tensor(xs[0]), tg)[0] is None  # no eps, no draw


@pytest.mark.parametrize("padding,k,s,hw", [("SAME", 4, 2, 3), ("VALID", 4, 1, 1),
                                            ("VALID", 3, 1, 2)])
def test_conv_transpose_matches_flax_on_an_asymmetric_kernel(padding, k, s, hw):
    jm = nn.ConvTranspose(5, (k, k), strides=(s, s), padding=padding)
    x = _rand(2, hw, hw, 4)
    p = jm.init(jax.random.key(0), x)["params"]
    kernel = np.asarray(p["kernel"])
    assert not np.allclose(kernel, kernel[::-1, ::-1])  # a flip would show
    p = {"kernel": kernel, "bias": _rand(5, seed=4)}
    ref = jm.apply({"params": p}, x)
    port = _port(ConvTranspose2d(4, 5, k, s, padding), p)
    got = port(torch.tensor(x))
    assert got.shape == ref.shape == ((2, 2 * hw, 2 * hw, 5) if padding == "SAME"
                                      else (2, hw + k - 1, hw + k - 1, 5))
    _close(got, ref)
    # without the flip the port would compute another function
    unflipped = torch.nn.functional.conv_transpose2d(
        torch.tensor(x).permute(0, 3, 1, 2),
        torch.tensor(kernel.transpose(2, 3, 0, 1)), torch.tensor(p["bias"]), s,
        port.padding).permute(0, 2, 3, 1)
    assert (unflipped - torch.tensor(np.asarray(ref))).abs().max() > 1e-2


def _dense_latent_pairs():
    """(JAX module, init args, port module, call args) of each net at h=2
    (16x16 frames), batch norm on."""
    img = _rand(B, 16, 16, 1, seed=5)
    fmap = _rand(B, 2, 2, 10, seed=6)
    z = _rand(B, 4, seed=7)
    return {
        "PhiX": (jdl.PhiX("batchnorm"), (img,), dl.PhiX(1, "batchnorm")),
        "PhiZ": (jdl.PhiZ(2, 2, 128, "batchnorm"), (z,), dl.PhiZ(4, 2, 2, "batchnorm")),
        "ConvMLPGaussian": (jdl.ConvMLPGaussian(4, "batchnorm"), (fmap,),
                            dl.ConvMLPGaussian(10, 2, 4, "batchnorm")),
        "FrameDecoder": (jdl.FrameDecoder("batchnorm"), (fmap,),
                         dl.FrameDecoder(10, "batchnorm")),
    }


@pytest.mark.parametrize("name", ["PhiX", "PhiZ", "ConvMLPGaussian", "FrameDecoder"])
def test_dense_latent_nets_match_flax(name):
    jm, args, port = _dense_latent_pairs()[name]
    p = U.perturb(jm.init(jax.random.key(0), *args)["params"], 0, 0.01)
    ref = jm.apply({"params": p}, *args)
    got = _port(port, p)(*(torch.tensor(a) for a in args))
    for g, r in zip(*((got, ref) if isinstance(ref, tuple) else ((got,), (ref,)))):
        _close(g, r, name)


@pytest.mark.parametrize("loss_type", ["bernoulli", "gaussian", "mse", "mol"])
def test_likelihood_head_matches_flax(loss_type):
    pr = "minmax" if loss_type == "mol" else "1.0"
    jm = jdl.LikelihoodHead(1, loss_type=loss_type, preprocess_range=pr, n_logistics=3)
    dec = _rand(B, 8, 8, 32, seed=8)
    x = np.random.default_rng(9).uniform(0, 1, (B, 8, 8, 1)).astype(np.float32)
    x = 2 * x - 1 if loss_type == "mol" else x
    key = jax.random.key(3)
    v = jm.init(jax.random.key(0), dec, x, key, method="nll")
    p = U.perturb(v["params"], 0, 0.01)
    nll = jm.apply({"params": p}, dec, x, key, method="nll")
    frame = jm.apply({"params": p}, dec, key, method="decode")
    head = _port(dl.LikelihoodHead(32, 1, loss_type, pr, 3), p)
    u = (np.asarray(jax.random.uniform(key, x.shape, jnp.float32, 0.0, 1 / 256))
         if loss_type == "gaussian" else None)
    _close(head.nll(torch.tensor(dec), torch.tensor(x),
                    None if u is None else torch.tensor(u)), nll, "nll")
    draws = []
    if loss_type == "mol":
        k1, k2 = jax.random.split(key)
        draws = [np.asarray(jax.random.uniform(k1, (B, 8, 8, 3), minval=1e-5,
                                               maxval=1 - 1e-5)),
                 np.asarray(jax.random.uniform(k2, x.shape, minval=1e-5, maxval=1 - 1e-5))]
    noise = NoiseSource(replay=draws)
    _close(head.decode(torch.tensor(dec), noise), frame, "decode")
    assert noise.exhausted()
