"""Plain PyTorch reference of SRNN, the stochastic RNN with a ConvLSTM
backbone and dense latents: frame features (four 3x3 convs, strides 2, 2,
2, 1, batch norm, relu) over all frames, a forward ConvLSTM over them and a
backward smoothing ConvLSTM, per frame a posterior over [a_t | phi_z(z_x)]
and a prior over [h_t | phi_z(z)] (each a stride-2 conv trunk and two
3-layer MLP heads), and a Bernoulli likelihood of the frame decoded from
[h_t | phi_z(z_x)] by transposed convs.

Written from the model's equations for the options the benchmark's
configurations use; any other option raises ``NotImplementedError``. The
noise comes from ``common.Draws``: ``loss`` draws, per frame, the
posterior eps then the prior eps, all before the frames run. Every batch
norm takes the statistics of the batch it is given, so ``phi_z`` is
applied to each latent on its own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (conv, deconv, lstm_scan, norm, normal_kl, per_sample_sum,
                     preprocess)

FEAT, ZMAP = 256, 128
DECODER = (("deconv", 512), ("conv", 256), ("deconv", 64), ("conv", 64), ("deconv", 32))


def _check(cfg: dict) -> None:
    wanted = dict(loss_type="bernoulli", enable_smoothing=True, res_q=False, D=0,
                  norm_type="batchnorm")
    for k, v in wanted.items():
        if cfg[k] != v:
            raise NotImplementedError(f"reference SRNN: {k}={cfg[k]!r} (only {v!r})")


def spec(cfg: dict):
    """(name, shape, std, mean, learned) of every weight: convolutions and
    dense kernels N(0, 1/fan_in) (the ConvLSTMs' gates 2/(fan_in +
    fan_out)), biases, norms, peepholes and initial states N(0 or 1, 0.02²)."""
    _check(cfg)
    s, small = [], 0.02
    hw = cfg["image_size"] // 8

    def w(name, shape, std, mean=0.0):
        s.append((name, tuple(shape), float(std), float(mean), True))

    def kconv(name, o, i, k=3, bias=True):
        w(name + ".kernel", (o, i, k, k), 1.0 / math.sqrt(i * k * k))
        if bias:
            w(name + ".bias", (o,), small)

    def dense(name, i, o):
        w(name + ".kernel", (i, o), 1.0 / math.sqrt(i))
        w(name + ".bias", (o,), small)

    def bn(name, c):
        w(name + ".scale", (c,), small, 1.0)
        w(name + ".bias", (c,), small)

    h, a, z = cfg["h_dim"], cfg["a_dim"], cfg["z_dim"]
    for n, shape in (("h_0", (1, hw, hw, h)), ("c_0", (1, hw, hw, h)),
                     ("a_0", (1, hw, hw, a)), ("ca_0", (1, hw, hw, a)),
                     ("z_0", (1, z)), ("z_0x", (1, z))):
        w(n, shape, small)
    c = cfg["x_channels"]
    for j, ch in enumerate((64, 128, 256, FEAT)):
        kconv(f"phi_x.conv{j}", ch, c)
        bn(f"phi_x.norm{j}", ch)
        c = ch
    d = ZMAP * hw * hw
    dense("phi_z.fc0", z, d)
    dense("phi_z.fc1", d, d)
    kconv("phi_z.conv", ZMAP, ZMAP)
    bn("phi_z.norm", ZMAP)
    flat = 256 * ((hw - 1) // 2 + 1) ** 2
    for net, cin in (("enc", a + ZMAP), ("prior", h + ZMAP)):
        kconv(f"{net}.trunk_conv", 256, cin)
        bn(f"{net}.trunk_norm", 256)
        for head in ("mean", "std"):
            dense(f"{net}.{head}_fc0", flat, 512)
            dense(f"{net}.{head}_fc1", 512, 256)
            dense(f"{net}.{head}_fc2", 256, z)
    c = h + ZMAP
    for j, (kind, ch) in enumerate(DECODER):
        if kind == "deconv":
            w(f"dec.deconv{j}.kernel", (c, ch, 4, 4), 1.0 / math.sqrt(c * 16))
            w(f"dec.deconv{j}.bias", (ch,), small)
        else:
            kconv(f"dec.conv{j}", ch, c)
        bn(f"dec.norm{j}", ch)
        c = ch
    w("head.variance", (1,), small, 1.0)
    kconv("head.out_conv", cfg["x_channels"], 32)
    for cell, cin, hid in (("lstm_h", FEAT, h), ("lstm_a", h + FEAT, a)):
        for n in ("Wci", "Wcf", "Wco"):
            w(f"{cell}.{n}", (1, hw, hw, hid), small)
        tot = cin + hid
        w(f"{cell}.gates.kernel", (4 * hid, tot, 3, 3), math.sqrt(2.0 / (9 * tot + 9 * 4 * hid)))
        w(f"{cell}.gates.bias", (4 * hid,), small)
    return s


def _bn(p, name, x):
    return norm(x, "batchnorm", p[name + ".scale"], p[name + ".bias"])


def phi_x(p, x):
    for j, stride in enumerate((2, 2, 2, 1)):
        x = torch.relu(_bn(p, f"phi_x.norm{j}",
                           conv(x, p[f"phi_x.conv{j}.kernel"], p[f"phi_x.conv{j}.bias"], stride)))
    return x


def phi_z(p, z, hw):
    z = torch.relu(z @ p["phi_z.fc0.kernel"] + p["phi_z.fc0.bias"])
    z = torch.relu(z @ p["phi_z.fc1.kernel"] + p["phi_z.fc1.bias"])
    z = conv(z.reshape(z.shape[0], hw, hw, ZMAP), p["phi_z.conv.kernel"], p["phi_z.conv.bias"])
    return torch.relu(_bn(p, "phi_z.norm", z))


def gaussian(p, net, x):
    h = torch.relu(_bn(p, f"{net}.trunk_norm",
                       conv(x, p[f"{net}.trunk_conv.kernel"], p[f"{net}.trunk_conv.bias"], 2)))
    h = h.reshape(h.shape[0], -1)

    def head(name):
        y = torch.relu(h @ p[f"{net}.{name}_fc0.kernel"] + p[f"{net}.{name}_fc0.bias"])
        y = torch.relu(y @ p[f"{net}.{name}_fc1.kernel"] + p[f"{net}.{name}_fc1.bias"])
        return y @ p[f"{net}.{name}_fc2.kernel"] + p[f"{net}.{name}_fc2.bias"]

    return head("mean"), F.softplus(head("std"))


def decode(p, x):
    for j, (kind, _) in enumerate(DECODER):
        k = f"dec.{kind}{j}"
        x = deconv(x, p[k + ".kernel"], p[k + ".bias"]) if kind == "deconv" else \
            conv(x, p[k + ".kernel"], p[k + ".bias"])
        x = torch.relu(_bn(p, f"dec.norm{j}", x))
    return torch.sigmoid(conv(x, p["head.out_conv.kernel"], p["head.out_conv.bias"]))


def loss(p, cfg, x, draws, remat: bool = True):
    """dict(nll, kl) over x [B, T, H, W, C] in model space: batch means of
    the summed Bernoulli NLL of frames 1..T-1 and the summed KL; each
    frame's step is recomputed in the backward (``remat``)."""
    _check(cfg)
    b, t = x.shape[:2]
    hw = cfg["image_size"] // 8
    flat = phi_x(p, x.reshape((b * t,) + x.shape[2:]))
    feats = flat.reshape((b, t) + flat.shape[1:]).transpose(0, 1)

    def init(name):
        return p[name].expand((b,) + p[name].shape[1:])

    hs, _, _ = lstm_scan(p, "lstm_h.", feats[:-1], init("h_0"), init("c_0"))
    as_, _, _ = lstm_scan(p, "lstm_a.", torch.cat([hs, feats[1:]], -1), init("a_0"),
                          init("ca_0"), reverse=True)
    z0 = init("z_0")
    x_tm = x.transpose(0, 1)
    noise = [(draws.normal(z0.shape), draws.normal(z0.shape)) for _ in range(t - 1)]

    def frame(zprev, zxprev, x_t, ht, at, eps_q, eps_p):
        em, es = gaussian(p, "enc", torch.cat([at, phi_z(p, zxprev, hw)], -1))
        pm, ps = gaussian(p, "prior", torch.cat([ht, phi_z(p, zprev, hw)], -1))
        z_tx, z_t = em + es * eps_q, pm + ps * eps_p
        prob = torch.clamp(decode(p, torch.cat([ht, phi_z(p, z_tx, hw)], -1)), 1e-6, 1 - 1e-6)
        nll = -per_sample_sum(x_t * torch.log(prob) + (1 - x_t) * torch.log1p(-prob))
        return z_t, z_tx, normal_kl(em, es, pm, ps), nll

    zprev, zxprev = z0, init("z_0x")
    kl, nll = 0.0, 0.0
    for i in range(t - 1):
        args = (zprev, zxprev, x_tm[i + 1], hs[i], as_[i], *noise[i])
        if remat and torch.is_grad_enabled():
            zprev, zxprev, kl_i, nll_i = checkpoint(frame, *args, use_reentrant=False)
        else:
            zprev, zxprev, kl_i, nll_i = frame(*args)
        kl, nll = kl + per_sample_sum(kl_i), nll + nll_i
    return dict(nll=nll.mean(), kl=kl.mean())


def train_inputs(cfg, tcfg, frames):
    """Frames [B, T, H, W, C] in [0, 1] -> the loss's input."""
    return preprocess(frames, tcfg["n_bits"], tcfg["preprocess_range"])
