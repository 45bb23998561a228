"""Plain PyTorch reference of RFN, the recurrent flow network: the
training loss (VGG extractor over all frames, ConvLSTM scan, per frame
encoder, prior, KL, VGG upscaler and the conditional multiscale Glow's
negative log-likelihood) and the autoregressive rollout (posterior scan
over the context, then per frame extractor, ConvLSTM, prior sample,
upscaler and the Glow run in reverse).

Written from the model's equations for the options the benchmark's
configurations use; any other option raises ``NotImplementedError``. A
configuration is the dict of its file's ``model`` key. Weights are a dict
of tensors under the names ``spec`` lists. The noise comes from
``common.Draws`` in the model's order: ``loss`` draws, per frame, the
prior eps, the posterior eps and the dequantization uniform, all before
the frames run; ``predict`` draws per context step the prior then the
posterior eps, then per predicted frame the prior eps, the base eps and
one eps per split (the deepest split first).

The Glow's invertible 1x1 is W = P·L·U (unit lower L, U with the
diagonal sign_s·exp(log_s)); its inverse is taken in float64. A step is
actnorm -> 1x1 -> affine coupling whose net is 3x3 conv + actnorm, relu,
1x1 conv + actnorm, relu, 3x3 conv with gain exp(3·logs); its log-scale
is scale·tanh(raw) + scale_shift.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from .common import (act, conv, lstm_cell, lstm_scan, max_pool, norm, normal_kl,
                     normal_log_prob, per_sample_sum, preprocess, to_image, upsample)

def _check(cfg: dict) -> None:
    g = cfg["glow"]
    wanted = dict(skip_connection_flow="without_skip", skip_connection_features=True,
                  enable_smoothing=False, res_q=False, D=0, downscaler_tanh=False,
                  upscaler_tanh=False, structure_scaler=2)
    wanted_glow = dict(flow_norm="actnorm", base_norm="actnorm", coupling_norm="actnorm",
                       clamp_type="realnvp", split2d_act="softplus", learn_prior=True,
                       lu_decomposed=True, make_conditional=True, non_lin="relu")
    for d, w in ((cfg, wanted), (g, wanted_glow)):
        for k, v in w.items():
            if d[k] != v:
                raise NotImplementedError(f"reference RFN: {k}={d[k]!r} (only {v!r})")
    for block in cfg["extractor_structure"]:
        if any(not isinstance(i, int) and i != "pool" for i in block):
            raise NotImplementedError(f"reference RFN: extractor block {block}")
    for l, block in enumerate(cfg["upscaler_structure"]):
        ups = [i for i in block if not isinstance(i, int)]
        if ups != ([] if l == 0 else ["upsample"]):
            raise NotImplementedError(f"reference RFN: upscaler block {block}")


def _sizes(cfg):
    """Per extractor block: (H, channels) of its output."""
    c, h, out = cfg["x_channels"], cfg["image_size"], []
    for block in cfg["extractor_structure"]:
        for i in block:
            if i == "pool":
                h //= 2
            else:
                c = i
        out.append((h, c))
    return out


def _up_channels(cfg):
    """The upscaler's output channels per block (low resolution first)."""
    skips = [c for _, c in _sizes(cfg)][::-1]
    c, outs = cfg["h_dim"] + cfg["z_dim"], []
    for l, block in enumerate(cfg["upscaler_structure"]):
        c += skips[l]
        for i in block:
            if isinstance(i, int):
                c = i
        outs.append(c)
    return outs


def flow_shapes(cfg):
    """Per flow scale: (H, x channels, condition channels)."""
    conds = _up_channels(cfg)[::-1]
    c, hw, out = cfg["x_channels"], cfg["image_size"], []
    for l in range(cfg["L"]):
        c, hw = c * 4, hw // 2
        out.append((hw, c, conds[l]))
        if l < cfg["L"] - 1:
            c //= 2
    return out


def spec(cfg: dict):
    """(name, shape, std, mean, learned) of every weight, in a fixed order.
    Convolutions draw N(0, 1/fan_in) (the ConvLSTM's gates 2/(fan_in +
    fan_out)), the flow's normed convs N(0, 0.05²), everything the program
    would start at zero or one (zero convs and their gains, actnorms, norm
    scales and biases, peepholes, the initial states, the coupling clamp,
    the 1x1's L, U and log_s) N(0 or 1, 0.02²). The permutations P and
    signs are fixed constants."""
    _check(cfg)
    s = []

    def w(name, shape, std, mean=0.0, learned=True):
        s.append((name, tuple(shape), float(std), float(mean), learned))

    def kconv(name, o, i, k):
        w(name, (o, i, k, k), 1.0 / math.sqrt(i * k * k))

    small = 0.02
    hu = cfg["image_size"] // 2 ** cfg["L"]
    for n, d in (("h_0", "h_dim"), ("c_0", "h_dim"), ("a_0", "a_dim"), ("ca_0", "a_dim"),
                 ("z_0", "z_dim"), ("z_0x", "z_dim")):
        w(n, (1, hu, hu, cfg[d]), small)
    c = cfg["x_channels"]
    for l, block in enumerate(cfg["extractor_structure"]):
        for count, i in enumerate(block, start=1):
            if i == "pool":
                continue
            name = f"extractor.b{l}_{count}"
            kconv(name + ".kernel", i, c, 3)
            w(name + "_norm.scale", (i,), small, 1.0)
            w(name + "_norm.bias", (i,), small)
            c = i
    skips = [c for _, c in _sizes(cfg)][::-1]
    c = cfg["h_dim"] + cfg["z_dim"]
    for l, block in enumerate(cfg["upscaler_structure"]):
        c += skips[l]
        for count, ch in enumerate((i for i in block if isinstance(i, int)), start=1):
            name = f"upscaler.b{l}_{count}"
            kconv(name + ".kernel", ch, c, 3)
            w(name + "_norm.scale", (ch,), small, 1.0)
            w(name + "_norm.bias", (ch,), small)
            c = ch
    h, feat = cfg["h_dim"], _sizes(cfg)[-1][1]
    for n in ("Wci", "Wcf", "Wco"):
        w(f"lstm.{n}", (1, hu, hu, h), small)
    cin = feat + h
    w("lstm.gates.kernel", (4 * h, cin, 3, 3), math.sqrt(2.0 / (9 * cin + 9 * 4 * h)))
    w("lstm.gates.bias", (4 * h,), small)
    for net, cin in (("prior", h + cfg["z_dim"]), ("encoder", h + cfg["z_dim"] + feat)):
        c = cin
        for j, i in enumerate(cfg[f"{net}_structure"]):
            kconv(f"{net}.conv_{j}.kernel", i, c, 3)
            w(f"{net}.conv_{j}.bias", (i,), small)
            c = i
        kconv(f"{net}.param_conv.kernel", 2 * cfg["z_dim"], c, 3)
        w(f"{net}.param_conv.bias", (2 * cfg["z_dim"],), small)
    g = cfg["glow"]
    u = g["n_units_affine"]

    def normed(name, o, i, k):
        w(name + ".conv.kernel", (o, i, k, k), 0.05)
        w(name + ".actnorm.bias", (o,), small)
        w(name + ".actnorm.logs", (o,), small)

    def zeros(name, o, i):
        w(name + ".logs", (o,), small)
        w(name + ".conv.kernel", (o, i, 3, 3), small)
        w(name + ".conv.bias", (o,), small)

    shapes = flow_shapes(cfg)
    for l, (hw, c, cc) in enumerate(shapes):
        for k in range(cfg["K"]):
            p = f"flow.scale{l}_step{k}."
            w(p + "norm.bias", (c,), small)
            w(p + "norm.logs", (c,), small)
            w(p + "invconv.lower", (c, c), small)
            w(p + "invconv.log_s", (c,), small)
            w(p + "invconv.upper", (c, c), small)
            w(p + "invconv.p", (c, c), 0.0, learned=False)
            w(p + "invconv.sign_s", (c,), 0.0, learned=False)
            w(p + "affine.scale", (c // 2,), small)
            w(p + "affine.scale_shift", (c // 2,), small)
            normed(p + "affine.net0", u, c // 2 + cc, 3)
            normed(p + "affine.net1", u, u, 1)
            zeros(p + "affine.net2", c, u)
        if l < cfg["L"] - 1:
            p = f"flow.split{l}."
            normed(p + "cond0", cc, cc, 3)
            normed(p + "cond1", cc, cc, 1)
            zeros(p + "conv", c, c // 2 + cc)
    up, c_last = g["n_units_prior"], shapes[-1][1]
    normed("flow.prior0", up, h + cfg["z_dim"], 3)
    normed("flow.prior1", up // 2, up, 3)
    zeros("flow.prior_out", 2 * c_last, up // 2)
    return s


def constants(name: str, shape, device):
    """The fixed buffers: P a cyclic shift (row i has its one in column
    i+1), the signs alternating +1, -1."""
    c = shape[0]
    if name.endswith("invconv.p"):
        return torch.roll(torch.eye(c, device=device), 1, dims=1)
    if name.endswith("invconv.sign_s"):
        return torch.tensor([1.0, -1.0], device=device).repeat(c)[:c]
    raise KeyError(name)


# -- nets ------------------------------------------------------------------


def extractor(p, cfg, x):
    """Every block's output, high resolution first (a tuple)."""
    outs, blocks = [], cfg["extractor_structure"]
    kind = cfg["norm_type_features"]
    for l, block in enumerate(blocks):
        for count, i in enumerate(block, start=1):
            if i == "pool":
                x = max_pool(x)
                continue
            n = f"extractor.b{l}_{count}"
            x = norm(conv(x, p[n + ".kernel"]), kind, p[n + "_norm.scale"], p[n + "_norm.bias"])
            last = l == len(blocks) - 1 and count == len(block)
            x = torch.tanh(x) if last else act(x, "relu")
        outs.append(x)
    return tuple(outs)


def upscaler(p, cfg, x, skips):
    """Conditions of the flow's scales, high resolution first."""
    outs, kind = [], cfg["norm_type_features"]
    rev = list(skips)[::-1]
    for l, block in enumerate(cfg["upscaler_structure"]):
        if l > 0:
            x = upsample(x)
        x = torch.cat([x, rev[l]], -1)
        for count in range(1, sum(isinstance(i, int) for i in block) + 1):
            n = f"upscaler.b{l}_{count}"
            x = act(norm(conv(x, p[n + ".kernel"]), kind, p[n + "_norm.scale"],
                         p[n + "_norm.bias"]), "leakyrelu")
        outs.append(x)
    return outs[::-1]


def param_net(p, cfg, net, x):
    """The prior or the encoder: (mean, softplus std)."""
    for j, _ in enumerate(cfg[f"{net}_structure"]):
        x = act(norm(conv(x, p[f"{net}.conv_{j}.kernel"], p[f"{net}.conv_{j}.bias"]),
                     cfg["norm_type"]), "leakyrelu")
    out = conv(x, p[f"{net}.param_conv.kernel"], p[f"{net}.param_conv.bias"])
    mean, raw = torch.chunk(out, 2, -1)
    return mean, torch.nn.functional.softplus(raw)


# -- the flow ----------------------------------------------------------------


def squeeze(x):
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def unsqueeze(x):
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, c // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, 2 * h, 2 * w, c // 4)


def normed_conv(p, name, x):
    """conv (no bias) then actnorm (x + b)·exp(logs)."""
    y = conv(x, p[name + ".conv.kernel"])
    return (y + p[name + ".actnorm.bias"]) * torch.exp(p[name + ".actnorm.logs"])


def zero_conv(p, name, x):
    return (conv(x, p[name + ".conv.kernel"], p[name + ".conv.bias"])
            * torch.exp(3.0 * p[name + ".logs"]))


def invconv_matrix(p, prefix, inverse: bool):
    lower_raw, upper_raw = p[prefix + "lower"], p[prefix + "upper"]
    c = lower_raw.shape[0]
    eye = torch.eye(c, device=lower_raw.device)
    lower = torch.tril(lower_raw, -1) + eye
    upper = torch.triu(upper_raw, 1) + torch.diag(p[prefix + "sign_s"] * torch.exp(p[prefix + "log_s"]))
    w = p[prefix + "p"] @ lower @ upper
    if not inverse:
        return w
    return torch.linalg.inv(w.double()).float()


def coupling_net(p, prefix, z1, cond):
    h = torch.relu(normed_conv(p, prefix + "net0", torch.cat([z1, cond], -1)))
    h = torch.relu(normed_conv(p, prefix + "net1", h))
    out = zero_conv(p, prefix + "net2", h)
    shift, raw = out[..., 0::2], out[..., 1::2]
    return shift, p[prefix + "scale"] * torch.tanh(raw) + p[prefix + "scale_shift"]


def step_forward(p, prefix, x, cond):
    """x -> y and the step's log-determinant [B]."""
    hw = x.shape[1] * x.shape[2]
    w = invconv_matrix(p, prefix + "invconv.", False)
    x = ((x + p[prefix + "norm.bias"]) * torch.exp(p[prefix + "norm.logs"])) @ w.T
    ld = (p[prefix + "norm.logs"].sum() + p[prefix + "invconv.log_s"].sum()) * hw
    c = x.shape[-1]
    z1, z2 = x[..., : c // 2], x[..., c // 2:]
    shift, s = coupling_net(p, prefix + "affine.", z1, cond)
    z2 = (z2 + shift) * torch.exp(s)
    return torch.cat([z1, z2], -1), ld + per_sample_sum(s)


def step_reverse(p, prefix, y, cond, w_inv):
    c = y.shape[-1]
    z1, z2 = y[..., : c // 2], y[..., c // 2:]
    shift, s = coupling_net(p, prefix + "affine.", z1, cond)
    x = torch.cat([z1, z2 * torch.exp(-s) - shift], -1)
    return (x @ w_inv.T) * torch.exp(-p[prefix + "norm.logs"]) - p[prefix + "norm.bias"]


def split_prior(p, prefix, z1, cond):
    cond = torch.relu(normed_conv(p, prefix + "cond0", cond))
    cond = torch.relu(normed_conv(p, prefix + "cond1", cond))
    out = zero_conv(p, prefix + "conv", torch.cat([z1, cond], -1))
    return out[..., 0::2], torch.nn.functional.softplus(out[..., 1::2]) + 1e-8


def base_prior(p, base):
    h = torch.relu(normed_conv(p, "flow.prior0", base))
    h = torch.relu(normed_conv(p, "flow.prior1", h))
    out = zero_conv(p, "flow.prior_out", h)
    c = out.shape[-1] // 2
    return out[..., :c], out[..., c:]


def _call(fn, *args):
    return fn(*args)


def _recompute(fn, *args):
    """fn(*args), its activations recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False)


def flow_nll(p, cfg, x, conds, base, run=_call):
    """-log p(x | conditions) [B] of dequantized x, with the 8-bit
    correction -log(2^n_bits) per dimension; ``run`` calls each GlowStep."""
    n_bins = 2.0 ** cfg["glow"]["n_bits"]
    dims = x.shape[1] * x.shape[2] * x.shape[3]
    obj = torch.full((x.shape[0],), -math.log(n_bins) * dims, device=x.device)
    z = x
    for l in range(cfg["L"]):
        z = squeeze(z)
        for k in range(cfg["K"]):
            z, ld = run(functools.partial(step_forward, p, f"flow.scale{l}_step{k}."), z, conds[l])
            obj = obj + ld
        if l < cfg["L"] - 1:
            c = z.shape[-1]
            z1, z2 = z[..., : c // 2], z[..., c // 2:]
            mean, sigma = split_prior(p, f"flow.split{l}.", z1, conds[l])
            obj = obj + per_sample_sum(normal_log_prob(z2, mean, sigma))
            z = z1
    mean, log_scale = base_prior(p, base)
    return -(obj + per_sample_sum(normal_log_prob(z, mean, torch.exp(log_scale))))


def flow_sample(p, cfg, conds, base, draws, temperature: float, w_invs):
    mean, log_scale = base_prior(p, base)
    x = mean + torch.exp(log_scale) * temperature * draws.normal(mean.shape)
    for l in reversed(range(cfg["L"])):
        if l < cfg["L"] - 1:
            mean, sigma = split_prior(p, f"flow.split{l}.", x, conds[l])
            x = torch.cat([x, mean + sigma * temperature * draws.normal(mean.shape)], -1)
        for k in reversed(range(cfg["K"])):
            x = step_reverse(p, f"flow.scale{l}_step{k}.", x, conds[l], w_invs[l][k])
        x = unsqueeze(x)
    return x


# -- the model ---------------------------------------------------------------


def _inits(p, name, b):
    return p[name].expand((b,) + p[name].shape[1:])


def loss(p, cfg, x, draws, remat: bool = True):
    """dict(nll, kl) over x [B, T, H, W, C] in model space: batch means of
    the summed per-frame NLL of frames 1..T-1 and the summed KL. With
    ``remat`` the extractor and each GlowStep keep no activations and are
    recomputed in the backward, so that the largest batches fit."""
    _check(cfg)
    run = _recompute if remat and torch.is_grad_enabled() else _call
    b, t = x.shape[:2]
    maps = run(functools.partial(extractor, p, cfg), x.reshape((b * t,) + x.shape[2:]))
    feats = [f.reshape((b, t) + f.shape[1:]).transpose(0, 1) for f in maps]
    f_last = feats[-1]
    hs, _, _ = lstm_scan(p, "lstm.", f_last[:-1], _inits(p, "h_0", b), _inits(p, "c_0", b))
    z0 = _inits(p, "z_0", b)
    x_tm = x.transpose(0, 1)
    n_bins = 2.0 ** cfg["glow"]["n_bits"]
    noise = [(draws.normal(z0.shape), draws.normal(z0.shape),
              draws.uniform(x_tm[0].shape, 0.0, 1.0 / n_bins)) for _ in range(t - 1)]

    def frame(zprev, zxprev, x_t, ht, feat_t, eps_p, eps_q, u, *skips):
        em, es = param_net(p, cfg, "encoder", torch.cat([ht, zxprev, feat_t], -1))
        pm, ps = param_net(p, cfg, "prior", torch.cat([ht, zprev], -1))
        zt, zxt = pm + ps * eps_p, em + es * eps_q
        hz = torch.cat([ht, zxt], -1)
        conds = upscaler(p, cfg, hz, list(skips))
        return zt, zxt, normal_kl(em, es, pm, ps), flow_nll(p, cfg, x_t + u, conds, hz, run)

    zprev, zxprev = z0, _inits(p, "z_0x", b)
    kl, nll = 0.0, 0.0
    for i in range(t - 1):
        zprev, zxprev, kl_i, nll_i = frame(zprev, zxprev, x_tm[i + 1], hs[i], f_last[i + 1],
                                           *noise[i], *[f[i] for f in feats])
        kl, nll = kl + per_sample_sum(kl_i), nll + nll_i
    return dict(nll=nll.mean(), kl=kl.mean())


@torch.no_grad()
def predict(p, cfg, tcfg, context, n_conditions: int, n_predictions: int, draws,
            temperature: float | None = None):
    """context [B, >=n_conditions, H, W, C] in [0, 1] -> predicted frames
    [B, n_predictions, H, W, C] in [0, 1]."""
    _check(cfg)
    temperature = cfg["temperature"] if temperature is None else temperature
    x = preprocess(context[:, :n_conditions], tcfg["n_bits"], tcfg["preprocess_range"])
    b = x.shape[0]
    feats = [f.reshape((b, n_conditions) + f.shape[1:]).transpose(0, 1)
             for f in extractor(p, cfg, x.reshape((-1,) + x.shape[2:]))]
    f_last = feats[-1]
    hs, h, c = lstm_scan(p, "lstm.", f_last[:-1], _inits(p, "h_0", b), _inits(p, "c_0", b))
    zprev, zxprev = _inits(p, "z_0", b), _inits(p, "z_0x", b)
    for i in range(n_conditions - 1):
        em, es = param_net(p, cfg, "encoder", torch.cat([hs[i], zxprev, f_last[i + 1]], -1))
        pm, ps = param_net(p, cfg, "prior", torch.cat([hs[i], zprev], -1))
        zprev = pm + ps * draws.normal(pm.shape)
        zxprev = em + es * draws.normal(em.shape)
    w_invs = [[invconv_matrix(p, f"flow.scale{l}_step{k}.invconv.", True)
               for k in range(cfg["K"])] for l in range(cfg["L"])]
    frame, frames = x[:, n_conditions - 1], []
    for _ in range(n_predictions):
        skips = extractor(p, cfg, frame)
        h, c = lstm_cell(p, "lstm.", skips[-1], h, c)
        pm, ps = param_net(p, cfg, "prior", torch.cat([h, zprev], -1))
        zprev = pm + ps * draws.normal(pm.shape)
        hz = torch.cat([h, zprev], -1)
        frame = flow_sample(p, cfg, upscaler(p, cfg, hz, skips), hz, draws, temperature, w_invs)
        frames.append(frame)
    return to_image(torch.stack(frames, 1), tcfg["preprocess_range"])


def train_inputs(cfg, tcfg, frames):
    """Frames [B, T, H, W, C] in [0, 1] -> the loss's input."""
    return preprocess(frames, tcfg["n_bits"], tcfg["preprocess_range"])
