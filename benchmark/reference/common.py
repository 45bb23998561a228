"""Plain PyTorch pieces the references share: NHWC convolutions, batch
norm, the Gaussian terms, the noise draws and Adam.

Nothing here imports the program: every function is written from the
mathematics it names. Tensors are NHWC (channels last), conv kernels OIHW,
dense kernels [in, out], as the weight files of ``benchmark/weights.py``
lay them out.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions with TF32 off (the configurations'
    precision), or on (the control one step below it); the caller's
    settings are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def conv(x, kernel, bias=None, stride: int = 1, padding: int | None = None):
    """k x k convolution of NHWC x with an OIHW kernel, (k-1)//2 zeros a side."""
    k = kernel.shape[-1]
    p = (k - 1) // 2 if padding is None else padding
    return F.conv2d(x.permute(0, 3, 1, 2), kernel, bias, stride, p).permute(0, 2, 3, 1)


def deconv(x, kernel, bias):
    """Transposed convolution k4 s2 ('SAME': 2n out of n), kernel [I, O, 4, 4]."""
    return F.conv_transpose2d(x.permute(0, 3, 1, 2), kernel, bias, 2, 1).permute(0, 2, 3, 1)


def max_pool(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def upsample(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def act(x, kind: str):
    if kind == "relu":
        return torch.relu(x)
    if kind == "leakyrelu":
        return F.leaky_relu(x, 0.2)
    raise NotImplementedError(kind)


def norm(x, kind: str, scale=None, bias=None):
    """'batchnorm' over every axis but the channels, with the batch's own
    mean and biased variance; 'none' passes x through."""
    if kind == "none":
        return x
    if kind != "batchnorm":
        raise NotImplementedError(kind)
    mean = x.mean((0, 1, 2), keepdim=True)
    var = (x - mean).square().mean((0, 1, 2), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias


def per_sample_sum(x):
    return x.reshape(x.shape[0], -1).sum(-1)


def normal_log_prob(x, mean, std):
    return -0.5 * ((x - mean) / std).square() - torch.log(std) - LOG_SQRT_2PI


def normal_kl(mq, sq, mp, sp):
    ratio = (sq / sp).square()
    return 0.5 * (ratio + ((mq - mp) / sp).square() - 1.0 - torch.log(ratio))


def lstm_cell(p, prefix, x, h, c):
    """Peephole ConvLSTM step: one 3x3 conv over [x | h] gives the gates in
    the order (i, f, o, g); the peepholes read c (i, f) and the new c (o)."""
    gates = conv(torch.cat([x, h], -1), p[prefix + "gates.kernel"], p[prefix + "gates.bias"])
    gi, gf, go, gg = torch.chunk(gates, 4, -1)
    i = torch.sigmoid(gi + p[prefix + "Wci"] * c)
    f = torch.sigmoid(gf + p[prefix + "Wcf"] * c)
    c_new = f * c + i * torch.tanh(gg)
    o = torch.sigmoid(go + p[prefix + "Wco"] * c_new)
    return o * torch.tanh(c_new), c_new


def lstm_scan(p, prefix, xs, h, c, reverse: bool = False):
    """The cell over time-major xs; the states come back in time order."""
    hs = [None] * xs.shape[0]
    order = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    for t in order:
        h, c = lstm_cell(p, prefix, xs[t], h, c)
        hs[t] = h
    return torch.stack(hs), h, c


class Draws:
    """The run's noise: standard normals and uniforms taken in call order
    from one ``torch.Generator``, as the benchmark hands the program a
    generator seeded alike. A uniform on [low, high) is low + (high-low)·u."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def uniform(self, shape, low: float, high: float):
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return low + (high - low) * u


class Adam:
    """Adam with torch's defaults (betas 0.9 and 0.999, eps 1e-8, no
    weight decay), over a dict of leaves."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, g in grads.items():
            if g is None:
                continue
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            self.params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def preprocess(x, n_bits: int, rng_range: str):
    """Frames in [0, 1] to the model's space: 8-bit (or n-bit) levels over
    2^n_bits bins, less 0.5 for the '0.5' range."""
    x = x * 255.0
    if n_bits < 8:
        x = torch.floor(x / 2 ** (8 - n_bits))
    x = x / 2.0 ** n_bits
    if rng_range == "0.5":
        return x - 0.5
    if rng_range == "1.0":
        return x
    raise NotImplementedError(rng_range)


def to_image(x, rng_range: str):
    if rng_range == "0.5":
        x = x + 0.5
    elif rng_range != "1.0":
        raise NotImplementedError(rng_range)
    return torch.clamp(x, 0.0, 1.0)


def train_steps(loss_fn, params: dict, batches, beta: float, lr: float, draws: Draws,
                clip: float = 0.0):
    """Steps of loss = nll + beta·kl and Adam, one per batch: the losses,
    each step's gradient norm per leaf (after any clip, as Adam gets it),
    and the norm of each leaf's change over all the steps."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    opt = Adam(leaves, lr)
    losses, grad_norms = [], []
    for x in batches:
        out = loss_fn(leaves, x, draws)
        loss = out["nll"] + beta * out["kl"]
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = dict(zip(leaves, grads))
        if clip > 0:
            total = torch.sqrt(sum(g.square().sum() for g in grads.values() if g is not None))
            scale = torch.where(total < clip, torch.ones_like(total), clip / total)
            grads = {k: None if g is None else g * scale for k, g in grads.items()}
        losses.append(float(loss.detach()))
        grad_norms.append({k: 0.0 if g is None else float(g.norm()) for k, g in grads.items()})
        opt.step(grads)
    change = {k: float((leaves[k].detach() - start[k]).norm()) for k in leaves}
    return losses, grad_norms, change
