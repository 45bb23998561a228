"""Weights made from the seed, on the device, in a few large calls: one
normal draw for every learned value, scaled and shifted per weight by the
std and mean the reference's ``spec`` gives it; the fixed buffers from the
reference's ``constants``. The program and the reference are both handed
this dict; neither makes weights of its own."""

from __future__ import annotations

import torch

from .seeds import derive


def make(ref, cfg: dict, seed: int, device) -> dict:
    """{name: tensor} of ``ref.spec(cfg)``."""
    spec = ref.spec(cfg)
    learned = [(n, s, std, mean) for n, s, std, mean, on in spec if on]
    sizes = [torch.Size(s).numel() for _, s, _, _ in learned]
    counts = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(torch.tensor([e[2] for e in learned], device=device), counts)
    mean = torch.repeat_interleave(torch.tensor([e[3] for e in learned], device=device), counts)
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(int(sum(sizes)), generator=g, device=device).mul_(std).add_(mean)
    out, offset = {}, 0
    for (name, shape, _, _), n in zip(learned, sizes):
        out[name] = flat[offset:offset + n].view(shape)
        offset += n
    for name, shape, _, _, on in spec:
        if not on:
            out[name] = ref.constants(name, shape, device)
    return {name: out[name] for name, *_ in spec}


def learned_names(ref, cfg: dict) -> list:
    return [n for n, _, _, _, on in ref.spec(cfg) if on]
