"""The traffic pool and the yardstick's arithmetic, on synthetic inputs."""

from __future__ import annotations

import math
import types

import pytest
import torch

from benchmark import harness, traffic, yardstick
from benchmark.seeds import derive


def test_pool_same_for_a_seed_and_differs_across_seeds():
    t = dict(batch=3, frames=4, pool=2)
    cfg = dict(image_size=64, x_channels=1)
    big = 2 ** 31 + 977
    a = traffic.pool(t, cfg, derive(big, "traffic"), "cpu")
    b = traffic.pool(t, cfg, derive(big, "traffic"), "cpu")
    c = traffic.pool(t, cfg, derive(big + 1, "traffic"), "cpu")
    assert len(a) == 2 and a[0].shape == (3, 4, 64, 64, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert not torch.equal(a[0], a[1])
    assert 0.0 <= float(a[0].min()) and float(a[0].max()) <= 1.0
    # one square a quarter of the frame wide in every frame
    bright = (a[0] >= 0.5).sum((2, 3, 4))
    assert torch.all(bright == 16 * 16)


def test_derived_seeds_are_stable_and_distinct():
    assert derive(5, "a") == derive(5, "a")
    assert len({derive(s, t) for s in (0, 1, 2 ** 33) for t in ("a", "b")}) == 6
    assert 0 <= derive(2 ** 40, "x") < 2 ** 63


def test_union_and_idle_share():
    spans = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c"), (32, 35, "d")]
    assert yardstick.union_s(spans) == pytest.approx(30e-9)
    # untraced, each of 4 units took 40 ns: the traced 2 units kept the
    # device busy 30 ns, 15 a unit, so it idled 25 of every 40
    window = types.SimpleNamespace(attempted=4, seconds=160e-9)
    r = yardstick.Reading(device_ops=spans, host_ops=[(0, 1, "aten::x"), (21, 22, "aten::y")],
                          launches=4, wall_s=60e-9, units=2, peak_bytes=0, window=window,
                          cell=None)
    assert r.busy_s() == pytest.approx(30e-9)
    idle = harness.load_file("metrics", "idle_share.train").read(r)
    assert idle == pytest.approx(100.0 * 25 / 40)
    gaps = yardstick.idle_gaps(spans, r.host_ops)
    assert gaps == [["aten::y", pytest.approx(10e-9)]]
    assert r.breakdown()["device_ops"][0][0] == "b"


def test_kernel_kinds():
    assert yardstick.kernel_kind("void glowchain_kernel<8>(...)") == "glowchain"
    assert yardstick.kernel_kind("sm90_xmma_fprop_implicit_gemm_f32f32") == "conv"
    assert yardstick.kernel_kind("ampere_sgemm_128x64_nn") == "gemm"
    assert yardstick.kernel_kind("vectorized_elementwise_kernel") == "other"


def test_bound_and_flops():
    assert yardstick.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)
    # one GlowStep: 1x1 (c·c), 3x3 over c/2 + cc to u, 1x1 u·u, 3x3 u to c
    b, h, w, c, cc, u = 2, 4, 4, 8, 16, 32
    direct = 2 * b * h * w * (c * c + 9 * (c // 2 + cc) * u + u * u + 9 * u * c)
    assert yardstick.glowstep_flops(b, h, w, c, cc, u) == direct
    assert yardstick.glowchain_bytes(b, h, w, c, cc, u, 1) > 4 * 2 * b * h * w * c


def test_mfu():
    window = types.SimpleNamespace(attempted=4, seconds=2.0)
    assert yardstick.mfu(window, 67e12 / 2) == pytest.approx(100.0)
    assert yardstick.mfu(window, None) is None
    assert not math.isnan(yardstick.mfu(window, 1.0))
