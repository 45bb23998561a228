"""The port's metrics and embedders against the JAX package, on the CPU:
``mse``/``psnr``/``ssim``/``eval_seq`` (and SSIM against the committed
goldens of ``test_ssim_golden.py``), the SAME padding of the proxies' and
I3D's convs and pools against ``lax``, the LPIPS proxy, ``lpips_alex`` on
``random_params(0)``, ``random3d``, the Fréchet distance and ``fvd``, I3D
against the committed fingerprint of ``test_embedders.py`` (the JAX I3D is
not run: it is ``slow`` there), the loaders' validation, and the proxies'
weight file against JAX's draws, bit for bit.

Inputs are numpy arrays made from a seed. Tolerances: every element
within 1e-5·(1+|ref|) in float32 (metrics, features, distances); the SAME
padding exactly, on small integers; the I3D fingerprint at the rtol 2e-3
it is committed with.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parity_utils as U
from torch_parity_utils import _two_torch_threads  # noqa: F401 (autouse fixture)
from recurrent_flows_tpu.evaluation import alexnet_lpips as j_alex
from recurrent_flows_tpu.evaluation import i3d as j_i3d
from recurrent_flows_tpu.evaluation import lpips as j_lpips
from recurrent_flows_tpu.evaluation import metrics as j_metrics
from recurrent_flows_tpu_torch.evaluation import alexnet_lpips, i3d, metrics
from recurrent_flows_tpu_torch.evaluation import lpips as t_lpips
from recurrent_flows_tpu_torch.evaluation import _proxy
from recurrent_flows_tpu_torch.utils import pad_same

# the modules, not the functions the packages export under the same name
j_fvd = importlib.import_module("recurrent_flows_tpu.evaluation.fvd")
t_fvd = importlib.import_module("recurrent_flows_tpu_torch.evaluation.fvd")

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, ref, what=""):
    U.assert_close_rel(got.numpy() if isinstance(got, torch.Tensor) else got,
                       np.asarray(ref), TOL, what)


@pytest.mark.parametrize("channels", [1, 3])
def test_metrics_match_jax(channels):
    rng = np.random.RandomState(0)
    true = rng.rand(2, 3, 20, 18, channels).astype(np.float32)
    pred = np.clip(true + 0.2 * rng.randn(*true.shape), 0, 1).astype(np.float32)
    ref = j_metrics.eval_seq(jnp.asarray(true), jnp.asarray(pred))
    got = metrics.eval_seq(torch.tensor(true), torch.tensor(pred))
    assert set(got) == set(ref) == {"ssim", "psnr", "mse"}
    for k in ref:
        assert got[k].shape == (2, 3), k
        _close(got[k], ref[k], k)
    a, b = true[:, 0, ..., 0], pred[:, 0, ..., 0]
    for name in ("mse", "psnr", "ssim"):
        _close(getattr(metrics, name)(torch.tensor(a), torch.tensor(b)),
               getattr(j_metrics, name)(jnp.asarray(a), jnp.asarray(b)), name)
    _close(metrics.psnr(torch.tensor(a), torch.tensor(a)),
           j_metrics.psnr(jnp.asarray(a), jnp.asarray(a)), "psnr of equal images")


def test_ssim_matches_the_committed_goldens():
    from test_ssim_golden import _fixed_images

    a, b = _fixed_images()  # RandomState(1234), 3 images of 24x24
    golden = np.array([0.90751701, 0.89572224, 0.88675830])
    _close(metrics.ssim(torch.tensor(a), torch.tensor(b), data_range=1.0), golden)


SAME_CASES = [(n, k, s) for n in (7, 8, 16, 17) for k, s in ((3, 2), (7, 2), (3, 1), (2, 2))]


def _exact(got, ref, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=what)


@pytest.mark.parametrize("n,k,s", SAME_CASES)
def test_same_padding_matches_lax(n, k, s):
    """Conv and max-pool with TF's SAME padding (the extra element at the
    end) at odd and even sizes, 2-D and 3-D, against ``lax``. Small integer
    inputs make every sum exact in float32, so the geometry is held
    exactly."""
    rng = np.random.RandomState(n * 100 + k * 10 + s)
    ints = lambda *shape: rng.randint(-3, 4, shape).astype(np.float32)
    x = ints(2, n, n + 1, 3)
    w = ints(k, k, 3, 4)
    ref = jax.lax.conv_general_dilated(x, w, (s, s), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    got = F.conv2d(pad_same(xt, (k, k), (s, s)), torch.tensor(w).permute(3, 2, 0, 1),
                   stride=s)
    _exact(got.permute(0, 2, 3, 1), ref, "conv2d")
    ref = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, k, k, 1), (1, s, s, 1), "SAME")
    got = F.max_pool2d(pad_same(xt, (k, k), (s, s), value=float("-inf")), k, s)
    _exact(got.permute(0, 2, 3, 1), ref, "max_pool2d")
    v = ints(1, n, 5, n, 2)
    w3 = ints(k, 3, k, 2, 3)
    strides = (s, 1, s)
    ref = jax.lax.conv_general_dilated(v, w3, strides, "SAME",
                                       dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    vt = torch.tensor(v).permute(0, 4, 1, 2, 3)
    got = F.conv3d(pad_same(vt, (k, 3, k), strides), torch.tensor(w3).permute(4, 3, 0, 1, 2),
                   stride=strides)
    _exact(got.permute(0, 2, 3, 4, 1), ref, "conv3d")
    ref = jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, (1, k, 3, k, 1), (1, *strides, 1),
                                "SAME")
    got = F.max_pool3d(pad_same(vt, (k, 3, k), strides, value=float("-inf")), (k, 3, k),
                       strides)
    _exact(got.permute(0, 2, 3, 4, 1), ref, "max_pool3d")


@pytest.mark.parametrize("shape", [(3, 64, 64, 1), (2, 17, 24, 3)])
def test_lpips_proxy_matches_jax(shape, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # no ./data/lpips_alex.npz: the proxy
    rng = np.random.RandomState(sum(shape))
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*shape), -1, 1).astype(np.float32)
    ref = j_lpips.lpips_distance(a, b, backend="random_features")
    got = t_lpips.lpips_distance(torch.tensor(a), torch.tensor(b))  # 'auto': no lpips package
    assert got.shape == (shape[0],)
    _close(got, ref)
    assert float(t_lpips.lpips_distance(torch.tensor(a), torch.tensor(a)).max()) < 1e-6


def test_lpips_alex_matches_jax_at_64x64(tmp_path):
    params = alexnet_lpips.random_params(0)
    ref_params = j_alex.random_params(0)
    assert params.keys() == ref_params.keys()
    for k in params:  # numpy's RandomState on both sides
        np.testing.assert_array_equal(params[k], ref_params[k], err_msg=k)
    rng = np.random.RandomState(1)
    a = rng.uniform(-1, 1, (3, 64, 64, 1)).astype(np.float32)
    b = rng.uniform(-1, 1, (3, 64, 64, 1)).astype(np.float32)
    ref = j_alex.lpips_alex(ref_params, a, b)
    _close(alexnet_lpips.lpips_alex(params, torch.tensor(a), torch.tensor(b)), ref)
    path = str(tmp_path / "alex.npz")
    np.savez(path, **params)
    got = t_lpips.lpips_distance(torch.tensor(a), torch.tensor(b), backend="alex", weights=path)
    _close(got, ref)
    same = t_lpips.lpips_distance(torch.tensor(a), torch.tensor(a), backend="alex", weights=path)
    assert float(same.abs().max()) < 1e-6


def test_random3d_frechet_and_fvd_match_jax(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # no ./data/i3d_kinetics400.npz: 'auto' is random3d
    rng = np.random.RandomState(2)
    real = rng.uniform(0, 1, (7, 5, 16, 16, 1)).astype(np.float32)
    fake = np.clip(real + 0.1 * rng.randn(*real.shape), 0, 1).astype(np.float32)
    ref_feats = j_fvd._random3d_embed(jnp.asarray(real))
    feats = t_fvd._random3d_embed(torch.tensor(real))
    _close(feats, ref_feats, "features")
    rgb = rng.uniform(0, 1, (2, 3, 9, 8, 3)).astype(np.float32)
    _close(t_fvd._random3d_embed(torch.tensor(rgb)), j_fvd._random3d_embed(jnp.asarray(rgb)),
           "RGB features")
    f1, f2 = rng.randn(40, 6), rng.randn(40, 6) + 1.0
    s = [(f.mean(0), np.cov(f, rowvar=False)) for f in (f1, f2)]
    assert t_fvd.frechet_distance(*s[0], *s[1]) == j_fvd.frechet_distance(*s[0], *s[1])
    ref = j_fvd.fvd(real, fake, embedder="auto", batch=3)
    got = t_fvd.fvd(torch.tensor(real), torch.tensor(fake), embedder="auto", batch=3)
    assert got["embedder"] == ref["embedder"] == "random3d"
    _close(np.float64(got["fvd"]), ref["fvd"], "fvd")
    with pytest.raises(FileNotFoundError, match="I3D weights"):
        t_fvd.fvd(torch.tensor(real), torch.tensor(fake), embedder="i3d")


def test_i3d_resize_matches_jax_on_an_upscale():
    """64 -> 224 (and an odd 13 -> 224): half-pixel bilinear, as
    ``jax.image.resize``; nothing the port runs shrinks a video."""
    rng = np.random.RandomState(3)
    for shape in ((1, 2, 64, 64, 1), (2, 1, 13, 13, 3)):
        v = rng.rand(*shape).astype(np.float32)
        ref = j_i3d.preprocess_videos(jnp.asarray(v))
        got = i3d.preprocess_videos(torch.tensor(v))
        assert got.shape == ref.shape == shape[:2] + (224, 224, 3)
        _close(got, ref, str(shape))


def test_i3d_embed_matches_the_committed_fingerprint():
    """The fingerprint ``test_embedders.py`` pins for the JAX I3D (computed
    once on the CPU in float32), on its input: 2 videos of 16 frames of
    32x32, a linear ramp, ``random_params(0)``."""
    params = i3d.random_params(0)
    ref_params = j_i3d.random_params(0)
    for k in ref_params:
        np.testing.assert_array_equal(params[k], ref_params[k], err_msg=k)
    video = np.linspace(0, 1, 2 * 16 * 32 * 32, dtype=np.float32).reshape(2, 16, 32, 32, 1)
    emb = i3d.i3d_embed(torch.tensor(video), params)
    assert emb.shape == (2, 400) and torch.isfinite(emb).all()
    np.testing.assert_allclose(emb[0, :3].numpy(), [-1.686097, -1.061059, 0.946077],
                               rtol=2e-3)


def test_loaders_validate_as_jax(tmp_path):
    for mod, key, shape_key in (
            (i3d, "RGB/inception_i3d/Conv3d_1a_7x7/conv_3d/w",
             "RGB/inception_i3d/Conv3d_2b_1x1/conv_3d/w"),
            (alexnet_lpips, "lin3/w", "conv2/w")):
        jmod = j_i3d if mod is i3d else j_alex
        assert mod.expected_keys() == jmod.expected_keys()
        params = mod.random_params(1)
        path = str(tmp_path / "ok.npz")
        np.savez(path, **params)
        assert set(mod.load_params(path)) == set(mod.expected_keys())
        bad = dict(params)
        bad.pop(key)
        np.savez(str(tmp_path / "bad.npz"), **bad)
        with pytest.raises(ValueError, match="missing"):
            mod.load_params(str(tmp_path / "bad.npz"))
        bad = dict(params)
        bad[shape_key] = np.zeros((3, 3, 3, 64, 64) if mod is i3d else (3, 3, 64, 7),
                                  np.float32)
        np.savez(str(tmp_path / "bad2.npz"), **bad)
        with pytest.raises(ValueError, match="shape"):
            mod.load_params(str(tmp_path / "bad2.npz"))
    assert i3d._shape_table() == j_i3d._shape_table()


def test_alex_backend_without_weights_raises(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RFT_LPIPS_WEIGHTS", raising=False)
    a = torch.zeros(1, 32, 32, 1)
    with pytest.raises(FileNotFoundError):
        t_lpips.lpips_distance(a, a, backend="alex")


def test_proxy_weights_are_the_jax_draws_bit_for_bit():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        export = importlib.import_module("export_proxy_embedder_weights")
    finally:
        sys.path.pop(0)
    want = export.proxy_arrays()
    with np.load(_proxy.PATH) as got:
        assert sorted(got.files) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype == np.float32, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    sizes = {p: sum(w.size for k, w in want.items() if k.startswith(p))
             for p in ("lpips/", "random3d/")}
    assert sizes == {"lpips/": 387936, "random3d/": 86800}
