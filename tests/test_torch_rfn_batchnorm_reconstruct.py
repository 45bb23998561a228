"""``RFN.reconstruct`` against the JAX package on the batch-norm flow
variant (``flow_norm``/``base_norm`` 'batchnorm', ``lu_decomposed=False``,
``track_running_stats``) with ``eval_norm``: 32x32 frames, L=2, K=2, B=2,
T=4, running statistics off 0/1, the JAX draws replayed. Tolerance
1e-5·(1+|ref|), in float64 on both sides (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity_utils as U
from recurrent_flows_tpu.models import RFN as JRFN
from recurrent_flows_tpu_torch.models import RFN
from recurrent_flows_tpu_torch.utils import NoiseSource

B, T, TOL = 2, 4, 1e-5


def _frames(seed, img):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (B, T, img, img, U.CIN)).astype(np.float32)


def _close(got, ref, what=""):
    U.assert_close_rel(got, ref, TOL, what)


def _jax(jm, method, v, *args):
    """The JAX method, jitted over the variables (the rest are constants)."""
    return jax.jit(lambda v: jm.apply(v, *args, method=method))(v)


def test_batchnorm_flow_with_eval_norm_matches_jax(monkeypatch):
    """reconstruct on the batch-norm flow variant: its forward normalises
    with the batch's statistics, its reverse with the running ones, and
    the feature nets (eval_norm) with theirs. Both sides run in float64,
    as test_torch_flow_variants.py holds this variant's gradients: a
    per-position batch norm over B=2 samples is ill-conditioned in float32
    (scripts/torch_conditioning.py)."""
    from recurrent_flows_tpu_torch.flows import modules
    from recurrent_flows_tpu_torch.nn import convlstm
    from recurrent_flows_tpu_torch.ops import fused

    cfg = U.tiny_rfn_config(
        image_size=32, L=2, K=2, track_running_stats=True,
        glow={"chain_impl": "off", "flow_norm": "batchnorm", "base_norm": "batchnorm",
              "lu_decomposed": False},
        extractor_structure=((4, "pool", 8), (8, "pool", 16)),
        upscaler_structure=((16,), ("upsample", 8)))
    _, v = U.jax_rfn_variables(cfg, seed=2)
    v = {**v, "batch_stats": U.running_stats_like(v["batch_stats"], 6)}
    jm = JRFN(cfg, remat=False, eval_norm=True)
    x, key = _frames(7, 32), jax.random.key(11)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        ref = _jax(jm, "reconstruct", v64, x.astype(np.float64), key)
        assert ref[0].dtype == jnp.float64
        draws = U.rfn_reconstruct_noise(key, cfg, B, T, dtype=jnp.float64)
    monkeypatch.setattr(convlstm, "convlstm_gates", fused.convlstm_gates_ref)
    monkeypatch.setattr(modules, "coupling_transform", fused.coupling_transform_ref)
    tm = U.port_from(RFN(U.to_port(cfg), eval_norm=True), v).double()
    noise = NoiseSource(replay=draws)
    got = tm.reconstruct(torch.tensor(x, dtype=torch.float64), noise)
    assert noise.exhausted() and got[0].dtype == torch.float64
    _close(got[0], ref[0], "recons")
    _close(got[1], ref[1], "recons_flow")
