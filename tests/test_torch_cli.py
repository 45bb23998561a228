"""The port's training CLIs against the JAX package's (CPU).

- every option of ``recurrent_flows_tpu.cli.main_{rfn,srnn,vrnn,svg}`` is in
  the port's parser with the same dest, default, choices and nargs;
  ``--device`` is the only addition;
- ``config_from_args`` and ``train_config_from_args`` equal the JAX CLIs'
  field for field, at the defaults and on a few argvs;
- tiny end-to-end runs with ``--device cpu``, sized as ``test_cli.py``:
  ``last`` written with the ``data_source`` line, ``--load_model`` and
  ``--auto_resume`` go on from it, ``--use_validation_set`` repeats its
  pool, the generated shapes train, and the port's eval CLI scores the run.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_parity_utils import _two_torch_threads  # noqa: F401  (two torch threads)
from recurrent_flows_tpu.cli import common as jax_common
from recurrent_flows_tpu.cli import main_rfn as jax_rfn
from recurrent_flows_tpu.cli import main_srnn as jax_srnn
from recurrent_flows_tpu.cli import main_svg as jax_svg
from recurrent_flows_tpu.cli import main_vrnn as jax_vrnn
from recurrent_flows_tpu_torch.cli import common, eval_settings, main_rfn, main_srnn, main_svg
from recurrent_flows_tpu_torch.cli import main_vrnn
from recurrent_flows_tpu_torch.data import MovingMNIST

PAIRS = {"rfn": (jax_rfn, main_rfn), "srnn": (jax_srnn, main_srnn),
         "vrnn": (jax_vrnn, main_vrnn), "svg": (jax_svg, main_svg)}


def _options(parser) -> dict:
    return {a.option_strings[0]: a for a in parser._actions if a.option_strings
            and a.dest != "help"}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_parser_has_the_jax_options(name):
    jax_mod, port_mod = PAIRS[name]
    jp, pp = jax_mod.build_parser(), port_mod.build_parser()
    j, p = _options(jp), _options(pp)
    assert set(p) - set(j) == {"--device"} and set(j) <= set(p)
    for opt, a in j.items():
        b = p[opt]
        assert (b.dest, b.choices, b.nargs, b.option_strings) == (
            a.dest, a.choices, a.nargs, a.option_strings), opt
        assert pp.get_default(b.dest) == jp.get_default(a.dest), opt
    assert pp.get_default("device") == "cuda"


ARGVS = {
    "rfn": [[], ["--choose_data", "bair"], ["--multigpu", "--no-skip_connection_features",
                                             "--no-LU_decomposed", "--no-learn_prior"],
            ["--L", "2", "--extractor_structure", "4-pool-8", "8-8-pool-16",
             "--upscaler_structure", "16", "upsample-8", "--prior_structure", "4", "conv",
             "--skip_connection_flow", "only_skip", "--flow_norm", "batchnorm",
             "--temperature", "0.5", "--factor_lr", "0.5", "--use_validation_set"]],
    "srnn": [[], ["--choose_data", "bair", "--loss_type", "mol", "--num_shots", "2"],
             ["--no-enable_smoothing", "--no-dequantize", "--multigpu",
              "--norm_type_model", "none"]],
    "vrnn": [[], ["--choose_data", "bair"], ["--no-dequantize", "--loss_type", "gaussian",
                                             "--grad_clip", "1.5"]],
    "svg": [[], ["--choose_data", "bair", "--predictor_rnn_layers", "3"],
            ["--learning_rate", "0.01", "--preprocess_range", "0.5", "--norm_type_model",
             "instancenorm"]],
}


@pytest.mark.parametrize("name,i", [(n, i) for n in sorted(ARGVS) for i in range(len(ARGVS[n]))])
def test_configs_equal_the_jax_cli(name, i):
    jax_mod, port_mod = PAIRS[name]
    argv = ARGVS[name][i]
    ja, pa = jax_mod.build_parser().parse_args(argv), port_mod.build_parser().parse_args(argv)
    assert vars(ja) == {k: v for k, v in vars(pa).items() if k != "device"}
    assert (dataclasses.asdict(port_mod.config_from_args(pa))
            == dataclasses.asdict(jax_mod.config_from_args(ja)))
    assert (dataclasses.asdict(common.train_config_from_args(pa))
            == dataclasses.asdict(jax_common.train_config_from_args(ja)))


TINY_COMMON = ["--choose_data", "mnist", "--image_size", "16", "--digit_size", "8",
               "--num_digits", "1", "--batch_size", "2", "--n_frames", "3", "--n_epochs", "1",
               "--steps_per_epoch", "2", "--n_conditions", "2", "--n_predictions", "2",
               "--no-verbose", "--device", "cpu"]
TINY_RFN = TINY_COMMON + [
    "--h_dim", "8", "--z_dim", "2", "--a_dim", "4", "--L", "2", "--K", "2",
    "--extractor_structure", "4-pool-8", "8-pool-8", "--upscaler_structure", "8", "upsample-4",
    "--prior_structure", "4", "--encoder_structure", "4", "--n_units_affine", "8",
    "--n_units_prior", "8"]


def _status(path):
    return (path / "model_folder" / "status.txt").read_text().splitlines()


def test_main_rfn_resume_and_eval(tmp_path):
    path = tmp_path / "rfn"
    tr = main_rfn.main(TINY_RFN + ["--path", str(path)])
    assert tr.counter == 2 and np.isfinite(tr.losses).all()
    meta = json.loads((path / "model_folder" / "last" / "meta.json").read_text())
    assert meta["model_class"] == "RFN" and meta["counter"] == 2
    assert _status(path)[0] == "data_source moving_mnist bank=synthetic"
    # --load_model and --auto_resume go on from 'last'
    tr2 = main_rfn.main(TINY_RFN + ["--path", str(path), "--load_model"])
    assert (tr2.counter, tr2.epoch_i, len(tr2.losses)) == (4, 2, 4)
    assert tr2.losses[:2] == tr.losses
    tr3 = main_rfn.main(TINY_RFN + ["--path", str(path), "--auto_resume"])
    assert (tr3.counter, tr3.epoch_i) == (6, 3)
    fresh = main_rfn.main(TINY_RFN + ["--path", str(tmp_path / "other"), "--auto_resume"])
    assert fresh.counter == 2  # nothing to resume from
    res = eval_settings.main([
        "--path", str(path), "--n_conditions", "2", "--n_predictions", "2", "--resamples", "2",
        "--n_batches", "1", "--batch_size", "2", "--fvd_embedder", "random3d",
        "--no-debug_plot", "--device", "cpu"])
    assert np.isfinite(res["dataset_bpd"]) and "fvd" in res and res["_meta"]["step"] == 6
    assert len(res["probability_future"]["bpp_prior"]) == 2


@pytest.mark.parametrize("mod,extra", [
    (main_srnn, ["--h_dim", "8", "--z_dim", "4", "--a_dim", "8", "--norm_type_model", "none",
                 "--no-enable_smoothing", "--preprocess_range", "1.0"]),
    (main_vrnn, ["--h_dim", "8", "--z_dim", "4", "--norm_type_model", "batchnorm",
                 "--preprocess_range", "1.0"]),
    (main_svg, ["--z_dim", "4", "--c_features", "8", "--h_dim", "8",
                "--norm_type_model", "none"]),
])
def test_other_mains(tmp_path, mod, extra):
    tr = mod.main(TINY_COMMON + extra + ["--path", str(tmp_path / "run")])
    assert tr.counter == 2 and np.isfinite(tr.losses).all()
    assert (tmp_path / "run" / "model_folder" / "last" / "state.pt").is_file()


def test_shapes_train(tmp_path):
    argv = [a for a in TINY_RFN if a != "mnist"]
    argv[argv.index("--choose_data") + 1:argv.index("--choose_data") + 1] = ["shapes"]
    tr = main_rfn.main(argv + ["--path", str(tmp_path / "shapes"), "--steps_per_epoch", "1"])
    assert tr.counter == 1 and np.isfinite(tr.losses).all()
    # no digit bank, so no data_source line: only the epoch's status
    assert _status(tmp_path / "shapes")[0].startswith("epoch 1 ")


def test_validation_set_repeats_its_pool(tmp_path):
    data = MovingMNIST(seq_len=3, image_size=16, digit_size=8, num_digits=1,
                       digit_bank="synthetic", device="cpu")
    sampler = common.FixedSubsetSampler(data, n_items=4, batch_size=2)
    gen = torch.Generator()
    a, b, c = (sampler.sample(gen, 2) for _ in range(3))
    assert sampler.n_batches == 2 and torch.equal(a, c) and not torch.equal(a, b)
    tr = main_rfn.main(TINY_RFN + ["--path", str(tmp_path / "val"), "--use_validation_set"])
    assert isinstance(tr.data, common.FixedSubsetSampler) and tr.counter == 2
