"""The port's KTH preparation against ``recurrent_flows_tpu.data.prepare_kth``
on the CPU, with stub ``wget``/``tar``/``ffmpeg`` executables first on
``PATH`` (nothing is ever downloaded): the same flags, the same commands
with the same arguments in the same order (each stub logs its argv), a
failing ``wget`` returns False in both packages, and the frames a stub
``ffmpeg`` writes with ``write_png`` land in the layout ``data/kth.py``
reads, which then gives a batch."""

import os
import stat
import sys

import numpy as np

from recurrent_flows_tpu.data import prepare_kth as jk
from recurrent_flows_tpu_torch.data import KTH
from recurrent_flows_tpu_torch.data import prepare_kth as pk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = """#!{python}
import os, sys
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(" ".join([os.path.basename(sys.argv[0])] + sys.argv[1:]) + "\\n")
name = os.path.basename(sys.argv[0])
if name == "wget" and os.environ.get("STUB_FAIL"):
    sys.exit(4)
if name == "ffmpeg":  # the port's write_png, its module loaded alone (no torch)
    import importlib.util, types
    import numpy as np
    data_dir = os.path.join({repo!r}, "recurrent_flows_tpu_torch", "data")
    pkg = sys.modules["_data"] = types.ModuleType("_data")
    pkg.__path__ = [data_dir]
    spec = importlib.util.spec_from_file_location("_data.png", os.path.join(data_dir, "png.py"))
    png = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(png)
    write_png = png.write_png
    size = int(sys.argv[sys.argv.index("-vf") + 1].split("=")[1].split(":")[0])
    pattern = sys.argv[-1]
    for i in range(1, 13):
        write_png(pattern % i, np.full((size, size), 10 * i, np.uint8))
"""


def _stubs(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("wget", "tar", "ffmpeg"):
        p = bin_dir / name
        p.write_text(STUB.format(python=sys.executable, repo=REPO))
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    log = tmp_path / "log.txt"
    monkeypatch.setenv("STUB_LOG", str(log))
    return log


def _run(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prepare_kth"] + argv)
    return mod.main()


def test_same_flags_and_commands_as_jax(tmp_path, monkeypatch):
    log = _stubs(tmp_path, monkeypatch)
    jax_opts = {a.dest: (a.default, a.option_strings) for a in _parser_actions(jk, monkeypatch)}
    assert {a.dest: (a.default, a.option_strings) for a in pk.build_parser()._actions} == jax_opts
    for mod in (jk, pk):
        root = tmp_path / mod.__name__.split(".")[0]
        _run(mod, ["--data_root", str(root)], monkeypatch)
        for cls in ("walking", "boxing"):
            (root / "raw" / cls).mkdir(parents=True, exist_ok=True)
            (root / "raw" / cls / f"person01_{cls}_d1_uncomp.avi").write_bytes(b"")
        _run(mod, ["--data_root", str(root), "--from_raw", "--image_size", "16"], monkeypatch)
    lines = log.read_text().splitlines()
    half = len(lines) // 2
    assert len(lines) == 2 * half == 8  # wget, tar, 2 ffmpeg per package
    strip = lambda line, root: line.replace(str(tmp_path / root), "ROOT")  # noqa: E731
    assert ([strip(x, "recurrent_flows_tpu") for x in lines[:half]]
            == [strip(x, "recurrent_flows_tpu_torch") for x in lines[half:]])
    assert lines[half].startswith("wget -q http") and lines[half + 1].startswith("tar -xzf")


def _parser_actions(mod, monkeypatch):
    """The JAX module builds its parser inside main(): capture it there."""
    import argparse

    seen = {}

    def capture(self, *a, **k):
        seen["p"] = self
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        try:
            mod.main()
        except SystemExit:
            pass
    return seen["p"]._actions


def test_failing_wget_returns_false_in_both(tmp_path, monkeypatch, capsys):
    _stubs(tmp_path, monkeypatch)
    monkeypatch.setenv("STUB_FAIL", "1")
    assert jk.download_processed(str(tmp_path)) is False
    assert pk.download_processed(str(tmp_path)) is False
    assert "place frames under" in capsys.readouterr().err
    monkeypatch.delenv("STUB_FAIL")
    assert pk.download_processed(str(tmp_path)) is True


def test_extracted_frames_are_the_layout_kth_reads(tmp_path, monkeypatch):
    _stubs(tmp_path, monkeypatch)
    for person in ("person01", "person22"):  # a train and a test person
        for cls in pk.CLASSES[:2]:
            d = tmp_path / "raw" / cls
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{person}_{cls}_d1_uncomp.avi").write_bytes(b"")
    pk.extract_frames(str(tmp_path), image_size=16)
    frames = sorted((tmp_path / "processed" / "boxing" / "person01_boxing_d1_uncomp").iterdir())
    assert [f.name for f in frames][:2] == ["image-001.png", "image-002.png"] and len(frames) == 12
    for train in (True, False):
        ds = KTH(train, str(tmp_path), seq_len=10, image_size=16, batch_size=2)
        batch = next(iter(ds))
        assert batch.shape == (2, 10, 16, 16, 1)
        assert np.isin(np.round(batch * 255), 10 * np.arange(1, 13)).all()
