#!/usr/bin/env python3
"""Device times of variants of the ConvLSTM gates kernel on one NVIDIA GPU,
beside the package's kernel: the alternatives its design was chosen from.

    python3 scripts/torch_gates_variants.py

Builds ``scripts/torch_gates_variants.cu`` (a measurement aid, not part of
the package) four ways: quotients by ``__fdividef`` (as the package's
kernel) or by IEEE division, each with and without in-kernel clocks. At the
gates [8,2,2,800] of the serving request and [30,2,2,800] of the train step
it times (``chip_smoke.small_ms``) the package's kernel, an in-place add
over c and each variant: 1, 2 or 4 channels per thread (4-, 8- or 16-byte
loads), 1 or 2 samples per thread (the peepholes kept in registers), and
two block sizes; each variant is first checked against the plain version
within 1e-5·(1+|ref|). Then one launch of each clock build, after a
warm-up, gives the median clocks per block from its start to its loads'
return and from there to its last store. Prints the card's name and power
limit first and last; writes ``chiprun_out/gates_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from recurrent_flows_tpu_torch import ops  # noqa: E402
from recurrent_flows_tpu_torch.ops import _build  # noqa: E402

SRC = Path(__file__).with_suffix(".cu")
BUILDS = {"fdividef": [], "ieee": ["-DIEEE_DIV"], "fdividef clocks": ["-DCLOCKS"],
          "ieee clocks": ["-DIEEE_DIV", "-DCLOCKS"]}
# (channels per thread, samples per thread, threads per block)
VARIANTS = [(1, 1, 224), (1, 1, 128), (1, 2, 224), (2, 1, 128), (4, 1, 64), (4, 2, 64)]
HC = 200  # h_dim of rfn_mnist_production


def build(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: (out_dir / f"gates_variants_{name.replace(' ', '_')}.so",
                    subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                                      str(out_dir / f"gates_variants_{name.replace(' ', '_')}.so"),
                                      str(SRC)], stderr=subprocess.PIPE, text=True))
             for name, flags in BUILDS.items()}
    libs = {}
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SRC.name} ({name}):\n{err}")
        lib = ctypes.CDLL(str(path))
        lib.gates_variant_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                             + [ctypes.c_void_p] * 2)
        lib.gates_variant_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, gates, c, peeps, vec, samples, threads, clocks=None):
    b, h, w, hc = c.shape
    out = torch.empty_like(c), torch.empty_like(c)
    err = lib.gates_variant_launch(
        *(t.data_ptr() for t in (gates, c, *peeps, *out)), b, h * w, hc, vec, samples, threads,
        0 if clocks is None else clocks.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gates variant ({vec}, {samples}, {threads}): error {err}")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = chip_smoke.card_info()
    print(f"card: {card}")
    _build.build_all(("convlstm_gates",))
    libs = build(_build.BUILD_DIR / "variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, scale=1.0: scale * torch.randn(s, generator=gen, device="cuda")
    floor = chip_smoke.launch_floor_ms()
    print(f"launch floor (in-place add on one element): {floor * 1e3:.3f} us", flush=True)
    rows = [dict(case="launch floor", ms=floor)]
    for b in (chip_smoke.BATCH, chip_smoke.TRAIN_BATCH):
        gates, c = rnd(b, 2, 2, 4 * HC), rnd(b, 2, 2, HC)
        peeps = [rnd(1, 2, 2, HC, scale=0.1) for _ in range(3)]
        ref = ops.convlstm_gates_ref(gates, c, *peeps)
        plan = ops.gates_plan(b, 4, HC)
        add = torch.zeros_like(c)
        base = dict(shape=list(gates.shape), plan=plan._asdict())
        for case, fn in (("package kernel", lambda: ops.convlstm_gates(gates, c, *peeps)),
                         ("in-place add over c", lambda: add.add_(1.0))):
            rows.append(dict(base, case=case, ms=chip_smoke.small_ms(fn)))
            print(f"gates {base['shape']} {case}: {rows[-1]['ms'] * 1e3:.3f} us", flush=True)
        kernel_out = ops.convlstm_gates(gates, c, *peeps)
        for name in ("fdividef", "ieee"):
            for vec, samples, threads in VARIANTS:
                got = launch(libs[name], gates, c, peeps, vec, samples, threads)
                chip_smoke.check_elementwise(f"variant {name} {vec} {samples} {threads}", got,
                                             ref, (chip_smoke.TOL_ELEMENTWISE,) * 2)
                row = dict(base, case=f"{name}, {vec} channels x {samples} samples per thread, "
                                       f"{threads} threads",
                           same_as_kernel=all(torch.equal(x, y) for x, y in zip(got, kernel_out)),
                           ms=chip_smoke.small_ms(lambda: launch(libs[name], gates, c, peeps,
                                                                 vec, samples, threads)))
                rows.append(row)
                print(f"gates {base['shape']} {row['case']}: {row['ms'] * 1e3:.3f} us, "
                      f"bit-identical to the kernel: {row['same_as_kernel']}", flush=True)
        clocks = torch.zeros(2 * 4 * b * 8, dtype=torch.int64, device="cuda")
        for name in ("fdividef clocks", "ieee clocks"):
            for vec, samples, threads in (VARIANTS[0], VARIANTS[4]):
                for _ in range(50):
                    launch(libs[name], gates, c, peeps, vec, samples, threads, clocks)
                clocks.zero_()
                launch(libs[name], gates, c, peeps, vec, samples, threads, clocks)
                n = 4 * -(-(HC // vec) // threads) * -(-b // samples)  # blocks
                q = clocks[: 2 * n].view(n, 2).double().cpu().median(0).values
                row = dict(base, case=f"{name}, {vec} channels x {samples} samples per thread",
                           clocks_to_loads=q[0].item(), clocks_loads_to_last_store=q[1].item())
                rows.append(row)
                print(f"gates {base['shape']} {row['case']}: median clocks per block "
                      f"{row['clocks_to_loads']:.0f} to the loads' return, "
                      f"{row['clocks_loads_to_last_store']:.0f} from there to the last store",
                      flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gates_variants.json").write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    print(card)


if __name__ == "__main__":
    main()
