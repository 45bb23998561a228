"""The coupling tail, the folded actnorm + 1x1 and the ConvLSTM gates in
CUDA C++, each beside its plain PyTorch version.

Replaces ``recurrent_flows_tpu/ops/pallas/fused.py``:

* ``coupling_transform`` replaces ``_coupling_pallas`` (``fused.py:75``):
  forward ``(z2 + shift)·e^s``, reverse ``z2·e^{-s} - shift``, plus the
  per-sample logdet ``Σ s``, in CUDA C++ (``csrc/coupling.cu``), one block
  per sample. It reads z2, shift and s where they lie: NHWC views with
  channel stride 1 or 2 (:func:`nhwc_view`), so the coupling's 'split' and
  'cross' halves need no copy. :func:`coupling_plan` decides its geometry
  and :func:`coupling_mode` its loads.
* ``actnorm_invconv`` replaces ``_actnorm_invconv_pallas``
  (``fused.py:166``): ``((x + b)·e^logs)·Wᵀ`` over rows, the step actnorm
  folded into the invertible 1x1, in CUDA C++ (``csrc/actnorm_invconv.cu``),
  at any C (compile-time instances with the rows in registers at the gray
  widths and at little work; output tiles staged in shared memory at the
  RGB train step's widths and above 64 channels); :func:`ainv_plan` decides
  its geometry.
* ``convlstm_gates`` replaces ``_gates_pallas`` (``fused.py:257``): the
  peephole ConvLSTM update from the fused gate-conv output, in CUDA C++
  (``csrc/convlstm_gates.cu``). One elementwise pass with no reduction
  (5·hc in, 2·hc out per position, peepholes broadcast over B);
  :func:`gates_plan` decides its geometry.

The source notes in ``csrc/`` say what bounds each CUDA kernel on the H100
and what its design does about it. Each wrapper validates its inputs and
calls its ``torch.library`` operator (``ops.library``: ``rft::<wrapper>``)
on every device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises; nothing falls back and nothing is copied
behind the caller's back. The operator's CUDA implementation counts its
launches in ``<wrapper>.launches``. Every kernel is built on its first
launch only. Backwards are plain PyTorch, registered with the operators,
as the TPU kernels' VJPs are plain jnp: the closed forms for the coupling
and the folded 1x1, the plain version re-run under autograd for the gates.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def coupling_transform_ref(z2, shift, s, reverse: bool = False):
    """Plain version: (z2', logdet[B])."""
    if not reverse:
        out = (z2 + shift) * torch.exp(s)
    else:
        out = z2 * torch.exp(-s) - shift
    return out, s.reshape(s.shape[0], -1).sum(-1)


def convlstm_gates_ref(gates, c, w_ci, w_cf, w_co):
    """Plain version: gates [B,H,W,4hc] in order (i,f,o,g) -> (h', c')."""
    cc_i, cc_f, cc_o, cc_g = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(cc_i + w_ci * c)
    f = torch.sigmoid(cc_f + w_cf * c)
    g = torch.tanh(cc_g)
    c_next = f * c + i * g
    o = torch.sigmoid(cc_o + w_co * c_next)
    return o * torch.tanh(c_next), c_next


def actnorm_invconv_ref(x, bias, logs, w):
    """Plain version: ((x + bias)·e^logs) @ wᵀ over the last axis."""
    return ((x + bias) * torch.exp(logs)) @ w.T


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name, tensors, shapes, contiguous=True):
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _load(name: str, launch_args: list):
    """The built ``csrc/<name>.cu`` with its C functions typed."""
    from ._build import load

    lib = load(name)
    if not getattr(lib, "_typed", False):
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes, launch.restype = launch_args, ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib, name: str, err: int):
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())


COUPLING_MAX_THREADS = 1024


class CouplingPlan(NamedTuple):
    """The launch geometry of ``csrc/coupling.cu`` for a batch of samples of
    n values each, cut into ceil(n/4) groups of 4."""

    threads: int  # per block, a multiple of 32; thread t takes groups t, t + threads, ...
    blocks: int  # b: one per sample


def coupling_plan(b: int, n: int) -> CouplingPlan:
    """The launch geometry of the coupling kernel for b samples of n values.
    A pure function of the shapes.

    One block takes a whole sample, one group of 4 values per thread while
    the sample fits 1,024 threads (a thread loops over several beyond
    that). On the H100 a thread-block cluster of 2 to 8 blocks per sample
    was slower at every shape of ``rfn_mnist_production`` (``PERF.md``)."""
    if b < 1 or n < 1:
        raise ValueError(f"coupling_plan: bad shape (b={b}, n={n})")
    return CouplingPlan(min(COUPLING_MAX_THREADS, _cdiv(_cdiv(n, 4), 32) * 32), b)


def nhwc_view(name: str, t) -> tuple[int, int]:
    """(row stride R, channel stride cs) of an NHWC tensor whose element
    (b, h, w, c) lies at ((b·H + h)·W + w)·R + c·cs with cs 1 or 2: a
    contiguous tensor, or the 'split' (x[..., C/2:]) or 'cross'
    (x[..., 0::2], x[..., 1::2]) half of one. Raises ValueError on any other
    layout; the strides of axes of length 1 are never used."""
    if t.dim() != 4:
        raise ValueError(f"{name}: expected NHWC, got shape {tuple(t.shape)}")
    b, h, w, c = t.shape
    sb, sh, sw, sc = t.stride()
    cs = sc if c > 1 else 1
    r = next((st for size, st in ((w, sw), (h, sh), (b, sb)) if size > 1), c * cs)
    ok = (cs in (1, 2) and r >= (c - 1) * cs + 1
          and (w == 1 or sw == r) and (h == 1 or sh == w * r)
          and (b == 1 or sb == h * w * r))
    if not ok:
        raise ValueError(
            f"{name}: strides {t.stride()} of shape {tuple(t.shape)}; the kernel "
            "takes NHWC views whose positions lie one row stride apart, with "
            "channel stride 1 or 2 (a contiguous tensor, or a 'split' or "
            "'cross' half of one)")
    return r, cs


def coupling_mode(ch: int, n: int, views) -> int:
    """How ``csrc/coupling.cu`` loads a group of 4 values, given the
    (data_ptr, row stride, channel stride) of each input: 4 where C/2 = ch
    is a multiple of 4 (16-byte loads in one position), 2 where ch = 2 (16
    bytes of a contiguous view or of each of two positions of a 'cross'
    view, 8 bytes of each of two positions of a 'split' view), 1 (4-byte
    loads) where a pointer or a row stride breaks the alignment that needs,
    or n is no multiple of 4."""
    def aligned(floats, ptr, r):
        return ptr % (4 * floats) == 0 and r % floats == 0

    if ch % 4 == 0 and all(aligned(4, p, r) for p, r, _ in views):
        return 4
    # at ch = 2 a group starts at an even position: a contiguous view (r = 2)
    # needs only a 16-byte aligned pointer
    if ch == 2 and n % 4 == 0 and all(p % 16 == 0 if r == 2 else aligned(2 * cs, p, r)
                                      for p, r, cs in views):
        return 2
    return 1


_COUPLING_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _coupling_launch(z2, shift, s, reverse, strides):
    lib = _load("coupling", _COUPLING_ARGS)
    b, h, w, ch = z2.shape
    n = h * w * ch
    views = [(t.data_ptr(), r, cs) for t, (r, cs) in zip((z2, shift, s), strides)]
    if b * h * w * max(ch, *(r for r, _ in strides)) >= 2**31:
        raise ValueError("coupling_transform: the kernel indexes in 32 bits; "
                         f"z2 {tuple(z2.shape)} is too large")
    plan = coupling_plan(b, n)
    out = torch.empty((b, h, w, ch), device=z2.device, dtype=torch.float32)
    ld = torch.empty((b,), device=z2.device, dtype=torch.float32)
    with torch.cuda.device(z2.device):
        err = lib.coupling_launch(
            *(a for v in views for a in v), out.data_ptr(), ld.data_ptr(),
            b, n, ch, coupling_mode(ch, n, views), plan.threads, int(reverse),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "coupling", err)
    coupling_transform.launches += 1
    return out, ld


def coupling_transform(z2, shift, s, reverse: bool = False):
    """(z2', logdet[B]) for the affine coupling tail, NHWC f32. The inputs
    may be views with channel stride 1 or 2 (:func:`nhwc_view`); z2' is
    contiguous."""
    _check("coupling_transform", (z2, shift, s), (z2.shape,) * 3, contiguous=False)
    # the layout (nhwc_view) is checked where the operator runs, on either
    # device: a trace's fake tensors may carry other strides than the real
    # ones (a cuDNN conv's output, for one)
    return torch.ops.rft.coupling_transform.default(z2, shift, s, bool(reverse))


coupling_transform.launches = 0


GATES_MAX_THREADS = 256
_GRID_MAX = 65535  # the largest grid along y and z


class GatesPlan(NamedTuple):
    """The launch geometry of ``csrc/convlstm_gates.cu`` on gates
    [B, H, W, 4hc]: a grid (H·W, channel_blocks, B), one state per thread."""

    threads: int  # per block, a multiple of 32; thread t of block (p, j, b) takes channel j·threads + t
    channel_blocks: int  # ceil(hc / threads)
    blocks: int  # H·W · channel_blocks · B


def gates_plan(b: int, hw: int, hc: int) -> GatesPlan:
    """The launch geometry of the ConvLSTM gates on b samples of hw
    positions and hc channels. A pure function of the shapes.

    A thread computes one state; a block, the channels of one position of
    one sample, or an even share of them where they are more than
    ``GATES_MAX_THREADS`` (224 threads at hc = 200: 32 blocks at B = 8, 120
    at B = 30). More states per thread (4 or 2 channels by 16- or 8-byte
    loads, or 2 samples sharing the peepholes) measured slower on the H100
    (``PERF.md``)."""
    if b < 1 or hw < 1 or hc < 1:
        raise ValueError(f"gates_plan: bad shape (b={b}, hw={hw}, hc={hc})")
    channel_blocks = _cdiv(hc, GATES_MAX_THREADS)
    threads = _cdiv(_cdiv(hc, channel_blocks), 32) * 32
    if b > _GRID_MAX:
        raise ValueError(f"gates_plan: a batch of {b}; the kernel takes at most {_GRID_MAX}")
    return GatesPlan(threads, channel_blocks, hw * channel_blocks * b)


_GATES_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _gates_launch(gates, c, w_ci, w_cf, w_co):
    lib = _load("convlstm_gates", _GATES_ARGS)
    b, h, w, hc = c.shape
    if gates.numel() >= 2**31:
        raise ValueError("convlstm_gates: the kernel indexes in 32 bits; gates "
                         f"{tuple(gates.shape)} is too large")
    plan = gates_plan(b, h * w, hc)
    h_next = torch.empty_like(c)
    c_next = torch.empty_like(c)
    with torch.cuda.device(c.device):
        err = lib.convlstm_gates_launch(
            *(t.data_ptr() for t in (gates, c, w_ci, w_cf, w_co, h_next, c_next)),
            b, h * w, hc, plan.threads, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "convlstm_gates", err)
    convlstm_gates.launches += 1
    return h_next, c_next


def convlstm_gates(gates, c, w_ci, w_cf, w_co):
    """Peephole gate nonlinearity + state update -> (h_next, c_next)."""
    b, h, w, hc4 = gates.shape
    if hc4 % 4:
        raise ValueError("convlstm_gates: gate channels must be 4·hc")
    hc = hc4 // 4
    peep = (1, h, w, hc)
    _check("convlstm_gates", (gates, c, w_ci, w_cf, w_co),
           (gates.shape, (b, h, w, hc), peep, peep, peep))
    return torch.ops.rft.convlstm_gates.default(gates, c, w_ci, w_cf, w_co)


convlstm_gates.launches = 0


MAX_INVCONV_CHANNELS = 64  # the widest C the run-time-width instance takes (vec 0)
AINV_WIDTHS = (4, 8, 16, 32, 64)  # compile-time widths, the gray presets'
AINV_RGB_WIDTHS = (12, 24, 48, 96)  # compile-time widths, the RGB preset's
# the RGB widths 24-96 take vec 1 up to this much work (rows · C²), the
# tiles above it: the crossover measured on the H100 (PERF.md)
AINV_REGISTER_WORK = 1 << 22
AINV_MAX_THREADS = 256
# the tile design (vec 2): its output tiles at most, the channels of one
# stage at most, and the shared memory a block may hold on the H100
# (csrc/actnorm_invconv.cu)
AINV_TILE_ROWS, AINV_TILE_COLS = 64, 64
AINV_TILE_LANES = 8
AINV_TILE_MAX_K = 256
AINV_MAX_SMEM = 227 * 1024 - 64  # less the kernel's static mbarriers
N_SMS = 132  # streaming multiprocessors of one H100 SXM


class AinvPlan(NamedTuple):
    """The launch geometry of ``csrc/actnorm_invconv.cu`` on x [rows, C]."""

    vec: int  # 1: the instance of compile-time width C, 16-byte loads; 0: run-time C <= 64; 2: tiles
    lanes: int  # threads that share one output's C-sum (1 where vec is 0)
    groups: int  # vec 1: 4-wide output vectors of a row per block; 2: outputs / 4; 0: vec 0
    rows_per_block: int  # block (i, j) takes rows [i·rows_per_block, ...), vectors [j·groups, ...)
    threads: int  # rows_per_block · groups · lanes (rows_per_block · C where vec is 0; / 4 where 2)
    blocks: int  # over both grid axes
    k_stage: int = 0  # vec 2: channels staged at a time, a multiple of 4 · lanes


def ainv_tile_smem(tm: int, tn: int, lanes: int, k_stage: int, c: int) -> int:
    """Bytes of dynamic shared memory of a tile, as ``tile_smem_floats`` in
    ``csrc/actnorm_invconv.cu``: one stage buffer (two where a stage holds
    less than c) of tm x rows and tn W rows, ``k_stage`` channels each at a
    stride of an odd number of 4 floats, and the stage's scales and shifts;
    the lanes' partial sums reuse it."""
    stride = k_stage + (0 if (k_stage // 4) % 2 else 4)
    stage = (2 if k_stage < c else 1) * (tm + tn) * stride + 2 * k_stage
    return 4 * max(stage, lanes * tm * tn if lanes > 1 else 0)


def _tile_plan(rows: int, c: int) -> AinvPlan:
    n_vec = _cdiv(c, 4)
    # up to 64 channels a block is short (a few thousand clocks): two share an SM
    per_sm = 2 if c <= MAX_INVCONV_CHANNELS else 1
    best = None
    for tm in range(4, AINV_TILE_ROWS + 1, 4):
        for groups in range(1, min(n_vec, AINV_TILE_COLS // 4) + 1):
            tn = 4 * groups
            blocks = _cdiv(rows, tm) * _cdiv(n_vec, groups)
            # an SM's FMAs at 128 a clock and bytes of x and W at 64 a clock,
            # over its blocks
            cost = (_cdiv(blocks, per_sm * N_SMS) * per_sm
                    * (tm * tn * c / 128 + (tm + tn) * c / 16))
            key = (cost, blocks, -tn)
            if best is None or key < best[0]:
                best = (key, tm, groups, blocks)
    _, tm, groups, blocks = best
    cells = tm // 4 * groups  # 4x4 register tiles of a lane
    # a lane keeps at least 12 channels (24 above 64, where the partial sums
    # of a larger tile cost more to add)
    per_lane = 12 if per_sm == 2 else 24
    lanes = 1
    while (cells * lanes * 2 <= AINV_MAX_THREADS and lanes < AINV_TILE_LANES
           and min(c, AINV_TILE_MAX_K) // (2 * lanes) >= per_lane):
        lanes *= 2
    step = 4 * lanes
    k_stage = _cdiv(c, step) * step
    if k_stage > AINV_TILE_MAX_K:  # two buffers take turns
        k_stage = AINV_TILE_MAX_K // step * step
        while ainv_tile_smem(tm, 4 * groups, lanes, k_stage, c) > AINV_MAX_SMEM:
            k_stage -= step
    return AinvPlan(2, lanes, groups, tm, cells * lanes, blocks, k_stage)


def ainv_plan(rows: int, c: int, *, aligned: bool = True) -> AinvPlan:
    """The launch geometry of the folded actnorm + 1x1 on x [rows, c]. A
    pure function of the shapes (and of whether the pointers are 16-byte
    aligned).

    At c in ``AINV_WIDTHS`` (the gray presets' 4-64) and at 12 (aligned
    pointers), and at the other RGB widths 24, 48 and 96 up to
    ``AINV_REGISTER_WORK`` (rows · c², the serving request's scales), the
    compile-time instance (vec 1): a thread computes a 4-wide output vector
    of one row from the row and W's rows in registers; from c = 32 the
    c-term sum of each output is split over ``lanes`` = 4 threads, and a
    block computes ``groups`` output vectors of its rows: 2 where they
    divide c/4, else 1. Any other c <= 64 (and unaligned pointers) takes the
    run-time-width instance, one thread per output. The blocks are at most
    ``N_SMS``, one per SM, of at most ``AINV_MAX_THREADS`` threads.

    At 24, 48 and 96 above that work, and at any c above 64, the tile design
    (vec 2): a block computes an output tile of ``rows_per_block`` rows by
    4·``groups`` outputs, each thread a 4x4 register tile, and ``lanes``
    threads share each output's c-sum. The tile is the one that minimises a
    model of an SM's time (FMAs at 128 a clock, bytes of x and W at 64 a
    clock, over the SM's blocks; two blocks an SM up to 64 channels); the
    lanes double, to at most ``AINV_TILE_LANES``, while the block keeps
    within ``AINV_MAX_THREADS`` threads and a lane keeps at least 12
    channels (24 above 64); a stage takes ``k_stage`` channels, all of c up
    to ``AINV_TILE_MAX_K``. ``scripts/torch_ainv_tiles.py`` times every tile
    the kernel takes beside this choice."""
    if rows < 1 or c < 1:
        raise ValueError(f"ainv_plan: bad shape (rows={rows}, C={c}); the kernel "
                         "takes at least 1 row and 1 channel")
    in_registers = aligned and c in AINV_RGB_WIDTHS and (c == 12 or rows * c * c
                                                         <= AINV_REGISTER_WORK)
    if not in_registers and (c > MAX_INVCONV_CHANNELS or (aligned and c in (24, 48))):
        return _tile_plan(rows, c)
    return ainv_row_plan(rows, c, int(aligned and c in AINV_WIDTHS + AINV_RGB_WIDTHS))


def ainv_row_plan(rows: int, c: int, vec: int) -> AinvPlan:
    """The geometry :func:`ainv_plan` gives x [rows, c] in the compile-time
    instance (vec 1, c in ``AINV_WIDTHS`` or ``AINV_RGB_WIDTHS``) or the
    run-time-width one (vec 0, c <= 64), whatever the work."""
    if not vec:
        lanes, groups, col_blocks, per_row = 1, 0, 1, c
    else:
        lanes, groups = (4 if c >= 32 else 1), (2 if (c // 4) % 2 == 0 else 1)
        col_blocks, per_row = c // 4 // groups, groups * lanes
    rpb = max(1, min(AINV_MAX_THREADS // per_row, _cdiv(rows * col_blocks, N_SMS)))
    return AinvPlan(vec, lanes, groups, rpb, rpb * per_row, _cdiv(rows, rpb) * col_blocks)


_AINV_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def ainv_launch_plan(plan: AinvPlan, x, bias, logs, w, y=None):
    """The kernel on x [rows, C] (contiguous, on the card) under ``plan``
    into ``y`` (a new tensor by default), uncounted: the launch of
    :func:`actnorm_invconv` and a measurement's way to time a plan that
    :func:`ainv_plan` does not pick."""
    lib = _load("actnorm_invconv", _AINV_ARGS)
    c = x.shape[-1]
    y = torch.empty_like(x) if y is None else y
    with torch.cuda.device(x.device):
        err = lib.actnorm_invconv_launch(
            x.data_ptr(), bias.data_ptr(), logs.data_ptr(), w.data_ptr(),
            y.data_ptr(), x.numel() // c, c, plan.vec, plan.lanes, plan.rows_per_block,
            plan.groups, plan.k_stage, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "actnorm_invconv", err)
    return y


def _ainv_launch(x, bias, logs, w):
    c = x.shape[-1]
    y = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, y))
    ainv_launch_plan(ainv_plan(x.numel() // c, c, aligned=aligned), x, bias, logs, w, y)
    actnorm_invconv.launches += 1
    return y


def actnorm_invconv(x, bias, logs, w):
    """y = ((x + bias)·e^logs) @ wᵀ over the last axis of x [..., C], f32:
    the step actnorm folded into the 1x1 (no logdet; the caller has it
    from ``logs`` and ``w`` alone)."""
    c = x.shape[-1]
    _check("actnorm_invconv", (x, bias, logs, w), (x.shape, (c,), (c,), (c, c)))
    return torch.ops.rft.actnorm_invconv.default(x, bias, logs, w)


actnorm_invconv.launches = 0
