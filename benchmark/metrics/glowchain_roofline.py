"""The glowchain kernel's share of its roofline in the rollouts, in %:
the sum of its launches' bounds (operations of K GlowSteps at float32
peak, or the bytes they must move, whichever is longer) over the sum of
their device times. Each predicted frame runs one launch per flow scale
with H·W <= 256 (the kernel's limit); where the trace holds another count
the program has left that path and the metric reads nothing."""

from benchmark.reference.rfn import flow_shapes
from benchmark.yardstick import bound_s, glowchain_bytes, glowstep_flops

CHAIN_MAX_HW = 256


def read(reading):
    cfg, t = reading.cell.config["model"], reading.cell.traffic
    b, k, u = t["batch"], cfg["K"], cfg["glow"]["n_units_affine"]
    scales = [(hw, c, cc) for hw, c, cc in flow_shapes(cfg) if hw * hw <= CHAIN_MAX_HW]
    launches = reading.matching("glowchain")
    if not scales or len(launches) != reading.units * t["n_predictions"] * len(scales):
        return None
    per_frame = sum(bound_s(glowchain_bytes(b, hw, hw, c, cc, u, k),
                            k * glowstep_flops(b, hw, hw, c, cc, u)) for hw, c, cc in scales)
    device = sum(e - s for s, e, _ in launches) / 1e9
    return 100.0 * per_frame * reading.units * t["n_predictions"] / device
