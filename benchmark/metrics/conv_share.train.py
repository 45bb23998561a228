"""Share of the device's busy time in convolution kernels (cuDNN and
their layout transposes), in %."""

from benchmark.yardstick import kernel_kind, union_s


def read(reading):
    busy = reading.busy_s()
    conv = union_s([op for op in reading.device_ops if kernel_kind(op[2]) == "conv"])
    return 100.0 * conv / busy if busy > 0 else None
