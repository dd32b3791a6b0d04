"""device_idle_share: the share of the traced window in which no operation
ran on the device, 1 - union of the device events' intervals / window,
from torch.profiler (the window on the device's clock)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or not tr.window_us:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
