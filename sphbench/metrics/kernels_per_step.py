"""kernels_per_step: device kernels (not copies or sets) in the traced
window, over the steps it ran: what one replay of the captured step
launches."""


def read(run):
    tr = run.trace
    if tr is None or not tr.steps or not tr.device:
        return None
    return len(tr.kernels()) / tr.steps
