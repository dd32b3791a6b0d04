"""rescued_rows_per_drop: rows the program's rescue took in over the
window, over the drops the window holds. The count is the program's own
device counter (the step graph's ``rescued``, to which R1 adds the rows it
takes in), added up across resets and read once on the host after the
window's final synchronisation (``run.rescued_rows``, sphbench/drive.py).
The window starts at a reset and ends with a whole drop, so it holds
``run.resets + 1`` drops. None where the run has no such count."""


def read(run):
    if run.rescued_rows is None:
        return None
    return run.rescued_rows / (run.resets + 1)
