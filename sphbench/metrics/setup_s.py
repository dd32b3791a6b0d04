"""setup_s: process start to the first timed step (imports, CUDA context,
inputs, kernel build or load, capture, settling), host clock."""


def read(run):
    return run.setup_s
