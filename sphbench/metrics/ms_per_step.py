"""ms_per_step: the closed loop's whole window over every step it
completed (host clock, to the final synchronisation)."""


def read(run):
    if run.loop != "closed" or not run.steps:
        return None
    return 1e3 * run.wall_s / run.steps
