"""Device-idle ms inside the registration pyramid's levels per pair: the
gaps in the device's activity that fall inside the program's
``mil.reg.level`` host ranges (the profiler's clock), over the window's
completed pairs."""
from milbench import program


def read(run):
    if run.trace is None:
        return None
    idle = program.idle_within_ns(run.trace, "mil.reg.level")
    return program.per_call(run, None if idle is None else idle / 1e6)
