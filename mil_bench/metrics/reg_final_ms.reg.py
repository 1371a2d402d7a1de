"""Device ms of the final transform per registered pair: the device
seconds between the events of the program's ``mil.reg.final_transform``
spans (the source resampled by the found matrix) over the window's
completed pairs."""
from milbench import program


def read(run):
    s = program.span("mil.reg.final_transform")
    if not s or s["device_s"] <= 0:
        return None
    return program.per_call(run, 1e3 * s["device_s"])
