"""Rate of the results' copies from the device to the host: the bytes
named at the program's ``mil.to_host`` spans over the device seconds
between their events, in GB/s (10^9 bytes a second)."""
from milbench import program


def read(run):
    s = program.span("mil.to_host")
    if not s or s["device_s"] <= 0:
        return None
    return s["bytes"] / s["device_s"] / 1e9
