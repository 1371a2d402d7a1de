"""Mean device ms of an RL iteration: the device seconds between the
events of the program's ``mil.rl.iter`` spans (one a call of the
iteration's step, both views of a joint iteration) over their count."""
from milbench import program


def read(run):
    s = program.span("mil.rl.iter")
    if not s or s["device_s"] <= 0:
        return None
    return 1e3 * s["device_s"] / s["calls"]
