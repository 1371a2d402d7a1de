"""Free-memory queries of the device (``cudaMemGetInfo``: the memory
tiers' budget and the records' free-memory slots) per registered pair: the
calls of the program's ``mil.mem_query`` spans over the window's
completed calls."""
from milbench import program


def read(run):
    s = program.spans()
    if s is None:
        return None
    return program.per_call(run, s.get("mil.mem_query", {}).get("calls", 0))
