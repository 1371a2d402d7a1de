"""Mean ms of a decon_singleview call outside its RL iterations (plans,
OTFs, padding, the host copy of the result): the call's host span less
the device time between the events the benchmark records on the stream
around the program's RL loop (models.deconvolution._rl_loop)."""

SPANS = [("microimagelib_tpu_torch.models.deconvolution", "_rl_loop", "decon.rl_loop")]


def read(run):
    calls = run.spans.host_s("bench.call")
    loops = run.spans.device_s("decon.rl_loop") or run.spans.host_s("decon.rl_loop")
    if not calls or len(loops) != len(calls):
        return None
    return 1e3 * (sum(calls) - sum(loops)) / len(calls)
