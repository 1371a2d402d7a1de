"""Device ms of K9's stage kernels (reg_stage_kernel) per registered
pair, from the profiler's trace."""


def read(run):
    tv = run.trace
    if tv is None or not run.completed():
        return None
    s = tv.kernel_s("reg_stage_kernel")
    return 1e3 * s / run.completed() if s > 0 else None
