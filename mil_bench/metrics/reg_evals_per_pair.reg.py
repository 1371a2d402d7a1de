"""Cost evaluations per registered pair: the evaluations K9 ran on K4's,
K5's and K6's bodies (a K6 pass of up to 8 matrices counts once) and the
launches of K4, K5 and K6 of their own, from the program's counters."""

COUNTERS = [("microimagelib_tpu_torch.kernels.reg_ladder", n)
            for n in ("K9_EVALS_K4", "K9_EVALS_K5", "K9_EVALS_K6")] + [
           ("microimagelib_tpu_torch.kernels.corr", n)
           for n in ("K4_LAUNCHES", "K5_LAUNCHES", "K6_LAUNCHES")]


def read(run):
    evals = sum(run.counters.get(c, 0) for c in COUNTERS)
    n = run.completed()
    return evals / n if evals and n else None
