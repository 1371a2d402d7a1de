"""One traced run of a benchmark cell, then the program's own spans beside
the benchmark's (on the card, in one process):

    python3 tools/trace_agree.py --workload <cell> --seed <n> --seconds <s> [--root DIR]

Runs ``DIR/mil_bench/run.py --trace 1`` in this process (DIR defaults to
this checkout; a parent unpacked with ``git archive`` into a directory
that ``.gitignore`` lists serves as the other side), so its result line is
printed last on standard output as ``run.py`` prints it. Then, on
standard error, one JSON line ``trace_agree``: the window's completed
calls and traced rate, the span totals of the program's trace module
(none for a program without it) with each span's calls per completed
call, the benchmark's own spans (host seconds of ``fusion.reg3d`` and
``fusion.decon_dualview``, device seconds of ``decon.rl_loop``), the
seconds of K9's stage kernels in the profiler's trace, and the device-idle
seconds by label (``milbench/trace.py::idle_gaps``, every label), with
the share labelled ``... > python``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", default=os.path.dirname(HERE))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    path = os.path.join(root, "mil_bench", "run.py")
    spec = importlib.util.spec_from_file_location("mil_bench_run", path)
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)          # puts root's mil_bench and root on sys.path

    seen = keep()
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    out = dict(workload=args.workload, seed=args.seed, root=root, **report(seen))
    print("trace_agree " + json.dumps(out), file=sys.stderr, flush=True)
    return 0


def keep():
    """Keeps the run's benchmark spans and trace view in the dict returned."""
    from milbench import harness
    from milbench.trace import TraceView

    seen = {}
    spans_init, from_profiler = harness.Spans.__init__, TraceView.from_profiler.__func__

    def keep_spans(self, *a, **k):
        spans_init(self, *a, **k)
        seen["spans"] = self

    def keep_view(cls, *a, **k):
        seen["view"] = tv = from_profiler(cls, *a, **k)
        return tv

    harness.Spans.__init__ = keep_spans
    TraceView.from_profiler = classmethod(keep_view)
    return seen


def report(seen):
    tv, bench = seen["view"], seen["spans"]
    calls = len(bench.host_s("bench.call"))
    try:
        from microimagelib_tpu_torch.utils import trace
        program = trace.snapshot()["spans"]
    except ImportError:
        program = None
    for s in (program or {}).values():
        s["per_call"] = s["calls"] / calls if calls else None
    gaps = tv.idle_gaps(list(bench.records), top=10 ** 6)
    idle = sum(v for _n, v in gaps)
    python = sum(v for n, v in gaps if n.endswith("> python"))
    return {"calls": calls, "window_s": tv.window_s,
            "traced_rate_per_s": calls / tv.window_s if tv.window_s else None,
            "program": program,
            "bench": {"fusion.reg3d_host_s": sum(bench.host_s("fusion.reg3d")),
                      "fusion.decon_dualview_host_s": sum(bench.host_s("fusion.decon_dualview")),
                      "decon.rl_loop_device_s": sum(bench.device_s("decon.rl_loop"))},
            "k9_kernel_s": tv.kernel_s("reg_stage_kernel"),
            "idle_s": idle, "idle_python_s": python,
            "idle_python_share": python / idle if idle else None,
            "idle_gaps": gaps[:40]}


if __name__ == "__main__":
    raise SystemExit(main())
