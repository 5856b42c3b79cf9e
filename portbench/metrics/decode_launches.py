"""Serve engine: kernel launches the host issues a decode step: the
profiler's ``cuda_runtime`` launch events (names holding ``LaunchKernel``
or ``GraphLaunch``) on the thread and inside the interval of each
``serve.decode`` span of the program ÷ those spans (profiled rounds)."""


def _is_launch(e):
    return e.get("cat") == "cuda_runtime" and ("LaunchKernel" in e["name"]
                                               or "GraphLaunch" in e["name"])


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    steps = [e for e in tr.host if e.get("cat") == "user_annotation"
             and e["name"] == "serve.decode"]
    if not steps:
        return None
    launches = [e for e in tr.host if _is_launch(e)]
    if not launches:                    # no device: a CPU run
        return None
    n = 0
    for s in steps:
        lo, hi, where = s["ts"], s["ts"] + s["dur"], (s.get("pid"), s.get("tid"))
        n += sum(1 for e in launches if (e.get("pid"), e.get("tid")) == where
                 and lo <= e["ts"] and e["ts"] + e["dur"] <= hi)
    return n / len(steps)
