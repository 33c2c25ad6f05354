"""Train: the host's mean ms a ``session.report`` call in the window (the
loop's own timer around the call; the loss's ``.item()`` before it is not
counted), over every rank's calls."""


def read(run):
    calls = [ms for r in run.ranks for ms in r["window"]["report_ms"]]
    return sum(calls) / len(calls) if calls else None
