"""Runtime: seconds from the driver's ``fit()`` to the loop's first line,
on the rank that started last (the gang waits for it)."""


def read(run):
    return max(r["stamps"]["loop_start"] for r in run.ranks) - run.fit_start
