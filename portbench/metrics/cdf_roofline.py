"""cdf_roofline: the exact-CDF walk's share of its roofline, in %.

The least time the traced corpora need (work.cdf_bound: every entry of the
row each step leaves weighed once at work.OPS_PER_ENTRY operations, two
draws a step, the corpus written and the rows read once; the entries
counted over the window's last corpus, whose rows the check verified) over
the device time of csrc/cdf_walk.cu's kernels in the trace. Moves
walk_steps_per_s."""

from portbench.trace import source_pattern


def read(run):
    if run.trace is None or run.kind != "walk" or run.sampler != "cdf":
        return None
    t = run.trace.seconds_of(source_pattern("cdf_walk.cu"))
    if t <= 0:
        return None
    return 100.0 * run.bound_per_call() * run.trace.calls / t
