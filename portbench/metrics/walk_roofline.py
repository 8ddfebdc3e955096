"""walk_roofline: the rejection walk's share of its roofline, in %.

The least time the traced corpora need (work.rejection_bound: the corpus
written and the rows read once; threefry draws on the floor of one trial a
step, and the trial keys) over the device time of csrc/walk.cu's kernels
(the walk and the trial-key table) in the trace. Moves walk_steps_per_s."""

from portbench.trace import source_pattern


def read(run):
    if run.trace is None or run.kind != "walk" or run.sampler != "rejection":
        return None
    t = run.trace.seconds_of(source_pattern("walk.cu"))
    if t <= 0:
        return None
    return 100.0 * run.bound_per_call() * run.trace.calls / t
