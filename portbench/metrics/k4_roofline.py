"""k4_roofline: the exact step's share of its roofline, in %.

The least time the traced jobs' steps need (work.exact_step_bound: the
model FLOPs of the expected pairs against f32's peak, or each block's
tokens, windows, negatives and its distinct tokens' rows in both tables
read and written once) over the device time of csrc/sgns_exact.cu's
kernels in the trace. Moves train_tokens_per_s."""

from portbench.trace import source_pattern


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    t = run.trace.seconds_of(source_pattern("sgns_exact.cu"))
    if t <= 0:
        return None
    return 100.0 * run.bound_per_call() * run.trace.calls / t
