"""device_idle.train: the share of the traced window in which no operation
ran on the device, in %, in the trainer cells. Moves train_tokens_per_s."""


def read(run):
    if run.trace is None or run.kind != "train" or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
