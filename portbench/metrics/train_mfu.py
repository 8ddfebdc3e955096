"""train_mfu: the trainer's model FLOPs a second over float32's peak, in %.

Skip-gram's model FLOPs (work.model_flops: 6 D (1 + k) for each expected
pair of the corpus) of the jobs that ran after the traced ones, over the
host clock's seconds of those jobs (the whole job: its tables, copies and
draws with the steps), against 67 TFLOP/s. The profiler slows a job's
host side, so the traced jobs are left out. The device's power limit is
in the line's `device`. Moves train_tokens_per_s."""

from portbench import peaks


def read(run):
    if run.kind != "train" or run.untraced_calls <= 0:
        return None
    flops = run.entry.work_per_call()["flops"] * run.untraced_calls
    return 100.0 * flops / run.untraced_s / peaks.F32_FLOPS
