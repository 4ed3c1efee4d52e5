"""epoch_gap_ms.<cells> (training loop and scan epochs): the mean over the
window's epochs (the program's train_epoch_scan spans) of the time from an
epoch's start to the end of its first train_epoch_step: the permutation's
draw and copy and the first replay's launch, the boundary between epochs,
in ms."""

from benchlib import spans


def read(run: dict):
    return spans.first_child_end_ms(spans.recorded(), "train_epoch_scan", "train_epoch_step")
