"""loop_issue_ms (model and fused loops): the mean of the program's
lista3d_loop spans, the host's time to queue the fused loop's 2K kernel
launches (60 a clip at K=30), in ms."""

from benchlib import spans


def read(run: dict):
    return spans.mean_ms(spans.recorded(), "lista3d_loop")
