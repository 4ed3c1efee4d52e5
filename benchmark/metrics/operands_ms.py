"""operands_ms (model and fused loops): the mean of the program's
lista3d_operands spans, the host's launching of the input's phase split and
the call's bank transforms before the fused loop, in ms."""

from benchlib import spans


def read(run: dict):
    return spans.mean_ms(spans.recorded(), "lista3d_operands")
