"""serve_input_ms (serving): the mean of the program's serve_input spans
(the bucket pad, the contiguous copy and the copy to the device), one a
request, in ms."""

from benchlib import spans


def read(run: dict):
    return spans.mean_ms(spans.recorded(), "serve_input")
