"""serve_output_ms (serving): the mean of the program's serve_output spans
(the numpy view of the fetched output and the crop), one a request, in
ms."""

from benchlib import spans


def read(run: dict):
    return spans.mean_ms(spans.recorded(), "serve_output")
