"""Host seconds of the compiled frame's set-up: the eager warm-up
iteration (pt_frame.warm, which builds or loads the kernel library) and
the capture of the graph (pt_frame.capture), each the median of its
untraced spans."""
from benchmark.spans import host_s


def read(out, cell):
    warm, capture = host_s(out, "pt_frame.warm"), host_s(out,
                                                          "pt_frame.capture")
    return None if warm is None or capture is None else warm + capture
