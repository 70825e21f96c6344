"""The closed loop: operation i + 1 is due when operation i has returned
and its input has been drawn.  The traced operations' inputs are drawn
before the trace opens, so the traced stretch holds the operations
alone."""

import time


def run(window, program, draws, sync) -> None:
    ready = {}
    window.start()
    i = 0
    while window.open(i):
        if window.traced and i == window.traced.start:
            ready = {k: draws.input(k) for k in window.traced}
            sync()
            window.begin_trace()
        x = ready.pop(i) if i in ready else draws.input(i)
        sync()
        t = time.perf_counter()
        with window.op():
            outcome = program.run(x)
            sync()
        window.record(i, outcome, time.perf_counter() - t)
        del outcome, x
        if window.traced and i == window.traced[-1]:
            window.end_trace()
        i += 1
