"""Device ms a step of the program's ``forward`` phase (the loss: the heads,
the kernel's forward launch and the objective's assembly): the time from its
mark to the next inside the captured step, the mean over the phase chunk of
the program's tracing stage (``phases.py``)."""

from ..phases import phase_ms_per_step


def read(ctx):
    return phase_ms_per_step(ctx, "forward")
