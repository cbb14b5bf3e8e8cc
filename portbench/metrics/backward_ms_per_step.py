"""Device ms a step of the program's ``backward`` phase (autograd through the
loss: the kernel's backward launch and the assembly's backward): the time
from its mark to the next inside the captured step, the mean over the phase
chunk of the program's tracing stage (``phases.py``)."""

from ..phases import phase_ms_per_step


def read(ctx):
    return phase_ms_per_step(ctx, "backward")
