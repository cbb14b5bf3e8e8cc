"""Device ms a step of the program's ``deflate`` phase (the deflated
quotient's sums after psi and H psi: the norms, the overlaps with the
references and the contamination, the E(R) head and the loss): the time
from its mark to the next inside the captured step, the mean over the phase
chunk of the program's tracing stage (``phases.py``). None where the step
has no such mark."""

from ..phases import phase_ms_per_step


def read(ctx):
    return phase_ms_per_step(ctx, "deflate")
