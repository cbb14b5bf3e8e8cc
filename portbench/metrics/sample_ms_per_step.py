"""Device ms a step of the program's ``sample`` phase (the draw of the step's
batch: the Monte-Carlo trainer's ``sample_vbatch``, the residual trainer's
resample graph): the time from its mark to the next inside the captured
step, the mean over the phase chunk of the program's tracing stage
(``phases.py``)."""

from ..phases import phase_ms_per_step


def read(ctx):
    return phase_ms_per_step(ctx, "sample")
