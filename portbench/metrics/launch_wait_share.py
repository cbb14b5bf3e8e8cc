"""% of a profiled chunk's device time, from its first op to its end, spent
idle waiting for the host to launch the next op (``phases.attribute``), in
the chunk of the program's tracing stage, its spans on."""

from ..phases import launch_wait_share


def read(ctx):
    return launch_wait_share(ctx)
