"""Device ms a step of every kernel, copy and set not built from the
program's ``csrc/``: the objective's assembly, the sampler, the heads and
Adam."""

from . import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "torch")
