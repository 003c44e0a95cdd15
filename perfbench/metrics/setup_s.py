"""Set-up: from process start to the first timed request or epoch (host clock).

Loading, seeding the inputs and weights, building or loading the kernels,
and warming every shape the cell uses.
"""


def read(run):
    return run.setup_s
