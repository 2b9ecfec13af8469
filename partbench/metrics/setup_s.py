"""setup_s: seconds from the process's start to the first timed job: the
CUDA context, the graph made on the card and copied to the host, the
port's layout, and the warm-up job (which loads or builds the kernels)."""


def read(run):
    return run.setup["setup_s"]
