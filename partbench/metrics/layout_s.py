"""layout_s: host seconds of the port's `prepare_device_graph` in set-up."""


def read(run):
    return run.setup["layout_s"]
