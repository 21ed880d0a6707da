"""Process start to the start of the window: loading, drawing the weights, building and warming up."""


def read(run):
    return run.setup_s
