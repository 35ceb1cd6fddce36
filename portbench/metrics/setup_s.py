"""Set-up: from process start to the first timed submission, s."""


def read(run):
    return run.setup_s
