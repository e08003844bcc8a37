"""setup_s: from the launch of the job to the first timed step (the
host's monotonic clock, which the harness and the ranks share): process
start, CUDA contexts, the store, the inputs, the arenas, a first build
of the kernels where the checkout has none, and the first steps."""


def read(run):
    return run.lead["window_start_mono"] - run.launch_mono
