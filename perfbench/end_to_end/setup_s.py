"""setup_s: the process's start to the first timed analysis: the imports,
the chains made on the device, the program's objects built and warmed (on
a checkout's first run, the kernels' builds too)."""


def read(run):
    return run["setup_s"]
