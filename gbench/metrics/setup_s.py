"""setup_s: process start to the end of the warm-up query (imports, CUDA
start, the kernel library, the program's host build and upload, one
query), less the benchmark's own generator work."""


def read(run):
    return run.spans["setup_s"]
