"""peak_mem_gib: the most device memory the process held at once
(``torch.cuda.max_memory_reserved``) over the run, set-up included, read
before the reference runs."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
