"""The peak of the device memory allocated over set-up and window
(``torch.cuda.max_memory_allocated()``, read by the benchmark itself), in
GiB.  The harness keeps no state on the device beyond the operation's
input: the sample of answers goes to the host, and the points inputs are
drawn at stay there."""


def read(run):
    return run.peak_bytes / 2**30
