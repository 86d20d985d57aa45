"""setup_s: from the harness's start to the end of the warm-up chunk
(data, FASTA, reference state, the kernel's build on a first run)."""


def read(run):
    return run.setup_s
