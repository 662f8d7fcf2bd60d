"""setup_s: from the start of the process to the first timed frame."""


def read(rec):
    return rec["setup_s"]
