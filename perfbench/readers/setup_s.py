"""Set-up seconds: process start to the first due arrival."""


def read(rec):
    return rec["setup_s"]
