"""The AR loops' ``parseq/done_wait`` spans (ms per completed page): the
host waiting on each step's ``done`` flag, read back to end the loop
early."""


def read(r):
    span = r.stages.get(("parseq", "done_wait"))
    return 1e3 * span / r.pages if r.pages and span else None
