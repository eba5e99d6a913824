"""Seconds the PARSeq AR loop's lock was held, per completed page (ms):
the decode loops' time, a timed lock in place of the model's own."""


def read(r):
    return 1e3 * r.lock.held / r.pages if r.pages and r.lock.held else None
