"""The AR loops' ``parseq/ar`` spans (ms per completed page): the model's
lock held, from the buffers' reset through every step to the clones
returned."""


def read(r):
    span = r.stages.get(("parseq", "ar"))
    return 1e3 * span / r.pages if r.pages and span else None
