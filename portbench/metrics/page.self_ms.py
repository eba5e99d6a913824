"""The page's own host time (ms per completed page): the program's
``page/call`` span (``OCR.__call__``) less its ``det/call`` and
``rec/call`` spans, which leaves the page's upload, the aggregation into
words and the calls between."""


def read(r):
    s = r.stages
    page = s.get(("page", "call"))
    if not r.pages or not page:
        return None
    return 1e3 * (page - s.get(("det", "call"), 0.0) - s.get(("rec", "call"), 0.0)) / r.pages
