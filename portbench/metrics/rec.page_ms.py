"""The recognizer's call per page (``OCR.recognizer``, wall ms, mean over
the window's calls): the line maps, the crops, the encoder, the AR loop,
the refine and the tokenizer."""


def read(r):
    calls = r.spans.get("rec", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
