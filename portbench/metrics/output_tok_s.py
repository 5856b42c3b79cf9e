"""Generated tokens of the window ÷ the window's seconds."""


def read(rec):
    return sum(r["tokens"] for r in rec.requests) / rec.window_s
