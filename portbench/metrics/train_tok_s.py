"""Tokens (frames) of every training step of the window ÷ its seconds."""


def read(rec):
    return sum(u["tokens"] for u in rec.units) / rec.window_s
