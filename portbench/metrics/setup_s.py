"""Set-up seconds: process start to the start of the window (imports,
library load or build, weights, the cell's warm-up)."""


def read(rec):
    return rec.setup_s
