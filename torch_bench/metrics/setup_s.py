"""Seconds from the process's start to the window's: the kernel library,
the cell's frames made on the card, the warm segment."""


def read(rec):
    return rec.setup_s
