"""Original over stored bytes of the port's compression of the cell's
fields, by the paper's accounting (``accounting.py``)."""


def read(m):
    return m["ratio"]
