"""The rows of well-formed replies whose last byte came in the window, over the window, by the clients' clock."""


def read(r):
    return r.rows_per_s or None
