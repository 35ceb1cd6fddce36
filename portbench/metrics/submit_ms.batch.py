"""Host time a batch spends inside ``register_pairs_async`` (packing,
pinned upload, dispatch) until it returns, mean over the window, ms."""

from portbench import readers


def read(run):
    return readers.span_mean_ms(run, "submit")
