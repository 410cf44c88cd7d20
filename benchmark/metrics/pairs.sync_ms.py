"""Host ms inside a pair's ``get_matches_number`` call, mean over the
window's pairs: the count's sync, which waits for the device work queued
before it (the pair's detects, where the cell has them, and its match)."""


def read(run):
    return run.spans.mean_ms(lambda n: n == "get_matches_number")
