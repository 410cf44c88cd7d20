"""Host ms inside a pair's ``detect_features`` calls, mean over the
window's pairs."""


def read(run):
    return run.spans.mean_ms(lambda n: n == "detect_features")
