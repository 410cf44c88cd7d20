"""Host ms from the return of ``get_features_number`` to the return of
``download_features``, mean over the window's frames."""


def read(run):
    return run.spans.mean_ms(lambda n: n == "download_features")
