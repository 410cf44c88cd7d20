"""Host ms inside a pair's ``match_features`` and ``download_matches``
calls, mean over the window's pairs: the instance's match path on the
host, without the count's wait for the device (``pairs.sync_ms``)."""

CALLS = ("match_features", "download_matches")


def read(run):
    return run.spans.mean_ms(lambda n: n in CALLS)
