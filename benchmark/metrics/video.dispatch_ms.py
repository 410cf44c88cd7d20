"""Host ms of the ``detect_features`` call (staging, upload, replay
launch), mean over the window's frames."""


def read(run):
    return run.spans.mean_ms(lambda n: n == "detect_features")
