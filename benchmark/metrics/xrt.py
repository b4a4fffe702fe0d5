"""xrt: true audio seconds of the requests completed in the window over
the window's seconds (padding is not audio)."""


def read(run):
    return run.record.audio_s() / run.record.window_s()
