"""xrt.facade: xrt (true audio seconds of the requests completed in the
window over the window's seconds) of a cell that calls the eager facade,
whose pace the host's speed sets."""


def read(run):
    return run.record.audio_s() / run.record.window_s()
