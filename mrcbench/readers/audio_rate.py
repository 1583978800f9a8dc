"""Seconds of audio in every request completed in the window, over the
window's wall time (from the first request's call to the last one's
return)."""


def read(metric, run):
    if not run.completed or run.window_s <= 0:
        return None
    return run.completed * run.audio_s_per_request / run.window_s
