"""Detections returned per image in the window: how many masks the host
pastes."""


def read(run):
    units = run.window.get("units")
    return run.window["detections"] / units if units else None
