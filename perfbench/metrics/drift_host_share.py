"""Share of the window's wall growing walking clocks' drift paths on the
host and sending their nodes to the device (host spans around
``grow_paths_for_deadlines``, ``grow_paths_for_reads`` and
``_DevicePaths.upload``, inside the engine's windows). Nothing to read on
affine clocks."""


def read(run):
    s = run["span_s"].get("drift")
    return 100.0 * s / run["wall_s"] if s else None
