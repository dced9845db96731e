"""Engine dispatches (sample and window calls, the campaign's
``meta["dispatch"]["n_dispatches"]``) per record measured in the window."""


def read(run):
    return run["dispatches"] / run["records"] if run["records"] else None
