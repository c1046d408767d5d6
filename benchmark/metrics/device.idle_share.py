"""device.idle_share: 1 - (union of the device operations' intervals) /
the traced window, in %.  Layer: the device."""


def read(view, run):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
