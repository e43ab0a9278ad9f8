"""The device's idle share of the traced slice's light pass, in %: 100 x
(1 - busy / wall), busy the union of its kernels, copies and sets. Shared
by every `device_idle.<cell kind>` metric."""


def read(m):
    if m.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.slice.busy_s / m.slice.window_s)
