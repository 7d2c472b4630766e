"""Device time, in ms, of the host-to-device copies of one batch (the
uint8 slices' upload), over the traced batches."""


def read(run):
    if run.device is None or not run.traced:
        return None
    secs = sum(sum(d) for name, d in run.device.copies.items() if "HtoD" in name)
    return 1e3 * secs / len(run.traced) if secs > 0 else None
