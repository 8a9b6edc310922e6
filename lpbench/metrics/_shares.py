"""Shared arithmetic of the roofline and idle shares (not a metric)."""


def roofline_share(rec):
    """100 x the needed bytes' time at the card's HBM peak over the window."""
    if rec.hbm_bytes_per_s is None or not rec.roof_bytes or rec.window.seconds <= 0:
        return None
    return 100.0 * rec.roof_bytes / rec.hbm_bytes_per_s / rec.window.seconds


def idle_share(rec):
    """100 x the share of the traced window in which no device op ran."""
    if rec.trace is None or rec.trace.busy_s <= 0 or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
