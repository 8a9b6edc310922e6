"""Engine: the share of bucket edge slots that padding filled, over the
window's occupied lanes (the engine's ``real_edges_used`` and
``edge_slots_used`` counters, which ``LPEngine.stats()`` reports rounded)."""


def read(rec):
    if rec.mode != "engine" or not rec.window.edge_slots or not rec.window.edge_slots[1]:
        return None
    real, slots = rec.window.edge_slots
    return 100.0 * (1.0 - real / slots)
