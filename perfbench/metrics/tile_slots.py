"""Forward slots a subject, padding included: the registrar's counter
``Registrar.tile_counts["slots"]`` over the calls that ``drivers/tiles.py``
made, as its ``trace_info`` gives it (the tiling; moves the tile cell's
rate). None for a program without the counter."""


def read(trace):
    slots = trace.info.get("slots")
    return None if slots is None or not trace.units else float(slots)
