"""Per-layer metric readers, one file each, found by the metric's name:
for ``<kernel>_roofline`` the generic ``roofline.py`` with the kernel's
``rooflines/<kernel>.py``; otherwise ``metrics/<prefix>.py`` for
``<prefix>.<part>`` (or ``metrics/<name>.py``).  A reader is
``read(ctx, part) -> float | None`` (``part``: the rest of the name, or
None); it returns None where it finds nothing to read, and the harness
then leaves the metric out of the line."""
