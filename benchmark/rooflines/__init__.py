"""Kernel bounds, one file per kernel: ``KERNEL`` (the port's wrapper
name, as the trace's class rules give it) and ``bound_s(launch,
request, config)``, the least seconds one launch could take on the card
(``launch``: the launch's integer arguments and its small tensor
arguments, recorded on the eager pass)."""
