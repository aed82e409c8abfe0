"""One reader per per-layer quantity.  A metric named ``<base>.<cells>``
(``round_ms.offline``) is read by ``<name>.py`` where that file exists,
else by ``<base>.py``, so the cells of one quantity share a reader.
Each defines ``read(ctx)``, which returns the number, or None where the
run gave it nothing to read (the metric is then left out of the result
line).  ``ctx`` is :class:`specbench.run.Context`."""
