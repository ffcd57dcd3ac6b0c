"""Extras of ``Pipe``: the skip subsystem (``skip/``) and deferred batch
norm (``norm.py``)."""
