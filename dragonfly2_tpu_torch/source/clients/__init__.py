"""Concrete origin clients: ``file`` and ``http(s)``."""
