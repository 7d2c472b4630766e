"""Plain references, one file per configuration (``<config>.py``)."""
