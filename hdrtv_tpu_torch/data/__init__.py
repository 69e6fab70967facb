"""Data tooling of the port (``curate.py``: hard-frame mining, teacher pairs)."""
