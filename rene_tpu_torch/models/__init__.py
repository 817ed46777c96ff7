"""The AOV-guided denoisers (models/denoise.py) and the reader of their
weight files (models/msgpack.py)."""
