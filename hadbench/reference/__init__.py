"""The plain float32 reference that decides ``correct`` (``model.py``),
and the lower-precision control it is shown to fail with."""
