"""One module a traffic shape, each with a `Driver` class (see `batch.py`)."""
