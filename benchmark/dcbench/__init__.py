"""The harness of the captioning port's benchmark (``benchmark/run.py``)."""
