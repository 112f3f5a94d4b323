"""The synthetic data pipeline (a copy of the JAX package's ``data/pipeline.py``)."""
