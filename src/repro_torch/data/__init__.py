"""The synthetic data pipeline (a copy of the JAX package's ``data/pipeline.py``) and a stub
frontend's seeded stand-in embeddings (``frontend.py``)."""
