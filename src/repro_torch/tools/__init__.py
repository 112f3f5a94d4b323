"""Twins of the JAX package's ``tools/`` for the scheduling path, through the
port's copies, run as modules:

  PYTHONPATH=src python -m repro_torch.tools.chaos_replay --smoke
  PYTHONPATH=src python -m repro_torch.tools.replay_report

They take the reference's flags and print what the reference's print. Like
the reference's, they write a file only where a flag names one; the
examples here name paths under the checkout's ``build/tools/`` (the
reference's CI writes its reports to ``benchmarks/artifacts/``, which the
twins never touch). ``tools/check_docs_links.py`` has no twin: it checks
``docs/``, which describes the JAX package. Importing a tool runs nothing.
"""
